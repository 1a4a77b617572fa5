"""Render snapshots and fit snapshots of the port on the CPU: the round trip
and a resumed render bit-identical to an uninterrupted one
(``tests/test_checkpoint.py``'s shapes), the atomic overwrite, snapshots
moving between the port and the JAX package both ways, a resumed fit
bit-identical to an uninterrupted one (``tests/test_inverse.py``'s fit
snapshot setup), and the fit snapshots the port refuses."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import simplepathtracer_tpu as spt
import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu import checkpoint as jckpt
from simplepathtracer_tpu import inverse as jinv
from simplepathtracer_tpu_torch import checkpoint, inverse


def _trio():
    scene = tpt.three_sphere_scene(device="cpu")
    cam = tpt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), device="cpu")
    cfg = tpt.RenderConfig(width=32, height=16, spp=8, max_depth=4)
    return scene, cam, cfg


def test_roundtrip_and_bit_identical_resume(tmp_path):
    scene, cam, cfg = _trio()
    key = tpt.make_key(3)
    s_full = tpt.accumulate(tpt.init_state(cfg, key, device="cpu"), scene, cam, cfg, 3)
    s_full = tpt.accumulate(s_full, scene, cam, cfg, 5)

    s_half = tpt.accumulate(tpt.init_state(cfg, key, device="cpu"), scene, cam, cfg, 3)
    p = str(tmp_path / "snap.npz")
    assert checkpoint.save(p, s_half, scene, cfg, cam) == p
    s_l, scene_l, cfg_l, cam_l = checkpoint.load(p, device="cpu")
    assert cfg_l == cfg and s_l.sample_count == 3
    assert torch.equal(s_l.next_key, key) and torch.equal(s_l.accum, s_half.accum)
    for f in dataclasses.fields(scene):
        if f.name != "plane":
            assert torch.equal(getattr(scene_l, f.name), getattr(scene, f.name)), f.name
    assert scene_l.material.dtype == torch.int32 and scene_l.plane is None
    for f in dataclasses.fields(cam):
        assert torch.equal(getattr(cam_l, f.name), getattr(cam, f.name))

    s_resumed = tpt.accumulate(s_l, scene_l, cam_l, cfg_l, 5)
    assert torch.equal(s_resumed.accum, s_full.accum) and s_resumed.sample_count == 8
    # Against one 8-spp chunk: the same samples, summed in another order.
    s_once = tpt.accumulate(tpt.init_state(cfg, key, device="cpu"), scene, cam, cfg, 8)
    torch.testing.assert_close(s_resumed.accum, s_once.accum, rtol=1e-5, atol=1e-5)


def test_atomic_overwrite(tmp_path):
    scene = tpt.with_ground_plane(tpt.simple_scene(device="cpu"))
    cam = tpt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), device="cpu")
    cfg = tpt.RenderConfig(width=8, height=8, spp=2, max_depth=2)
    s = tpt.accumulate(tpt.init_state(cfg, tpt.make_key(0), device="cpu"), scene, cam, cfg, 2)
    p = str(tmp_path / "snap.npz")
    checkpoint.save(p, s, scene, cfg)
    checkpoint.save(p, s, scene, cfg)  # overwriting in place must not corrupt it
    s2, scene2, _, cam2 = checkpoint.load(p, device="cpu")
    assert cam2 is None
    assert torch.equal(s.accum, s2.accum) and torch.equal(scene2.plane, scene.plane)
    assert sorted(q.name for q in tmp_path.iterdir()) == ["snap.npz"]


def _assert_same_config(port_cfg, jax_cfg):
    for f in dataclasses.fields(port_cfg):
        assert getattr(port_cfg, f.name) == getattr(jax_cfg, f.name), f.name


def test_jax_snapshot_loads_in_the_port(tmp_path):
    scene = spt.with_ground_plane(spt.three_sphere_scene())
    cam = spt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), aperture=0.1)
    cfg = spt.RenderConfig(width=16, height=8, spp=4, max_depth=3, rr_start_depth=2,
                           silhouette_softness=0.02)
    state = spt.accumulate(spt.init_state(cfg, jax.random.PRNGKey(7)), scene, cam, cfg, 2)
    p = str(tmp_path / "jax.npz")
    jckpt.save(p, state, scene, cfg, cam)

    s, scene_l, cfg_l, cam_l = checkpoint.load(p, device="cpu")
    _assert_same_config(cfg_l, cfg)
    assert s.sample_count == 2
    np.testing.assert_array_equal(s.accum.numpy(), np.asarray(state.accum))
    np.testing.assert_array_equal(s.next_key.numpy(), np.asarray(state.next_key))
    assert torch.equal(s.next_key, tpt.make_key(7))
    for name in ("centers", "radii", "albedo", "material", "fuzz", "ior", "sky_lo", "sky_hi",
                 "plane"):
        np.testing.assert_array_equal(getattr(scene_l, name).numpy(),
                                      np.asarray(getattr(scene, name)))
    for name in ("origin", "lookat", "vup", "vfov_deg", "aperture", "focus_dist"):
        np.testing.assert_array_equal(getattr(cam_l, name).numpy(), np.asarray(getattr(cam, name)))


def test_port_snapshot_loads_in_jax(tmp_path):
    scene, cam, cfg = _trio()
    cfg = cfg.replace(rr_start_depth=2, spp_chunk=2)
    state = tpt.accumulate(tpt.init_state(cfg, tpt.make_key(11), device="cpu"), scene, cam, cfg, 2)
    p = str(tmp_path / "port.npz")
    checkpoint.save(p, state, scene, cfg, cam)

    s, scene_l, cfg_l, cam_l = jckpt.load(p)
    _assert_same_config(cfg, cfg_l)
    assert cfg_l.pallas_interpret is False and int(s.sample_count) == 2
    np.testing.assert_array_equal(np.asarray(s.accum), state.accum.numpy())
    np.testing.assert_array_equal(np.asarray(s.next_key), np.asarray(jax.random.PRNGKey(11)))
    np.testing.assert_array_equal(np.asarray(scene_l.centers), scene.centers.numpy())
    np.testing.assert_array_equal(np.asarray(scene_l.material), scene.material.numpy())
    np.testing.assert_array_equal(np.asarray(cam_l.focus_dist), cam.focus_dist.numpy())


def _fit_setup():
    cam = tpt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60, device="cpu")
    cfg = tpt.RenderConfig(width=48, height=24, spp=8, max_depth=4)
    truth = tpt.three_sphere_scene(hollow_glass=False, device="cpu")
    target = tpt.render_linear(truth, cam, cfg, tpt.fold_in(tpt.make_key(0), 999))
    perturbed = truth.replace(albedo=torch.clamp(truth.albedo + 0.2, 0.0, 1.0))
    return perturbed, target, cam, cfg


def test_fit_snapshot_resume_bit_identical(tmp_path):
    """A fit interrupted after 3 steps and resumed to 6 equals the
    uninterrupted fit bit for bit: losses, leaves, and the Adam state the
    snapshot carried (the next steps' updates would show a lost bit)."""
    perturbed, target, cam, cfg = _fit_setup()
    kw = dict(lr=5e-2, leaves=("albedo", "sky_lo"), device="cpu")
    key = tpt.make_key(21)
    ref_scene, ref_losses = tpt.fit(perturbed, target, cam, cfg, key, steps=6, **kw)

    snap = str(tmp_path / "fit.npz")
    tpt.fit(perturbed, target, cam, cfg, key, steps=3, snapshot_path=snap, snapshot_every=3, **kw)
    with np.load(snap) as z:
        assert int(z["version"]) == 1 and int(z["step"]) == 3
        assert list(z["leaves"]) == ["albedo", "sky_lo"] and list(z["losses"]) == ref_losses[:3]
        assert z["adam.albedo.exp_avg"].shape == (4, 3) and "adam.sky_lo.step" in z.files
    scene, losses = tpt.fit(perturbed, target, cam, cfg, key, steps=6, snapshot_path=snap,
                            snapshot_every=3, **kw)
    assert losses == ref_losses
    assert torch.equal(scene.albedo, ref_scene.albedo)
    assert torch.equal(scene.sky_lo, ref_scene.sky_lo)


def test_fit_snapshot_keeps_adam_state_dtypes(tmp_path):
    """The round trip of a snapshot restores each Adam state tensor with the
    dtype it was saved with, and the leaves bit for bit."""
    perturbed, target, cam, cfg = _fit_setup()
    params, opt = inverse.init(perturbed, 0.05, ("albedo",))
    opt.zero_grad()
    inverse.pixel_loss(params, perturbed, target, cam, cfg.replace(spp=2), tpt.make_key(0),
                       device="cpu").backward()
    opt.step()
    snap = str(tmp_path / "fit.npz")
    inverse._save_fit_state(snap, params, opt, 1, [0.5])
    params2, opt2 = inverse.init(perturbed, 0.05, ("albedo",))
    assert inverse._load_fit_state(snap, params2, opt2) == (1, [0.5])
    assert torch.equal(params2["albedo"], params["albedo"])
    st, st2 = opt.state[params["albedo"]], opt2.state[params2["albedo"]]
    assert set(st) == set(st2)
    for k in st:
        assert st2[k].dtype == st[k].dtype and torch.equal(st2[k], st[k]), k


@pytest.mark.parametrize("kind", ["wrong_version", "jax_fit_snapshot", "other_leaves"])
def test_fit_snapshot_refused(kind, tmp_path):
    perturbed, target, cam, cfg = _fit_setup()
    snap = str(tmp_path / "fit.npz")
    if kind == "jax_fit_snapshot":
        params = {"albedo": jnp.zeros((4, 3))}
        jinv._save_fit_state(snap, params, jinv.make_optimizer(0.05).init(params), 3, [1.0])
        match = "JAX package"
    else:
        params, opt = inverse.init(perturbed, 0.05, ("albedo",))
        inverse._save_fit_state(snap, params, opt, 0, [])
        match = "leaves" if kind == "other_leaves" else "version 2"
        if kind == "wrong_version":
            with np.load(snap) as z:
                payload = dict(z)
            payload["version"] = np.int64(2)
            np.savez(snap, **payload)
    leaves = ("albedo", "sky_lo") if kind == "other_leaves" else ("albedo",)
    with pytest.raises(ValueError, match=match):
        tpt.fit(perturbed, target, cam, cfg, tpt.make_key(0), steps=1, leaves=leaves,
                snapshot_path=snap, snapshot_every=1, device="cpu")
