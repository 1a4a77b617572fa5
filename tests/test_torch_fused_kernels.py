"""The per-bounce fused gradient kernels' plain versions (``ops/grad.py``)
against the JAX package's kernels (``ops/pallas_grad.py``) in Pallas
interpret mode, as ``tests/test_pallas_grad.py`` runs them.

Both packages trace the SAME rays: the JAX package's camera rays, converted
(XLA's and PyTorch's camera rays differ by an ulp), with the same key and
(pixel, sample) ids, and scene tables from the JAX package through
``convert.py``.  The port's forward runs bounce by bounce; its backward is
``trace_rays_fused``'s autograd Function; the JAX side is
``_fused_fwd_rule`` / ``_fused_bwd_rule`` of its custom VJP.

Bounds, and why:

* a ray may diverge.  A later bounce's origin and direction carry rounding
  that differs between the packages (XLA contracts and orders the dot
  products otherwise), which a hit rebuilt from a cancelling discriminant
  amplifies: on a grazing hit of cover's r = 1000 ground sphere the next
  origin moves by up to ~0.07.  And a hit at a knife edge (a grazing
  winner; soft: a phantom winner facing the ray by the last bit of d . n)
  can flip.  A ray whose alive, winner or blocker index differs at any
  bounce, or whose entry origin or direction differs by more than 1e-3 of
  the plane's scale (``test_torch_grad_regen.py``'s bound), is a diverged
  ray; at most 1% of the rays may diverge, and the checks below hold on
  the others (their radiance cotangent is zeroed on both sides, so they
  add nothing to the sums);
* forward, on kept rays: alive, winner and blocker indices and the
  material equal; the winner's and blocker's attributes (read from the
  table by index in the port, stored per ray by the JAX kernel) equal;
  throughput equal (products of albedos and 1 / q); entry origins and
  directions equal at bounce 0 (the same input); radiance mean |d| <
  2e-6, max < 1e-3 (``test_pallas_grad_regen.py``);
* backward: the relative L2 error of each table leaf's cotangent, of the
  sky's and of the rays' (origin, direction) cotangents below 2e-3 (the
  JAX package's measure and bound for its fused kernels,
  ``test_pallas_grad.py``), and the rays' cotangents within rtol 2e-3,
  atol 2e-6 of the largest on all but 1% of the kept rays: the
  hand-written adjoint and ``jax.vjp`` round in another order, the sums
  add in another order, and a path through the hollow glass shells
  already differs by ~1e-5 in its later origins, so its cotangent may by
  a few tenths of a percent;
* raygen: ``raygen_reference`` against ``raygen_tiles`` at rtol and atol
  2e-6 (``test_pallas_grad.py:test_raygen_kernel_matches_generate_rays``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import simplepathtracer_tpu as spt
from simplepathtracer_tpu.camera import generate_rays as jax_generate_rays
from simplepathtracer_tpu.ops import pallas_grad as jg
from simplepathtracer_tpu.ops.sampling import camera_jitter as jax_camera_jitter
from simplepathtracer_tpu.ops.sampling import ray_keys as jax_ray_keys

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch.convert import convert_camera, convert_scene
from simplepathtracer_tpu_torch.ops import grad as fg
from simplepathtracer_tpu_torch.ops.grad_regen import _blocker, _winner, scene_inputs
from simplepathtracer_tpu_torch.ops.sampling import ray_keys

SEED = 7
MAX_DIVERGED = 0.01
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-6
# name: scene, width, height, spp, max_depth, rr_start_depth, softness
CASES = {
    "hard": ("trio", 32, 16, 2, 5, 0, 0.0),
    "hard-rr": ("trio", 32, 16, 2, 5, 2, 0.0),
    "soft": ("trio", 32, 16, 2, 5, 0, 0.05),
    "cover40": ("cover", 32, 16, 2, 4, 0, 0.0),
    "cover40-soft": ("cover", 32, 16, 2, 4, 0, 0.02),
}
# The fused trace's residuals per bounce (ops/pallas_grad.py:_fused_fwd_impl).
RESID = ("ox", "oy", "oz", "dx", "dy", "dz", "tr", "tg", "tb", "alive", "idx",
         "cx", "cy", "cz", "r", "ar", "ag", "ab", "fz", "io", "mat",
         "bidx", "bcx", "bcy", "bcz", "br")


def _scene(name):
    if name == "cover":
        scene = spt.cover_scene(jax.random.PRNGKey(0), max_spheres=40)
        return scene, spt.make_camera(origin=(13, 2, 3), lookat=(0, 0, 0), vfov_deg=20)
    return (spt.three_sphere_scene(hollow_glass=True),
            spt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60))


def _jax_tables(scene):
    return (
        scene.centers[:, 0], scene.centers[:, 1], scene.centers[:, 2], scene.radii,
        scene.radii * scene.radii, scene.albedo[:, 0], scene.albedo[:, 1],
        scene.albedo[:, 2], scene.material.astype(jnp.int32), scene.fuzz, scene.ior,
    )


def _flat(x, n):
    return np.asarray(x).reshape(-1)[:n]


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return build_case(request.param)


def build_case(name):
    """Both packages' forward and backward of the case ``name`` (the JAX
    kernels in interpret mode, the port's plain versions) on the same rays;
    the ``SIL_FRESNEL`` switches are read as they stand."""
    sname, w, h, spp, depth, rr, soft = CASES[name]
    scene, cam = _scene(sname)
    p = w * h
    pids = np.tile(np.arange(p, dtype=np.int32), spp)
    sids = np.repeat(np.arange(spp, dtype=np.int32), p)
    n = pids.shape[0]
    jkeys = jax_ray_keys(jax.random.PRNGKey(SEED), jnp.asarray(pids), jnp.asarray(sids))
    o, d = jax_generate_rays(cam, w, h, jnp.asarray(pids), jax_camera_jitter(jkeys))
    tiles = [jg._pack_cols(o[:, i], n) for i in range(3)] + [
        jg._pack_cols(d[:, i], n, 1.0 if i == 2 else 0.0) for i in range(3)]
    alive0 = jg._pack_cols(jnp.ones((n,), jnp.float32), n)
    pix, samp = jg._pack_cols(jkeys.pixel, n), jg._pack_cols(jkeys.sample, n)
    tables = _jax_tables(scene)
    sky6 = jnp.concatenate([scene.sky_lo, scene.sky_hi]).astype(jnp.float32)
    static = (depth, 1e-3, 3.0e7, rr, True, soft)
    rad3, resaux = jg._fused_fwd_rule(*tiles, alive0, pix, samp, jkeys.k0, jkeys.k1, tables,
                                      sky6, *static)
    j_res = {k: np.asarray(v).reshape(depth, -1)[:, :n]
             for k, v in zip(RESID, resaux[0][0])}
    j_rad = np.stack([_flat(r, n) for r in rad3], -1)

    # The port's forward, bounce by bounce, on the same rays.
    ts = convert_scene(scene, "cpu")
    inputs = scene_inputs(ts)
    keys = ray_keys(tpt.make_key(SEED), torch.as_tensor(pids), torch.as_tensor(sids))
    call = fg.fused_call(inputs[:11], inputs[11], keys.k0, keys.k1, max_depth=depth,
                         rr_start_depth=rr, softness=soft)
    origins, dirs = torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d))
    state = torch.cat([origins.T, dirs.T, torch.ones((4, n))])
    rad = torch.zeros((3, n))
    prev = torch.full((n,), -1, dtype=torch.int32) if soft else None
    pix_t, samp_t = keys.pixel.int(), keys.sample.int()
    t_res = []
    for b in range(depth):
        nxt, prev, idx, bidx = fg.grad_fwd_reference(call, state, rad, prev, pix_t, samp_t, b)
        t_res.append((state, idx, bidx))
        state = nxt
    diverged = np.zeros(n, bool)
    for b, (st, idx, bidx) in enumerate(t_res):
        alive = j_res["alive"][b] > 0
        diverged |= st[9].numpy() != j_res["alive"][b]
        diverged |= idx.numpy() != j_res["idx"][b]
        if soft:
            diverged |= bidx.numpy() != j_res["bidx"][b]
        for c, name in enumerate(RESID[:6]):
            want = j_res[name][b]
            scale = max(1.0, np.abs(want[alive]).max())
            diverged |= alive & (np.abs(st[c].numpy() - want) > 1e-3 * scale)
    keep = ~diverged

    # Backward on the kept rays: the diverged rays' radiance cotangent is 0.
    ct = np.random.default_rng(3).standard_normal((n, 3)).astype(np.float32) * keep[:, None]
    ct_tiles = tuple(jg._pack_cols(jnp.asarray(ct[:, c]), n) for c in range(3))
    j_bwd = jg._fused_bwd_rule(*static, resaux, ct_tiles)
    params = {k: v.clone().requires_grad_(True) for k, v in tpt.split_params(ts)[0].items()}
    scene_t = ts.replace(**params)
    og, dg = origins.clone().requires_grad_(True), dirs.clone().requires_grad_(True)
    cfg = tpt.RenderConfig(width=w, height=h, spp=spp, max_depth=depth, rr_start_depth=rr,
                           silhouette_softness=soft)
    out = fg.trace_rays_fused(og, dg, keys, scene_t, cfg)
    grads = torch.autograd.grad(out, [og, dg, *params.values()], torch.as_tensor(ct))
    return dict(name=name, n=n, soft=soft, depth=depth, call=call, keep=keep,
                j_res=j_res, j_rad=j_rad, t_res=t_res, rad=rad.T.numpy(), out=out.detach(),
                j_bwd=j_bwd, grads=grads, params=list(params), spp=spp,
                port_inputs=(origins, dirs, keys, ts, cfg, torch.as_tensor(ct)))


def port_grads(case):
    """The port's fused trace of ``case``'s rays again: (radiance, the
    gradients of the rays' origins and directions and of the scene's
    leaves), as ``build_case`` takes them."""
    origins, dirs, keys, ts, cfg, ct = case["port_inputs"]
    params = {k: v.clone().requires_grad_(True) for k, v in tpt.split_params(ts)[0].items()}
    og, dg = origins.clone().requires_grad_(True), dirs.clone().requires_grad_(True)
    out = fg.trace_rays_fused(og, dg, keys, ts.replace(**params), cfg)
    return out.detach(), torch.autograd.grad(out, [og, dg, *params.values()], ct)


def test_fused_forward_matches_jax(case):
    check_forward(case)


def check_forward(case):
    keep, j, n = case["keep"], case["j_res"], case["n"]
    assert (~keep).mean() <= MAX_DIVERGED, np.nonzero(~keep)
    call = case["call"]
    for b, (st, idx, bidx) in enumerate(case["t_res"]):
        alive = j["alive"][b] > 0
        live = keep & alive
        a9, mat = _winner(call, idx.long())
        win = live & (j["idx"][b] >= 0)
        np.testing.assert_array_equal(mat.numpy()[win], j["mat"][b][win])
        for k, name in enumerate(("cx", "cy", "cz", "r", "ar", "ag", "ab", "fz", "io")):
            np.testing.assert_array_equal(a9[k].numpy()[win], j[name][b][win], err_msg=name)
        if case["soft"]:
            blk = live & (j["bidx"][b] >= 0)
            for k, name in enumerate(("bcx", "bcy", "bcz", "br")):
                got = _blocker(call, bidx.long())[k].numpy()
                np.testing.assert_array_equal(got[blk], j[name][b][blk], err_msg=name)
        for c, name in enumerate(RESID[:9]):
            if name in ("tr", "tg", "tb") or b == 0:
                np.testing.assert_array_equal(st[c].numpy()[live], j[name][b][live],
                                              err_msg=f"{name} bounce {b}")
    d = np.abs(case["rad"][keep] - case["j_rad"][keep])
    assert d.mean() < 2e-6 and d.max() < 1e-3, (d.mean(), d.max())
    assert torch.equal(case["out"], torch.as_tensor(case["rad"]))
    assert case["rad"].max() > 0


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12))


def test_fused_backward_matches_jax(case):
    check_backward(case)


def check_backward(case):
    n, keep = case["n"], case["keep"]
    j = case["j_bwd"]
    g_o, g_d, *g_leaves = (g.numpy() for g in case["grads"])
    for name, got, k in (("origin", g_o, 0), ("direction", g_d, 3)):
        got = got[keep]
        want = np.stack([_flat(j[k + c], n) for c in range(3)], -1)[keep]
        assert _rel_l2(got, want) < GRAD_RTOL, (name, _rel_l2(got, want))
        off = np.abs(got - want) > GRAD_RTOL * np.abs(want) + GRAD_ATOL * np.abs(want).max()
        assert off.any(axis=1).mean() <= MAX_DIVERGED, (name, np.nonzero(off.any(axis=1)))
    jt, d_sky6 = j[11], np.asarray(j[12])
    want = {
        "centers": np.stack([np.asarray(jt[i]) for i in range(3)], -1),
        "radii": np.asarray(jt[3]),
        "albedo": np.stack([np.asarray(jt[i]) for i in (5, 6, 7)], -1),
        "fuzz": np.asarray(jt[9]), "ior": np.asarray(jt[10]),
        "sky_lo": d_sky6[:3], "sky_hi": d_sky6[3:],
    }
    assert set(case["params"]) == set(want)
    for name, g in zip(case["params"], g_leaves):
        assert _rel_l2(g, want[name]) < GRAD_RTOL, (name, _rel_l2(g, want[name]))
    assert np.abs(g_o).max() > 0 and np.abs(want["centers"]).max() > 0
    if case["soft"]:
        # The blocker's cotangents reach the tables: rays with a blocker.
        assert any((bidx >= 0).any() for _, _, bidx in case["t_res"])


def test_raygen_reference_matches_jax_raygen():
    from simplepathtracer_tpu.ops.pallas_grad import raygen_tiles

    jcam = spt.make_camera(origin=(13, 2, 3), lookat=(0, 0, 0), vfov_deg=20, aperture=0.1,
                           focus_dist=10.0)
    jcfg = spt.RenderConfig(width=40, height=30, spp=2, pallas_interpret=True)
    n = jcfg.num_pixels * 2
    pids = np.tile(np.arange(jcfg.num_pixels, dtype=np.int32), 2)
    sids = np.repeat(np.arange(2, dtype=np.int32), jcfg.num_pixels)
    jkeys = jax_ray_keys(jax.random.PRNGKey(9), jnp.asarray(pids), jnp.asarray(sids))
    want = np.stack([_flat(t, n) for t in raygen_tiles(jcam, jkeys, jcfg)])
    keys = ray_keys(tpt.make_key(9), torch.as_tensor(pids), torch.as_tensor(sids))
    cfg = tpt.RenderConfig(width=40, height=30, spp=2)
    calls = fg.raygen_reference.calls
    got = fg.raygen(convert_camera(jcam, "cpu"), keys, cfg)
    assert fg.raygen_reference.calls == calls + 1
    assert got.shape == (6, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)
