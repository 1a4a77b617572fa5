"""The port's plain wavefront render, scenes and presets against the JAX
package's.

Renders compare the port's ``render(use_pallas=False)`` with the JAX jnp
path: the same (matmul-expanded) intersection formulation, the same scene
tables, key and global (pixel, sample) ids.  Bound: the JAX package's own
knife-edge bound (tests/test_pallas_bounce.py) — mean |d| < 1e-4 and fewer
than 0.5% of channels with |d| > 1e-4 on the gamma image.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import simplepathtracer_tpu as spt
import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu.presets import PRESETS as JPRESETS
from simplepathtracer_tpu_torch.convert import convert_camera, convert_scene


def _render_pair(jscene, cam_kw, seed=11, **cfg_kw):
    jcam = spt.make_camera(**cam_kw)
    a = np.asarray(spt.render(jscene, jcam, spt.RenderConfig(**cfg_kw), jax.random.PRNGKey(seed)))
    b = tpt.render(
        convert_scene(jscene, "cpu"), convert_camera(jcam, "cpu"),
        tpt.RenderConfig(**cfg_kw), tpt.make_key(seed),
    ).numpy()
    assert b.shape == a.shape and np.isfinite(b).all()
    return np.abs(a - b)


@pytest.mark.parametrize(
    "scene_name,cam_kw,rr",
    [
        ("three_sphere", dict(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60), 0),
        ("reference", dict(origin=(0, 1, -3), lookat=(0, 1, 0), vfov_deg=90), 0),
        ("three_sphere_plane", dict(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=90), 2),
    ],
)
def test_plain_render_matches_jax(scene_name, cam_kw, rr):
    if scene_name == "three_sphere_plane":
        jscene = spt.with_ground_plane(spt.three_sphere_scene())
    else:
        jscene = spt.SCENES[scene_name]()
    d = _render_pair(jscene, cam_kw, width=48, height=24, spp=8, max_depth=8, rr_start_depth=rr)
    assert d.mean() < 1e-4, f"mean diff {d.mean()}"
    assert (d > 1e-4).mean() < 5e-3, f"outlier fraction {(d > 1e-4).mean()}"


def _tables(scene):
    leaves = ["centers", "radii", "albedo", "material", "fuzz", "ior", "sky_lo", "sky_hi", "plane"]
    return {k: (None if getattr(scene, k) is None else np.asarray(
        getattr(scene, k).cpu() if isinstance(getattr(scene, k), torch.Tensor) else getattr(scene, k)))
        for k in leaves}


def _assert_same_tables(a, b):
    ta, tb = _tables(a), _tables(b)
    for k in ta:
        if ta[k] is None or tb[k] is None:
            assert ta[k] is None and tb[k] is None, k
        else:
            np.testing.assert_array_equal(tb[k], ta[k], err_msg=k)
            assert tb[k].dtype == ta[k].dtype, (k, tb[k].dtype, ta[k].dtype)


@pytest.mark.parametrize("name", ["simple", "three_sphere", "reference", "three_sphere_plane"])
def test_deterministic_scenes_equal(name):
    if name == "three_sphere_plane":
        js, ts = spt.with_ground_plane(spt.three_sphere_scene()), tpt.with_ground_plane(
            tpt.three_sphere_scene(device="cpu"))
    else:
        js, ts = spt.SCENES[name](), tpt.SCENES[name](device="cpu")
    _assert_same_tables(js, ts)


def test_compact_cover_scene_equal():
    raw = spt.cover_scene(jax.random.PRNGKey(0), 512)
    _assert_same_tables(spt.compact_scene(raw), tpt.compact_scene(convert_scene(raw, "cpu")))


def test_cover_scene_distribution():
    s = tpt.cover_scene(3, device="cpu")
    assert s.num_spheres == 512
    c, r, m = s.centers.numpy(), s.radii.numpy(), s.material.numpy()
    grid = slice(4, 4 + 484)
    live = r[grid] > 1e-3
    # 484 grid slots; none of the live ones within 0.9 of (4, 0.2, 0).
    assert np.linalg.norm(c[grid][live] - np.array([4, 0.2, 0]), axis=-1).min() > 0.9
    assert live.sum() >= 476
    assert (r[4 + 484:] < 1e-3).all()
    frac = [(m[grid][live] == k).mean() for k in range(3)]
    # Material mix 80 / 15 / 5 (binomial, n ~ 480: 4 sigma ~ 0.07, 0.065, 0.04).
    assert abs(frac[0] - 0.80) < 0.07 and abs(frac[1] - 0.15) < 0.065 and abs(frac[2] - 0.05) < 0.04
    compact = tpt.compact_scene(s)
    assert compact.num_spheres % 4 == 0 and compact.num_spheres >= live.sum() + 4


# The port's own presets: emissive scenes, which the JAX package cannot hold.
PORT_ONLY_PRESETS = {"smallpt"}


def test_presets_match():
    assert set(tpt.PRESETS) - PORT_ONLY_PRESETS == set(JPRESETS)
    assert PORT_ONLY_PRESETS <= set(tpt.PRESETS)
    for name, p in tpt.PRESETS.items():
        if name in PORT_ONLY_PRESETS:
            continue
        assert dataclasses.asdict(p.config) == {
            k: v for k, v in dataclasses.asdict(JPRESETS[name].config).items()
            if k != "pallas_interpret"
        }, name
        js, jc, _ = JPRESETS[name].build()
        ts, tc, _ = p.build(0, device="cpu")
        np.testing.assert_allclose(tc.origin.numpy(), np.asarray(jc.origin))
        np.testing.assert_allclose(float(tc.focus_dist), float(jc.focus_dist), rtol=1e-6)
        if name not in ("cover", "random", "cover_multihost"):
            _assert_same_tables(js, ts)


def test_save_image_roundtrip(tmp_path):
    from simplepathtracer_tpu import io as jio
    from simplepathtracer_tpu_torch import io as tio

    img = torch.from_numpy(np.random.default_rng(0).random((5, 7, 3), dtype=np.float32))
    tio.save_image(str(tmp_path / "a.bmp"), img)
    np.testing.assert_array_equal(jio.read_bmp(str(tmp_path / "a.bmp")), jio.to_u8(img.numpy()))
    assert tio.encode_png(img) == jio.encode_png(img.numpy())
