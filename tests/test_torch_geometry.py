"""The port's camera, intersection, plane and material functions against the
JAX package's, on the same numpy-made inputs, at atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import simplepathtracer_tpu as spt
from simplepathtracer_tpu import camera as jcam_mod
from simplepathtracer_tpu.ops import intersect as jint
from simplepathtracer_tpu.ops import materials as jmat
from simplepathtracer_tpu.ops import plane as jplane
from simplepathtracer_tpu.ops.pallas_persistent import camera_constants as j_cam19
from simplepathtracer_tpu_torch import camera as tcam_mod
from simplepathtracer_tpu_torch.convert import convert_camera, convert_scene
from simplepathtracer_tpu_torch.ops import intersect as tint
from simplepathtracer_tpu_torch.ops import materials as tmat
from simplepathtracer_tpu_torch.ops import plane as tplane
from simplepathtracer_tpu_torch.ops.persistent import camera_constants as t_cam19

ATOL = 1e-5
_CAM = dict(origin=(13, 2, 3), lookat=(0, 0, 0), vfov_deg=20, aperture=0.1, focus_dist=10.0)


def _rays(n, seed, origin_spread=0.0, center=(0.0, 0.0, -1.0)):
    rng = np.random.default_rng(seed)
    o = np.asarray(center, np.float32) + origin_spread * rng.standard_normal((n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_generate_rays_and_camera_constants():
    jc = spt.make_camera(**_CAM)
    tc = convert_camera(jc, "cpu")
    rng = np.random.default_rng(1)
    pix = rng.integers(0, 64 * 32, 700)
    jit4 = rng.random((700, 4), dtype=np.float32)
    jo, jd = jcam_mod.generate_rays(jc, 64, 32, jnp.asarray(pix), jnp.asarray(jit4))
    to, td = tcam_mod.generate_rays(tc, 64, 32, torch.from_numpy(pix), torch.from_numpy(jit4))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL)
    np.testing.assert_allclose(
        t_cam19(tc, 64, 32).numpy(), np.asarray(j_cam19(jc, 64, 32)), atol=ATOL
    )


@pytest.mark.parametrize("scene_name", ["three_sphere", "reference"])
def test_intersect_scene(scene_name):
    js = spt.SCENES[scene_name]()
    ts = convert_scene(js, "cpu")
    o, d = _rays(2000, 2, origin_spread=0.5, center=(0.0, 0.5, -2.0))
    jh = jint.intersect_scene(jnp.asarray(o), jnp.asarray(d), js)
    th = tint.intersect_scene(torch.from_numpy(o), torch.from_numpy(d), ts)
    # Winners may differ only where the ray grazes a sphere (|disc| ~ 0).
    oc = np.asarray(js.centers)[None] - o[:, None]
    tc = np.einsum("nsk,nk->ns", oc, d)
    disc = np.asarray(js.radii)[None] ** 2 - (np.sum(oc * oc, -1) - tc * tc)
    knife = np.any(np.abs(disc) < 1e-6 * np.maximum(1.0, np.asarray(js.radii)[None] ** 2), axis=-1)
    same = ~knife
    assert same.mean() > 0.99
    np.testing.assert_array_equal(th.hit.numpy()[same], np.asarray(jh.hit)[same])
    hit = same & np.asarray(jh.hit)
    np.testing.assert_array_equal(th.index.numpy()[hit], np.asarray(jh.index)[hit])
    # Object-sized spheres at atol 1e-5.  On the r=1000 ground sphere the
    # matmul-expanded |oc|^2 = |c|^2 - 2 o.c + |o|^2 holds ~1e6, whose f32
    # ulp (0.06) enters disc; the two packages sum it in another order, so
    # t there agrees only to ~0.06 / (2 sqrt(disc)): 1e-3 relative.
    small = hit & (np.abs(np.asarray(js.radii))[np.asarray(jh.index)] < 10.0)
    big = hit & ~small
    for got, want in ((th.t, jh.t), (th.point, jh.point)):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_allclose(got[small], want[small], rtol=1e-5, atol=ATOL)
        np.testing.assert_allclose(got[big], want[big], rtol=1e-3)
    np.testing.assert_allclose(th.normal.numpy()[small], np.asarray(jh.normal)[small], atol=ATOL)


def test_ray_plane_intersection():
    o, d = _rays(1000, 3, origin_spread=1.0, center=(0.0, 1.0, 0.0))
    normal, offset = np.array([0.1, 1.0, -0.2], np.float32), np.float32(0.5)
    jp = jplane.ray_plane_intersection(jnp.asarray(o), jnp.asarray(d), jnp.asarray(normal), offset)
    tp = tplane.ray_plane_intersection(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(normal), float(offset))
    np.testing.assert_array_equal(tp.hit.numpy(), np.asarray(jp.hit))
    h = np.asarray(jp.hit)
    np.testing.assert_allclose(tp.t.numpy()[h], np.asarray(jp.t)[h], rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(tp.point.numpy()[h], np.asarray(jp.point)[h], rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(tp.normal.numpy(), np.asarray(jp.normal), atol=ATOL)


def test_scatter_attrs_and_sky():
    n = 3000
    rng = np.random.default_rng(4)
    _, d = _rays(n, 5)
    _, nrm = _rays(n, 6)
    mat = rng.integers(0, 3, n).astype(np.int32)
    alb = rng.random((n, 3), dtype=np.float32)
    fz = rng.random(n, dtype=np.float32) * 0.5
    io = 1.2 + rng.random(n, dtype=np.float32)
    unif = rng.random((n, 8), dtype=np.float32)
    jd, ja, jsc = jmat.scatter_attrs(*(jnp.asarray(x) for x in (d, nrm, mat, alb, fz, io, unif)))
    td, ta, tsc = tmat.scatter_attrs(*(torch.from_numpy(x) for x in (d, nrm, mat, alb, fz, io, unif)))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL)
    # The Schlick coin is a knife edge: a ray whose coin sits within rounding
    # of the reflectance may take the other branch.
    close = np.isclose(td.numpy(), np.asarray(jd), atol=ATOL).all(-1)
    assert close.mean() > 0.999, close.mean()

    lo, hi = np.array([1, 1, 1], np.float32), np.array([0.5, 0.7, 1.0], np.float32)
    np.testing.assert_allclose(
        tmat.sky_color(torch.from_numpy(d), torch.from_numpy(lo), torch.from_numpy(hi)).numpy(),
        np.asarray(jmat.sky_color(jnp.asarray(d), lo, hi)), atol=ATOL,
    )


def test_hit_from_gathered():
    js = spt.three_sphere_scene()
    ts = convert_scene(js, "cpu")
    o, d = _rays(500, 7, origin_spread=0.2)
    idx = np.random.default_rng(8).integers(-1, js.num_spheres, 500).astype(np.int32)
    jh = jint._hit_from_index(jnp.asarray(o), jnp.asarray(d), jnp.asarray(idx), js, 1e-3, 3e7)
    th = tint._hit_from_index(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(idx).long(), ts, 1e-3, 3e7)
    np.testing.assert_array_equal(th.hit.numpy(), np.asarray(jh.hit))
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=1e-5, atol=ATOL)
