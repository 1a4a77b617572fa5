"""The regeneration gradient kernels' plain versions (``ops/grad_regen.py``,
``ops/bucket.py``) and ``fold_in`` against the JAX package.

The JAX kernels run as the JAX package's own tests run them on the CPU, in
Pallas interpret mode.  Scene tables come from the JAX package through
``convert.py``; at <= 1024 pixels both packages put every pixel in one bank
with lane = position, so the planes compare lane for lane.

Bounds, and why:

* radiance: ``tests/test_pallas_grad_regen.py:_assert_images_close`` on the
  sample mean (mean |d| < 2e-6, max < 1e-3);
* counts, the packed winner words, and every discrete plane (alive, regen,
  bank, sample, bounce, idx, material) and the winner's attributes: equal;
* entry ray planes (o, d) on alive entries: 1e-6 relative at bounce 0
  (the camera ray; XLA and PyTorch round an rsqrt an ulp apart), 1e-3
  relative past it (that ulp grows through each reflection's hit point and
  normal);
* throughput planes: equal (products of albedos and 1/q, no geometry);
* bucket: rtol 1e-6 against the TPU kernel, atol 1e-6 of the table's
  largest entry (each entry sums ~100 terms in another order, and the
  TPU kernel splits them into three bf16 parts: an entry that cancels to
  near zero keeps the absolute rounding of its terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from kernel_cases import PATTERNS, float64_bound, key_pattern

import simplepathtracer_tpu as spt
from simplepathtracer_tpu.ops import pallas_grad_regen as jr
from simplepathtracer_tpu.ops.pallas_bucket import bucket_cols_pallas, bucket_rows_pallas
from simplepathtracer_tpu.ops.pallas_common import banked_lane_layout
from simplepathtracer_tpu.render import _persistent_args
from simplepathtracer_tpu.scenes import with_ground_plane

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch.convert import convert_camera, convert_scene
from simplepathtracer_tpu_torch.ops import bucket, grad_regen as gr

SEED = 2


def test_fold_in_matches_jax():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**32, (24, 2), dtype=np.uint64).astype(np.uint32)
    datas = [0, 1, 2, 9, 1000, 2**31 - 1, 2**31, 2**32 - 1] + [
        int(x) for x in rng.integers(0, 2**32, 16, dtype=np.uint64)
    ]
    for k, data in zip(np.repeat(keys, 2, axis=0), datas + datas[::-1]):
        want = np.asarray(jax.random.fold_in(jnp.asarray(k), np.uint32(data)))
        got = tpt.fold_in(torch.tensor(k.astype(np.int64)), data)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    # The port's make_key(seed) is the JAX package's PRNGKey(seed).
    for seed in (0, 7):
        want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), 3))
        np.testing.assert_array_equal(
            tpt.fold_in(tpt.make_key(seed), 3).numpy().astype(np.uint32), want
        )


def _scene(plane):
    scene = spt.three_sphere_scene(hollow_glass=False)
    if plane:
        scene = with_ground_plane(scene)
        # Below the spheres' resting tangent, as the JAX package's tests
        # place it (exact tangency makes the contact circle a winner tie).
        scene = scene.replace(plane=jnp.asarray(scene.plane).at[3].set(0.6))
    return scene


CAM = dict(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=60)
# name, plane scene, max_depth, rr_start_depth
CASES = [("spheres", False, 4, 0), ("plane", True, 4, 0), ("spheres-rr", False, 6, 2)]


def _jax_forward(scene, cam, cfg, key, idx_only):
    """JAX ``_regen_fwd_impl`` in interpret mode: (radiance sums [P, 3],
    counts [n_lanes], 25 planes [B, n_lanes] or the packed words)."""
    pid = jnp.arange(cfg.num_pixels, dtype=jnp.int32)
    nb, nl, _, pix, xf, yf, unbank = banked_lane_layout(pid, cfg.width, jr.DEFAULT_BANKS)
    tables, sky6, cam19, kd = _persistent_args(scene, cam, cfg, key)
    meta2 = jnp.asarray(kd, jnp.uint32).reshape(2)
    use_plane = scene.plane is not None
    plane7 = jnp.asarray(scene.plane, jnp.float32) if use_plane else jnp.zeros(7, jnp.float32)
    sc = (nb, cfg.spp, cfg.max_depth, cfg.width, cfg.height, cfg.t_min, cfg.t_max,
          cfg.rr_start_depth, 0.0, use_plane)
    out4, res = jr._regen_fwd_impl(pix, xf, yf, jnp.uint32(0), meta2, cam19, tables, sky6,
                                   plane7, sc, True, emit_idx_only=idx_only)
    rad = np.stack([np.asarray(unbank(o)) for o in out4[:3]], -1)
    cnt = np.asarray(out4[3]).reshape(-1)[:nl]
    planes = [np.asarray(r).reshape(r.shape[0], -1)[:, :nl] for r in res[0]]
    return rad, cnt, planes


def _port_call(scene, cam, cfg):
    ts, tc = convert_scene(scene, "cpu"), convert_camera(cam, "cpu")
    inputs, cam19 = gr._trace_inputs(ts, tc, cfg)
    return gr.regen_call(
        inputs[:11], inputs[11], inputs[12], cam19, tpt.make_key(SEED),
        torch.arange(cfg.num_pixels), n_samples=cfg.spp, max_depth=cfg.max_depth,
        width=cfg.width, height=cfg.height, rr_start_depth=cfg.rr_start_depth,
    )


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def forward_case(request):
    _, plane, depth, rr = request.param
    scene = _scene(plane)
    cam = spt.make_camera(**CAM)
    cfg = spt.RenderConfig(width=16, height=8, spp=4, max_depth=depth, rr_start_depth=rr)
    key = jax.random.PRNGKey(SEED)
    jax_full = _jax_forward(scene, cam, cfg, key, idx_only=False)
    jax_idx = _jax_forward(scene, cam, cfg, key, idx_only=True)
    call = _port_call(scene, cam, tpt.RenderConfig(
        width=16, height=8, spp=4, max_depth=depth, rr_start_depth=rr))
    return cfg, jax_full, jax_idx, call


def test_regen_forward_matches_jax(forward_case):
    cfg, (j_rad, j_cnt, j_planes), _, call = forward_case
    rad, cnt, (resf, resi) = gr.regen_fwd_reference(call, 0, True)
    d = np.abs(rad.numpy() / cfg.spp - j_rad / cfg.spp)
    assert d.mean() < 2e-6 and d.max() < 1e-3, (d.mean(), d.max())
    np.testing.assert_array_equal(cnt.numpy(), j_cnt)

    planes = [p.numpy() for p in gr.residual_planes(resf, resi)]
    names = gr.RESIDUAL_PLANES
    assert len(planes) == len(j_planes) == 25
    assert planes[0].shape == j_planes[0].shape
    alive = j_planes[names.index("alive")] > 0
    np.testing.assert_array_equal(planes[names.index("alive")], j_planes[names.index("alive")])
    np.testing.assert_array_equal(planes[names.index("idx")], j_planes[names.index("idx")])
    first = alive & (j_planes[names.index("b")] == 0)
    for j, name in enumerate(names):
        got, want = planes[j][alive], j_planes[j][alive]
        if name in ("ox", "oy", "oz", "dx", "dy", "dz"):
            g0, w0 = planes[j][first], j_planes[j][first]
            np.testing.assert_allclose(g0, w0, rtol=1e-6, atol=1e-6, err_msg=name)
            scale = np.maximum(1.0, np.abs(want))
            assert (np.abs(got - want) <= 1e-3 * scale).all(), name
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_regen_forward_idx_words_match_jax(forward_case):
    _, (j_rad, _, _), (_, j_cnt, j_packed), call = forward_case
    rad_full, _, _ = gr.regen_fwd_reference(call, 0, True)
    rad, cnt, packed = gr.regen_fwd_reference(call, 0, False)
    assert packed.dtype == torch.int32 and packed.shape == (call.n_iter // gr.IDX_PACK, call.n_lanes)
    np.testing.assert_array_equal(packed.numpy(), j_packed[0])
    np.testing.assert_array_equal(cnt.numpy(), j_cnt)
    assert torch.equal(rad, rad_full)


@pytest.mark.parametrize("plane,rr", [(False, 0), (True, 2)], ids=["spheres", "plane-rr"])
def test_refwd_rebuilds_the_recorded_planes(plane, rr):
    """The scan-free re-forward from the packed words emits the recording
    forward's planes bit for bit on alive entries (alive and idx
    everywhere)."""
    scene = _scene(plane)
    cfg = tpt.RenderConfig(width=16, height=8, spp=4, max_depth=6, rr_start_depth=rr)
    call = _port_call(scene, spt.make_camera(**CAM), cfg)
    _, _, (resf, resi) = gr.regen_fwd_reference(call, 3, True)
    _, _, packed = gr.regen_fwd_reference(call, 3, False)
    rf, ri = gr.regen_refwd_reference(call, 3, packed)
    alive = resf[9] > 0
    assert torch.equal(rf[9], resf[9]) and torch.equal(ri[3], resi[3])
    assert torch.equal(rf[:, alive], resf[:, alive])
    assert torch.equal(ri[:, alive], resi[:, alive])
    if plane:
        assert (resi[3] == gr.PLANE_IDX).any()


def test_bucket_matches_jax_kernel():
    rng = np.random.default_rng(4)
    rows, s = 16, 20
    n = rows * 128
    idx = rng.integers(-1, s + 4, n).astype(np.int32)
    idx[::97] = gr.PLANE_IDX
    cols = rng.normal(size=(9, n)).astype(np.float32)
    cols[:, idx < 0] = 0.0
    want = np.asarray(bucket_cols_pallas(
        [jnp.asarray(c.reshape(rows, 128)) for c in cols],
        jnp.asarray(idx.reshape(rows, 128)), s, interpret=True,
    ))
    got = bucket.bucket_cols(torch.tensor(cols), torch.tensor(idx), s)
    assert got.shape == (s, 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("n_buckets", (1, 3, 488))
@pytest.mark.parametrize("pattern", PATTERNS)
def test_bucket_key_patterns_match_jax_kernel(pattern, n_buckets):
    """The plain version the kernel is held to on the card, against the
    TPU kernel (interpret mode) on the card tests' key patterns, with 9 and
    4 columns.  Both are held to the float64 sum of the rows that name a
    slot under chip_smoke.py's bound for the kernel (rtol 1e-5, atol 1e-7 of
    max |cotangent|, 8 float32 roundings of the entry's absolute row sum):
    each sums in its own order, the TPU kernel after a bf16x3 split.  The
    patterns are tests/kernel_cases.py's, at 4,096 rows."""
    rng = np.random.default_rng(PATTERNS.index(pattern) * 10 + n_buckets)
    for k in bucket.COLS:
        cols, idx = key_pattern(pattern, n_buckets, k, rng, 4096)
        n = idx.shape[0]
        if n % 1024 == 0:
            want = np.asarray(bucket_cols_pallas(
                [jnp.asarray(c.reshape(n // 128, 128)) for c in cols],
                jnp.asarray(idx.reshape(n // 128, 128)), n_buckets, interpret=True))
        else:
            want = np.asarray(bucket_rows_pallas(jnp.asarray(cols.T), jnp.asarray(idx),
                                                 n_buckets, interpret=True))
        got = bucket.bucket_cols_reference(torch.tensor(cols), torch.tensor(idx), n_buckets)
        assert got.shape == (n_buckets, k) and got.dtype == torch.float32
        ref, tol = (x.numpy() for x in float64_bound(torch.tensor(cols), torch.tensor(idx),
                                                     n_buckets))
        assert np.all(np.abs(got.numpy() - ref) <= tol)
        assert np.all(np.abs(want - ref) <= tol)
