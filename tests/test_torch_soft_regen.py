"""The soft branches of the regeneration kernels' plain versions
(``ops/grad_regen.py``, ``ops/bucket.py``) against the JAX package's
kernels in Pallas interpret mode, and against each other.

Scene tables come from the JAX package through ``convert.py``; at <= 1024
pixels both packages put every pixel in one bank with lane = position, so
the planes compare lane for lane.  Cases: sphere-only, soft 0.05; ground
plane, soft 0.05, Russian roulette from bounce 2 (the crossing coin live).

Bounds, and why:

* a lane may diverge: its camera ray already differs by an ulp between the
  packages (XLA's and PyTorch's rsqrt, ``test_torch_grad_regen.py``), and
  a soft path has knife edges a hard one lacks -- a phantom winner (disc
  < 0, hit at the ray's closest approach) faces the ray or not by the last
  bit of d . n.  At most 2 of the 128 lanes may diverge; the checks below
  hold on the others;
* on those lanes: ``test_torch_grad_regen.py``'s bounds per plane --
  counts, every discrete plane (the blocker's index included) and the
  winner's and blocker's attributes equal, entry rays 1e-6 relative at
  bounce 0 and 1e-3 past it, throughput equal -- and the radiance of their
  pixels mean |d| < 2e-6, max < 1e-3;
* winner codes: the port writes ``PLANE_CROSS_IDX`` where the plane won
  the crossing coin against the sphere its blocker slot then holds, where
  the JAX package writes ``PLANE_IDX`` (and replays the coins in its
  backward); the two are compared with that code mapped;
* the 4-column blocker bucket: the JAX kernel's 9-column bucket of the
  same columns padded with zeros, rtol 1e-6, atol 1e-6 of the largest
  entry (``test_torch_grad_regen.py``);
* within the port: the re-forward rebuilds the recording forward's planes
  bit for bit; the streamed-idx route's loss equals the chunked route's
  bit for bit, gradients to 1e-5 (sums in another order); the
  checkpointed stream equals the stream bit for bit.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401
from test_torch_grad_regen import CAM, SEED, _scene

import simplepathtracer_tpu as spt
from simplepathtracer_tpu.ops import pallas_grad_regen as jr
from simplepathtracer_tpu.ops.pallas_bucket import bucket_cols_pallas
from simplepathtracer_tpu.ops.pallas_common import banked_lane_layout
from simplepathtracer_tpu.render import _persistent_args

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch.convert import convert_camera, convert_scene, params_to_numpy
from simplepathtracer_tpu_torch.ops import bucket, grad_regen as gr

routes = importlib.import_module("simplepathtracer_tpu_torch.routes")
SOFT = 0.05
# name, plane scene, max_depth, rr_start_depth
CASES = [("soft", False, 4, 0), ("soft-plane-rr", True, 4, 2)]
MAX_DIVERGED = 2


def _jax_forward(scene, cam, cfg, key, idx_only):
    """JAX ``_regen_fwd_impl`` (soft) in interpret mode: (radiance sums
    [P, 3], counts [n_lanes], 30 planes [B, n_lanes] or the 2 packed word
    planes)."""
    pid = jnp.arange(cfg.num_pixels, dtype=jnp.int32)
    nb, nl, _, pix, xf, yf, unbank = banked_lane_layout(pid, cfg.width, jr.DEFAULT_BANKS)
    tables, sky6, cam19, kd = _persistent_args(scene, cam, cfg, key)
    meta2 = jnp.asarray(kd, jnp.uint32).reshape(2)
    use_plane = scene.plane is not None
    plane7 = jnp.asarray(scene.plane, jnp.float32) if use_plane else jnp.zeros(7, jnp.float32)
    sc = (nb, cfg.spp, cfg.max_depth, cfg.width, cfg.height, cfg.t_min, cfg.t_max,
          cfg.rr_start_depth, SOFT, use_plane)
    out4, res = jr._regen_fwd_impl(pix, xf, yf, jnp.uint32(0), meta2, cam19, tables, sky6,
                                   plane7, sc, True, emit_idx_only=idx_only)
    rad = np.stack([np.asarray(unbank(o)) for o in out4[:3]], -1)
    cnt = np.asarray(out4[3]).reshape(-1)[:nl]
    planes = [np.asarray(r).reshape(r.shape[0], -1)[:, :nl] for r in res[0]]
    return rad, cnt, planes


def _tables(scene, cam, cfg):
    ts, tc = convert_scene(scene, "cpu"), convert_camera(cam, "cpu")
    inputs, cam19 = gr._trace_inputs(ts, tc, cfg)
    return (inputs[:11], inputs[11], inputs[12], cam19, tpt.make_key(SEED),
            torch.arange(cfg.num_pixels))


def _unpack(words, n_iter):
    """[n_iter, n_lanes] codes from packed words [n_iter / 3, n_lanes]."""
    w = words.astype(np.int64)
    out = np.stack([((w >> (gr.IDX_BITS * f)) & gr.IDX_MASK) - 1 for f in range(3)], axis=1)
    return out.reshape(n_iter, -1)


def _map_cross(idx):
    return np.where(idx == gr.PLANE_CROSS_IDX, gr.PLANE_IDX, idx)


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def soft_case(request):
    _, plane, depth, rr = request.param
    scene = _scene(plane)
    cam = spt.make_camera(**CAM)
    cfg = spt.RenderConfig(width=16, height=8, spp=4, max_depth=depth, rr_start_depth=rr,
                           silhouette_softness=SOFT)
    key = jax.random.PRNGKey(SEED)
    jax_full = _jax_forward(scene, cam, cfg, key, idx_only=False)
    jax_idx = _jax_forward(scene, cam, cfg, key, idx_only=True)
    t_cfg = tpt.RenderConfig(width=16, height=8, spp=4, max_depth=depth, rr_start_depth=rr,
                             silhouette_softness=SOFT)
    call = gr.regen_call(*_tables(scene, cam, t_cfg), n_samples=4, max_depth=depth,
                         width=16, height=8, rr_start_depth=rr, softness=SOFT)
    full = gr.regen_fwd_reference(call, 0, True)
    return cfg, jax_full, jax_idx, call, full


def _diverged(planes, j_planes, alive):
    """Per lane, the first iteration from which the two records differ in a
    discrete plane (n_iter where they never do)."""
    names = gr.SOFT_RESIDUAL_PLANES
    diff = np.zeros_like(alive)
    for name in ("alive", "regen", "kb", "s", "b", "idx", "mat", "bidx"):
        j = names.index(name)
        a, b = planes[j], j_planes[j]
        if name == "idx":
            a = _map_cross(a)
        if name == "alive":
            diff |= a != b
        else:
            diff |= alive & (a != b)
    n_iter = alive.shape[0]
    first = np.where(diff.any(axis=0), diff.argmax(axis=0), n_iter)
    return first


def test_soft_regen_forward_matches_jax(soft_case):
    cfg, (j_rad, j_cnt, j_planes), _, call, (rad, cnt, (resf, resi)) = soft_case
    planes = [p.numpy() for p in gr.residual_planes(resf, resi)]
    names = gr.SOFT_RESIDUAL_PLANES
    assert len(planes) == len(j_planes) == 30
    alive = j_planes[names.index("alive")] > 0
    first = _diverged(planes, j_planes, alive)
    n_iter = alive.shape[0]
    keep = first == n_iter
    assert (~keep).sum() <= MAX_DIVERGED, np.nonzero(~keep)
    np.testing.assert_array_equal(cnt.numpy()[keep], j_cnt[keep])
    d = np.abs(rad.numpy()[keep] - j_rad[keep]) / cfg.spp
    assert d.mean() < 2e-6 and d.max() < 1e-3, (d.mean(), d.max())

    live = alive & keep[None, :]
    first_b = live & (j_planes[names.index("b")] == 0)
    blk = live & (j_planes[names.index("bidx")] >= 0)
    assert blk.sum() > 100                     # blockers recorded
    for j, name in enumerate(names):
        got, want = planes[j], j_planes[j]
        if name == "idx":
            got = _map_cross(got)
        mask = blk if name in ("bcx", "bcy", "bcz", "br") else live
        got, want = got[mask], want[mask]
        if name in ("ox", "oy", "oz", "dx", "dy", "dz"):
            np.testing.assert_allclose(planes[j][first_b], j_planes[j][first_b],
                                       rtol=1e-6, atol=1e-6, err_msg=name)
            assert (np.abs(got - want) <= 1e-3 * np.maximum(1.0, np.abs(want))).all(), name
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    if call.use_plane:
        # The crossing coin decided some plane hits against in-band spheres.
        assert (planes[names.index("idx")][live] == gr.PLANE_CROSS_IDX).sum() > 5


def test_soft_regen_idx_words_match_jax(soft_case):
    _, (_, _, j_planes), (_, j_cnt, j_packed), call, (rad_full, _, _) = soft_case
    rad, cnt, packed = gr.regen_fwd_reference(call, 0, False)
    n_iter = call.n_iter
    assert packed.shape == (2, n_iter // gr.IDX_PACK, call.n_lanes)
    assert torch.equal(rad, rad_full)
    alive = j_planes[gr.SOFT_RESIDUAL_PLANES.index("alive")] > 0
    keep = _diverged([p.numpy() for p in gr.residual_planes(*soft_case[4][2])],
                     j_planes, alive) == n_iter
    live = alive & keep[None, :]
    for k in range(2):
        got = _unpack(packed[k].numpy(), n_iter)
        want = _unpack(j_packed[k], n_iter)
        np.testing.assert_array_equal(_map_cross(got)[live], want[live])
        assert (got[~alive] == -1).all()


@pytest.mark.parametrize("plane,rr", [(False, 0), (True, 2)], ids=["soft", "soft-plane-rr"])
def test_soft_refwd_rebuilds_the_recorded_planes(plane, rr):
    """The scan-free re-forward from the packed winner and blocker words
    emits the recording forward's 30 planes bit for bit on alive entries
    (alive, idx and bidx everywhere)."""
    scene = _scene(plane)
    cfg = tpt.RenderConfig(width=16, height=8, spp=4, max_depth=6, rr_start_depth=rr,
                           silhouette_softness=SOFT)
    call = gr.regen_call(*_tables(scene, spt.make_camera(**CAM), cfg), n_samples=4,
                         max_depth=6, width=16, height=8, rr_start_depth=rr, softness=SOFT)
    _, _, (resf, resi) = gr.regen_fwd_reference(call, 3, True)
    _, _, packed = gr.regen_fwd_reference(call, 3, False)
    rf, ri = gr.regen_refwd_reference(call, 3, packed)
    alive = resf[9] > 0
    assert resf.shape[0] == 24 and resi.shape[0] == 6
    assert torch.equal(rf[9], resf[9]) and torch.equal(ri[3], resi[3])
    assert torch.equal(ri[gr._I_BLK], resi[gr._I_BLK])
    assert torch.equal(rf[:, alive], resf[:, alive])
    assert torch.equal(ri[:, alive], resi[:, alive])


def test_blocker_bucket_matches_jax_kernel():
    rng = np.random.default_rng(5)
    rows, s = 16, 20
    n = rows * 128
    idx = rng.integers(-1, s + 4, n).astype(np.int32)
    cols = rng.normal(size=(4, n)).astype(np.float32)
    cols[:, idx < 0] = 0.0
    pad = np.concatenate([cols, np.zeros((5, n), np.float32)])
    want = np.asarray(bucket_cols_pallas(
        [jnp.asarray(c.reshape(rows, 128)) for c in pad],
        jnp.asarray(idx.reshape(rows, 128)), s, interpret=True,
    ))[:, :4]
    got = bucket.bucket_cols(torch.tensor(cols), torch.tensor(idx), s)
    assert got.shape == (s, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def _port_grads(scene, cfg, seed, **flags):
    c = tpt.RenderConfig(**cfg, **flags).replace(use_pallas_grad=True, grad_regen=True)
    ts, tc = convert_scene(scene, "cpu"), convert_camera(spt.make_camera(**CAM), "cpu")
    params, static = tpt.split_params(ts)
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    target = torch.full((c.height, c.width, 3), 0.25)
    loss = tpt.pixel_loss(params, static, target, tc, c, tpt.make_key(seed), device="cpu")
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), params_to_numpy(dict(zip(params, grads)))


def test_soft_stream_plane_rr_combined(monkeypatch):
    """Plane, soft silhouettes, Russian roulette and spp chunks at once
    (``tests/test_pallas_grad_regen.py:590``'s combination): the streamed
    route against the chunked one, and the checkpointed stream against the
    stream."""
    scene = _scene(True)
    cfg = dict(width=32, height=16, spp=6, max_depth=5, spp_chunk=2, rr_start_depth=2,
               silhouette_softness=SOFT)
    l_s, g_s = _port_grads(scene, cfg, 7)
    l_c, g_c = _port_grads(scene, cfg, 7, grad_regen_stream=False)
    assert l_s == l_c
    for k in g_s:
        np.testing.assert_allclose(g_s[k], g_c[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert np.abs(g_s["plane"][3]) > 0.0 and np.abs(g_s["radii"]).max() > 0.0
    monkeypatch.setattr(routes, "_IDX_PLANE_BUDGET", 1)
    l_f, g_f = _port_grads(scene, cfg, 7)
    assert l_f == l_s
    for k in g_s:
        np.testing.assert_array_equal(g_f[k], g_s[k], err_msg=k)
