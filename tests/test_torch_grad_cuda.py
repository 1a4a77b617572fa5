"""The regeneration gradient kernels against their plain versions on the
card.  They are CUDA kernels with no CPU mode, so these tests skip without
an NVIDIA GPU; ``chip_smoke.py`` phase 5 holds the same comparisons.  The
recording forward's lane fetch (a resident grid whose threads take lanes
from a counter) is held on uneven lanes.  This file imports no JAX, so it
also runs where only the port is installed:

    python -m pytest tests/test_torch_grad_cuda.py -m cuda
"""

import pytest
import torch

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch.ops import bucket, grad_regen as gr


def _call(rr, softness=0.0, plane=True, pixel_ids=None, n_samples=8):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    scene = tpt.three_sphere_scene(device="cuda")
    if plane:
        scene = tpt.with_ground_plane(scene)
    cam = tpt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=90, device="cuda")
    cfg = tpt.RenderConfig(width=48, height=24, spp=8, max_depth=10, rr_start_depth=rr,
                           silhouette_softness=softness)
    inputs, cam19 = gr._trace_inputs(scene, cam, cfg)
    if pixel_ids is None:
        pixel_ids = torch.arange(cfg.num_pixels)
    return gr.regen_call(
        inputs[:11], inputs[11], inputs[12], cam19, tpt.make_key(1), pixel_ids.to("cuda"),
        n_samples=n_samples, max_depth=10, width=48, height=24, rr_start_depth=rr,
        softness=softness,
    )


@pytest.mark.cuda
@pytest.mark.parametrize(
    "rr,softness,plane",
    [(0, 0.0, True), (2, 0.0, True), (0, 0.05, False), (2, 0.05, True)],
    ids=["plane", "plane-rr", "soft", "soft-plane-rr"],
)
def test_gradient_kernels_match_plain_on_card(rr, softness, plane):
    """Forward (both modes) and re-forward bit for bit, the backward to
    1e-5 (bit for bit expected), the buckets to rounding (atomics): the
    winner's 9 columns and, soft, the blocker's 4."""
    call = _call(rr, softness, plane)
    launches = gr.regen_forward.launches[gr.variant(call)]
    rad, cnt, (resf, resi) = gr.regen_forward(call, 5, True)
    rad_p, cnt_p, (resf_p, resi_p) = gr.regen_fwd_reference(call, 5, True)
    assert gr.regen_forward.launches[gr.variant(call)] == launches + 1
    alive = resf_p[9] > 0
    assert torch.equal(rad, rad_p) and torch.equal(cnt, cnt_p)
    assert torch.equal(resf[9], resf_p[9]) and torch.equal(resi[3], resi_p[3])
    assert torch.equal(resf[:, alive], resf_p[:, alive])
    assert torch.equal(resi[:, alive], resi_p[:, alive])

    rad_i, _, packed = gr.regen_forward(call, 5, False)
    assert torch.equal(rad_i, rad)
    assert torch.equal(packed, gr.regen_fwd_reference(call, 5, False)[2])
    rf, ri = gr.regen_refwd(call, 5, packed)
    assert torch.equal(rf[:, alive], resf[:, alive]) and torch.equal(ri[3], resi[3])

    ct = torch.randn((call.pixel_ids.shape[0], 3), device="cuda")
    ctp, part = gr.regen_backward(call, 5, resf, resi, ct)
    ctp_p, part_p = gr.regen_bwd_reference(call, 5, resf, resi, ct)
    assert torch.allclose(ctp, ctp_p, rtol=1e-5, atol=1e-5 * ctp_p.abs().max().item())
    assert torch.allclose(part, part_p, rtol=1e-5, atol=1e-5 * part_p.abs().max().item())

    # Atomics add in a changing order, and an entry's rows may cancel: held
    # against a float64 index_add_ to rtol 1e-5, atol 1e-7 of max |ct| and
    # 8 float32 roundings of the entry's absolute row sum (chip_smoke.py).
    cols = [(ctp[:9], resi[3])]
    if softness:
        assert (resi[gr._I_BLK] >= 0).any()
        cols.append((ctp[9:], resi[gr._I_BLK]))
    s = call.n_spheres
    for c, idx in cols:
        d = bucket.bucket_cols(c.contiguous(), idx.contiguous(), s)
        flat = idx.reshape(-1).long()
        keep = (flat >= 0) & (flat < s)
        src = c.reshape(c.shape[0], -1)[:, keep].T.double()
        ref = torch.zeros((s, c.shape[0]), dtype=torch.float64, device="cuda")
        mag = ref.clone().index_add_(0, flat[keep], src.abs())
        ref.index_add_(0, flat[keep], src)
        tol = 1e-5 * ref.abs() + 1e-7 * ctp.abs().max().item() + 8 * 2.0 ** -23 * mag
        assert bool(((d.double() - ref).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("softness,plane", [(0.0, True), (0.05, False), (0.05, True)],
                         ids=["hard", "soft", "soft_plane"])
@pytest.mark.parametrize(
    "n_samples,rr,n_pix",
    [(1, 0, 1000), (12, 2, 1000), (12, 2, 77), (1, 2, 1152)],
    ids=["1spp-1000px", "12spp-rr-1000px", "12spp-rr-77px", "1spp-rr-1152px"],
)
def test_regen_forward_lane_fetch_on_card(n_samples, rr, n_pix, softness, plane):
    """The idx-only forward's threads fetch lanes from a counter: on uneven
    lanes (1 sample against 12, Russian roulette, a lane count that is not
    a multiple of a warp, and 77 lanes, fewer than the resident grid's
    threads) its radiance, counts and packed words -- dead words included
    -- are bit-exact against the plain version and equal to the
    full-residual forward's (one thread per lane: alive 0, idx and bidx -1
    on dead iterations), and two launches are identical."""
    gen = torch.Generator().manual_seed(n_pix)
    pix = torch.randperm(48 * 24, generator=gen)[:n_pix]
    call = _call(rr, softness, plane, pix, n_samples)
    assert call.n_lanes == n_pix
    counters = torch.full((3,), -1, dtype=torch.int64, device="cuda")
    rad, cnt, packed = gr.regen_forward(call, 7, False, counters)
    counters = counters.tolist()
    rad2, cnt2, packed2 = gr.regen_forward(call, 7, False)
    rad_p, cnt_p, packed_p = gr.regen_fwd_reference(call, 7, False)
    assert torch.equal(rad, rad_p) and torch.equal(cnt, cnt_p) and torch.equal(packed, packed_p)
    assert torch.equal(rad, rad2) and torch.equal(cnt, cnt2) and torch.equal(packed, packed2)
    # Every lane fetched once (plus one failed fetch per thread); the
    # thread-iterations cover the lane-iterations.
    assert counters[0] >= call.n_lanes and counters[2] >= 1
    assert counters[1] >= cnt.sum().item() and counters[1] % 32 == 0

    rad_f, cnt_f, (rf, ri) = gr.regen_forward(call, 7, True)
    _, _, (pf, pi) = gr.regen_fwd_reference(call, 7, True)
    alive = pf[9] > 0
    assert torch.equal(rad_f, rad) and torch.equal(cnt_f, cnt)
    assert torch.equal(rf[9], pf[9]) and torch.equal(ri[3], pi[3])
    assert torch.equal(rf[:, alive], pf[:, alive]) and torch.equal(ri[:, alive], pi[:, alive])
    if softness:
        assert torch.equal(ri[gr._I_BLK], pi[gr._I_BLK])
