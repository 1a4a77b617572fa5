"""The regeneration gradient kernels against their plain versions on the
card.  They are CUDA kernels with no CPU mode, so these tests skip without
an NVIDIA GPU; ``chip_smoke.py`` phase 5 holds the same comparisons.  The
recording forward's lane fetch (a resident grid whose threads take lanes
from a counter) is held on uneven lanes, and so is the backward's walk over
each warp's live span.  This file imports no JAX, so it
also runs where only the port is installed:

    python -m pytest tests/test_torch_grad_cuda.py -m cuda
"""

import pytest
import torch

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch import tracing
from simplepathtracer_tpu_torch.ops import bucket, grad_regen as gr


def _call(rr, softness=0.0, plane=True, pixel_ids=None, n_samples=8, n_banks=1, width=48,
          height=24):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    scene = tpt.three_sphere_scene(device="cuda")
    if plane:
        scene = tpt.with_ground_plane(scene)
    cam = tpt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=90, device="cuda")
    cfg = tpt.RenderConfig(width=width, height=height, spp=8, max_depth=10, rr_start_depth=rr,
                           silhouette_softness=softness)
    inputs, cam19 = gr._trace_inputs(scene, cam, cfg)
    if pixel_ids is None:
        pixel_ids = torch.arange(cfg.num_pixels)
    return gr.regen_call(
        inputs[:11], inputs[11], inputs[12], cam19, tpt.make_key(1), pixel_ids.to("cuda"),
        n_samples=n_samples, max_depth=10, width=width, height=height, rr_start_depth=rr,
        softness=softness, n_banks=n_banks,
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
    before = tracing.counts()
    rad, cnt, (resf, resi) = gr.regen_forward(call, 5, True)
    rad_p, cnt_p, (resf_p, resi_p) = gr.regen_fwd_reference(call, 5, True)
    assert (tracing.counts() - before)[f"launch.regen_forward.{gr.variant(call)}"] == 1
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
    with tracing.enabled(), tracing.span("spt.test.forward"):
        rad, cnt, packed = gr.regen_forward(call, 7, False)
    (rec,) = tracing.spans()
    counters = [rec["counts"][k] for k in ("lanes_fetched", "thread_iters", "blocks")]
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


@pytest.mark.cuda
@pytest.mark.parametrize("softness,plane", [(0.0, True), (0.05, False), (0.05, True)],
                         ids=["hard", "soft", "soft_plane"])
@pytest.mark.parametrize("rr", [0, 2], ids=["no-rr", "rr"])
@pytest.mark.parametrize("n_banks", [1, 2], ids=["1bank", "2banks"])
def test_regen_backward_uneven_lanes_on_card(n_banks, rr, softness, plane):
    """The backward walks each warp back from its lanes' longest count and
    writes the iterations above it as zeros without reading them.  Held bit
    for bit against the plain version on planes whose lanes end unevenly:
    1,000 pixels of a 48x24 frame in one bank, or 2,050 of a 64x48 frame
    in two (n_lanes 1,000 or 1,025, neither a multiple of 32), the
    forward's own counts cut short on two lanes in three (one lane in three
    to a single iteration, one to a random count, 0 included), and lanes
    32-63 -- a whole warp -- dead for the whole chunk."""
    gen = torch.Generator().manual_seed(11 + n_banks)
    w, h, n_pix = (48, 24, 1000) if n_banks == 1 else (64, 48, 2050)
    pix = torch.randperm(w * h, generator=gen)[:n_pix]
    call = _call(rr, softness, plane, pix, 12, n_banks, w, h)
    assert call.n_banks == n_banks and call.n_lanes % 32 != 0
    _, cnt, (resf, resi) = gr.regen_forward(call, 3, True)
    cnt = cnt.long().cpu()
    lanes = torch.arange(call.n_lanes)
    cut = torch.where(lanes % 3 == 1, cnt.clamp(max=1), cnt)
    rnd = (torch.rand(call.n_lanes, generator=gen) * (cnt + 1).double()).long()
    cut = torch.where(lanes % 3 == 2, rnd, cut)
    cut[32:64] = 0
    dead = (torch.arange(call.n_iter)[:, None] >= cut[None, :]).to("cuda")
    resf[9][dead] = 0.0
    resi[3][dead] = -1
    if softness:
        resi[gr._I_BLK][dead] = -1
    assert ((resf[9] > 0).sum(dim=0).cpu() == cut).all() and (cut < cnt).any()

    ct = torch.randn((call.pixel_ids.shape[0], 3), generator=gen).to("cuda")
    before = tracing.counts()
    ctp, part = gr.regen_backward(call, 3, resf, resi, ct)
    ctp_p, part_p = gr.regen_bwd_reference(call, 3, resf, resi, ct)
    assert (tracing.counts() - before)[f"launch.regen_backward.{gr.variant(call)}"] == 1
    assert torch.equal(ctp, ctp_p) and torch.equal(part, part_p)
    assert not ctp[:, dead].any() and not part[:, 32:64].any()
    assert ctp[:, ~dead].abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("softness,plane", [(0.0, True), (0.05, False), (0.05, True)],
                         ids=["hard", "soft", "soft_plane"])
@pytest.mark.parametrize("rr", [0, 2], ids=["no-rr", "rr"])
@pytest.mark.parametrize("n_banks", [1, 2], ids=["1bank", "2banks"])
def test_regen_reforward_uneven_lanes_on_card(n_banks, rr, softness, plane):
    """The full-residual forward and the re-forward walk each warp's
    iterations in step: a lane at or above its count stores alive 0 and idx
    -1 (soft: bidx -1) in the live lanes' store instructions, and the rows
    above the warp's longest count are stored alone.  Held on lanes that
    end unevenly (1,000 random pixels of a 48x24 frame in one bank, or
    2,050 of 64x48 in two: n_lanes 1,000 or 1,025, neither a multiple of
    32; 12 samples): every plane bit for bit against the plain version on
    live entries, alive 1 exactly below each lane's count and 0 from it on,
    idx (soft: bidx) -1 on every dead entry, and the backward fed by the
    re-forward's planes bit for bit equal to the backward fed by the plain
    version's (which reads only live entries and alive, so it gives what a
    re-forward that matches the plain version gave before)."""
    gen = torch.Generator().manual_seed(21 + n_banks)
    w, h, n_pix = (48, 24, 1000) if n_banks == 1 else (64, 48, 2050)
    pix = torch.randperm(w * h, generator=gen)[:n_pix]
    call = _call(rr, softness, plane, pix, 12, n_banks, w, h)
    assert call.n_banks == n_banks and call.n_lanes % 32 != 0
    v = gr.variant(call)
    before = tracing.counts()
    rad, cnt, full = gr.regen_forward(call, 3, True)
    _, _, packed = gr.regen_forward(call, 3, False)
    refwd = gr.regen_refwd(call, 3, packed)
    ran = tracing.counts() - before
    assert (ran[f"launch.regen_forward.{v}"], ran[f"launch.regen_refwd.{v}"]) == (2, 1)
    rad_p, cnt_p, (pf, pi) = gr.regen_fwd_reference(call, 3, True)
    assert torch.equal(rad, rad_p) and torch.equal(cnt, cnt_p)
    assert cnt.min() < cnt.max()
    dead = torch.arange(call.n_iter, device="cuda")[:, None] >= cnt.long()[None, :]
    alive = ~dead
    assert torch.equal(pf[9] > 0, alive)
    for f, i in (full, refwd):
        assert torch.equal(f[:, alive], pf[:, alive]) and torch.equal(i[:, alive], pi[:, alive])
        assert torch.equal(f[9], alive.float())
        assert (i[3][dead] == -1).all()
        if softness:
            assert (i[gr._I_BLK][dead] == -1).all()

    ct = torch.randn((call.pixel_ids.shape[0], 3), generator=gen).to("cuda")
    ctp, part = gr.regen_backward(call, 3, *refwd, ct)
    ctp_k, part_k = gr.regen_backward(call, 3, pf, pi, ct)
    ctp_p, part_p = gr.regen_bwd_reference(call, 3, pf, pi, ct)
    assert torch.equal(ctp, ctp_k) and torch.equal(part, part_k)
    assert torch.equal(ctp, ctp_p) and torch.equal(part, part_p)
    assert not ctp[:, dead].any() and ctp[:, alive].abs().sum() > 0
