"""The regeneration gradient kernels against their plain versions on the
card.  They are CUDA kernels with no CPU mode, so these tests skip without
an NVIDIA GPU; ``chip_smoke.py`` phase 5 holds the same comparisons.  This
file imports no JAX, so it also runs where only the port is installed:

    python -m pytest tests/test_torch_grad_cuda.py -m cuda
"""

import pytest
import torch

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch.ops import bucket, grad_regen as gr


def _call(rr, softness=0.0, plane=True):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    scene = tpt.three_sphere_scene(device="cuda")
    if plane:
        scene = tpt.with_ground_plane(scene)
    cam = tpt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=90, device="cuda")
    cfg = tpt.RenderConfig(width=48, height=24, spp=8, max_depth=10, rr_start_depth=rr,
                           silhouette_softness=softness)
    inputs, cam19 = gr._trace_inputs(scene, cam, cfg)
    return gr.regen_call(
        inputs[:11], inputs[11], inputs[12], cam19, tpt.make_key(1),
        torch.arange(cfg.num_pixels, device="cuda"), n_samples=8, max_depth=10,
        width=48, height=24, rr_start_depth=rr, softness=softness,
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
