"""The gradient kernels with ``SIL_FRESNEL`` on, against their plain
versions on the card: the regeneration kernels' soft and soft + plane
instantiations and the fused kernels' soft one, through the same checks as
with the switch off (``test_torch_grad_cuda.py``,
``test_torch_fused_cuda.py``: bit for bit, buckets inside their float64
bounds), and the regen backward's ``ior`` cotangents moved by the switch
while its forward is unchanged.  CUDA kernels have no CPU mode, so these
skip without an NVIDIA GPU; ``chip_smoke.py`` phases 5 and 8 hold the same
comparisons.  No JAX:

    python -m pytest --noconftest tests/test_torch_sil_fresnel_cuda.py -m cuda
"""

import pytest
import torch

import test_torch_fused_cuda as fused_cuda
import test_torch_grad_cuda as grad_cuda
from simplepathtracer_tpu_torch.ops import grad_regen as gr
from simplepathtracer_tpu_torch.ops import intersect


@pytest.fixture
def fresnel(monkeypatch):
    monkeypatch.setattr(intersect, "SIL_FRESNEL", True)


@pytest.mark.cuda
@pytest.mark.parametrize("rr,plane", [(0, False), (2, True)], ids=["soft", "soft-plane-rr"])
def test_regen_kernels_with_fresnel_match_plain_on_card(fresnel, rr, plane):
    grad_cuda.test_gradient_kernels_match_plain_on_card(rr, 0.05, plane)


@pytest.mark.cuda
@pytest.mark.parametrize("name,spp,depth,rr", [("cover", 2, 10, 0), ("three_sphere", 4, 6, 2)],
                         ids=["cover-soft", "trio-soft-rr"])
def test_fused_kernels_with_fresnel_match_plain_on_card(fresnel, name, spp, depth, rr):
    fused_cuda.test_fused_kernels_match_plain_on_card(name, spp, depth, rr, 0.05)


@pytest.mark.cuda
def test_fresnel_moves_only_the_regen_backward_on_card(monkeypatch):
    off = grad_cuda._call(2, 0.05, True)
    monkeypatch.setattr(intersect, "SIL_FRESNEL", True)
    on = grad_cuda._call(2, 0.05, True)
    assert gr.fresnel_on(on) and not gr.fresnel_on(off)
    rad_on, cnt_on, (resf, resi) = gr.regen_forward(on, 0, True)
    rad_off, cnt_off, (resf_off, resi_off) = gr.regen_forward(off, 0, True)
    alive = resf[9] > 0
    assert torch.equal(rad_on, rad_off) and torch.equal(cnt_on, cnt_off)
    assert torch.equal(resf[:, alive], resf_off[:, alive])
    ct = torch.randn((on.pixel_ids.shape[0], 3), generator=torch.Generator().manual_seed(2))
    ct = ct.to("cuda")
    ctp_on, part_on = gr.regen_backward(on, 0, resf, resi, ct)
    ctp_off, part_off = gr.regen_backward(off, 0, resf, resi, ct)
    glass = alive & (resi[4] == 2)
    moved = ctp_on[8] != ctp_off[8]
    assert moved.any() and not (moved & ~glass).any()
    assert torch.equal(ctp_on[4:7], ctp_off[4:7])
