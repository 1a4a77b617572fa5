"""What the regeneration backward's schedule relies on, held on the plain
versions (CPU; no JAX).

``csrc/grad_regen.cu:regen_bwd_kernel`` finds each lane's count of live
iterations by a binary search over its alive column and walks each warp
back from its lanes' longest count; it reads nothing of a dead entry and
writes its cotangents as zeros.  That is right only if

* every producer of residual planes -- the recording forward and the
  re-forward -- writes a lane's alive column as 1 on iterations 0 ..
  count - 1 and 0 after, with count the forward's live-iteration count;
* the backward's result does not depend on what a dead entry's planes
  hold, besides alive 0 and idx (soft: bidx) -1.

Both are checked here on small shapes for the three kernel variants (hard
with a ground plane, soft, soft with a plane), with and without Russian
roulette, on one bank and on two (each lane serves two pixels in turn).
The kernels are held against these plain versions on the card
(``tests/test_torch_grad_cuda.py``, ``chip_smoke.py``).
"""

import pytest
import torch

import simplepathtracer_tpu_torch as tpt
from simplepathtracer_tpu_torch.ops import grad_regen as gr

W, H, SPP, DEPTH = 64, 32, 2, 5
VARIANTS = [(0.0, True), (0.05, False), (0.05, True)]
VARIANT_IDS = ["hard", "soft", "soft_plane"]


def _call(softness, plane, rr, n_banks):
    scene = tpt.three_sphere_scene(device="cpu")
    if plane:
        scene = tpt.with_ground_plane(scene)
    cam = tpt.make_camera(origin=(0, 0, -1), lookat=(0, 0, 1), vfov_deg=90, device="cpu")
    cfg = tpt.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH, rr_start_depth=rr,
                           silhouette_softness=softness)
    inputs, cam19 = gr._trace_inputs(scene, cam, cfg)
    return gr.regen_call(
        inputs[:11], inputs[11], inputs[12], cam19, tpt.make_key(4),
        torch.arange(cfg.num_pixels), n_samples=SPP, max_depth=DEPTH, width=W, height=H,
        rr_start_depth=rr, n_banks=n_banks, softness=softness,
    )


@pytest.mark.parametrize("softness,plane", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("rr", [0, 2], ids=["no-rr", "rr"])
@pytest.mark.parametrize("n_banks", [1, 2], ids=["1bank", "2banks"])
def test_alive_columns_are_prefixes_of_the_count(n_banks, rr, softness, plane):
    """Recording forward (full residuals) and re-forward: alive is 1 exactly
    below the lane's count, which is the forward's own count; idx (soft:
    bidx) is -1 on every dead entry."""
    torch.set_num_threads(1)
    call = _call(softness, plane, rr, n_banks)
    assert call.n_banks == n_banks
    _, cnt, (resf, resi) = gr.regen_fwd_reference(call, 2, True)
    _, cnt_i, packed = gr.regen_fwd_reference(call, 2, False)
    rf, ri = gr.regen_refwd_reference(call, 2, packed)
    its = torch.arange(call.n_iter)[:, None]
    for f, i in ((resf, resi), (rf, ri)):
        alive = f[9] > 0
        count = alive.sum(dim=0)
        assert torch.equal(count.to(torch.float32), cnt)
        assert torch.equal(alive, its < count[None, :])
        assert (i[3][~alive] == -1).all()
        if softness:
            assert (i[gr._I_BLK][~alive] == -1).all()
    assert torch.equal(cnt_i, cnt)
    # Lanes end unevenly, and some only at the chunk's last iteration.
    assert cnt.min() < cnt.max() <= call.n_iter


@pytest.mark.parametrize("softness,plane", VARIANTS, ids=VARIANT_IDS)
def test_backward_ignores_dead_entries(softness, plane):
    """The plain backward gives the same cotangent planes (zero on every
    dead entry) and partials when every plane of a dead entry but alive and
    idx (soft: bidx) holds garbage."""
    torch.set_num_threads(1)
    call = _call(softness, plane, 2, 2)
    _, _, (resf, resi) = gr.regen_fwd_reference(call, 0, True)
    ct = torch.randn((call.pixel_ids.shape[0], 3), generator=torch.Generator().manual_seed(1))
    ctp, part = gr.regen_bwd_reference(call, 0, resf, resi, ct)
    dead = ~(resf[9] > 0)
    assert dead.any() and not ctp[:, dead].any()

    gen = torch.Generator().manual_seed(2)
    f, i = resf.clone(), resi.clone()
    keep_f = [9]
    keep_i = [3, gr._I_BLK] if softness else [3]
    for k in range(f.shape[0]):
        if k not in keep_f:
            f[k][dead] = torch.randn(int(dead.sum()), generator=gen) * 1e3
    for k in range(i.shape[0]):
        if k not in keep_i:
            i[k][dead] = torch.randint(-5, 50, (int(dead.sum()),), generator=gen,
                                       dtype=torch.int32)
    ctp_g, part_g = gr.regen_bwd_reference(call, 0, f, i, ct)
    assert torch.equal(ctp_g, ctp) and torch.equal(part_g, part)
