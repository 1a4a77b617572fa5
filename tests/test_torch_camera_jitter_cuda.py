"""The camera-jitter kernel (``csrc/camera_jitter.cu``) against its plain
version on the card, bit for bit.  A CUDA kernel has no CPU mode, so these
tests skip without an NVIDIA GPU; ``chip_smoke.py`` holds the same
comparison at the camera fit's 48 M rays.  This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_camera_jitter_cuda.py -m cuda

The cases run whole tiles of 1024 rays (n % 1024 == 0) and a ragged last
tile (the scalar tail), ids 16-byte aligned and 8 bytes off (the kernel
reads one int64 id per ray either way), ids at their edges and key words
with their high bits set.  Each call launches the kernel exactly once and
runs no plain version.
"""

import pytest
import torch

from simplepathtracer_tpu_torch import tracing
from simplepathtracer_tpu_torch.ops import sampling as ts

# The cover frame's pixels and the last sample id a counter holds.
FRAME = 1200 * 800
MAX_SAMPLE = 2**24 - 1


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _ids(n, offset, dev, gen):
    """Random pixel and sample ids of n rays, each array starting ``offset``
    int64 elements into its buffer (1: 8 bytes off a 16-byte boundary)."""
    pix = torch.randint(0, FRAME, (n + offset,), generator=gen)[offset:].to(dev)
    smp = torch.randint(0, MAX_SAMPLE + 1, (n + offset,), generator=gen)[offset:].to(dev)
    if offset:
        pix = torch.empty(n + offset, dtype=torch.int64, device=dev)[offset:].copy_(pix)
        smp = torch.empty(n + offset, dtype=torch.int64, device=dev)[offset:].copy_(smp)
    assert (pix.data_ptr() % 16 == 0) == (offset == 0)
    return pix, smp


def _check(ctx):
    before = tracing.counts()
    got = ts.camera_jitter(ctx)
    torch.cuda.synchronize()
    ran = tracing.counts() - before
    assert ran == {"launch.camera_jitter": 1}
    want = ts.camera_jitter_reference(ctx)
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 1 << 20, 1, 3, 1025, 4099, (1 << 20) + 5])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("key", [(0, 4), (0xFFFFFFFF, 0x80000001)], ids=["key", "high_bits"])
def test_camera_jitter_kernel_matches_plain_on_card(n, offset, key):
    dev = _card()
    pix, smp = _ids(n, offset, dev, torch.Generator().manual_seed(n + offset))
    _check(ts.RayCtx(key[0], key[1], pix, smp))


@pytest.mark.cuda
@pytest.mark.parametrize("width,height,spp", [(1200, 800, 2), (48, 24, 8), (37, 13, 3)])
def test_camera_jitter_kernel_edge_ids_on_card(width, height, spp):
    """Every pixel id of the frame up to width * height - 1, with sample ids
    counted down from 2^24 - 1, as ``ray_keys`` makes them."""
    dev = _card()
    p = width * height
    pids = torch.arange(p, device=dev).repeat(spp)
    sids = (MAX_SAMPLE - torch.arange(spp, device=dev)).repeat_interleave(p)
    _check(ts.ray_keys(torch.tensor([0xFFFFFFFF, 0x80000001]), pids, sids))


@pytest.mark.cuda
def test_camera_jitter_kernel_refuses_what_it_does_not_take():
    dev = _card()
    pix = torch.arange(8, device=dev)
    before = tracing.counts()
    for bad in (ts.RayCtx(0, 1, pix.int(), pix.int()),
                ts.RayCtx(0, 1, pix[::2], pix[::2]),
                ts.RayCtx(0, 1, pix, pix[:4])):
        with pytest.raises(ValueError, match="contiguous int64"):
            ts.camera_jitter(bad)
    empty = ts.camera_jitter(ts.RayCtx(0, 1, pix[:0], pix[:0]))
    assert empty.shape == (0, 4) and tracing.counts() == before
