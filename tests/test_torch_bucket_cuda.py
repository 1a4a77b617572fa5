"""The bucket kernel (``csrc/bucket.cu``) against a float64 ``index_add_``
on the card, on key patterns that take each path of its warp reduction:
one key over every row (the butterfly), alternating keys, 32 distinct keys
per warp, 90% of rows on slot 0, rows that name no slot (idx -1 and idx >=
n_buckets), zero cotangents, and a row count that is not a multiple of 32.
It is a CUDA kernel with no CPU mode, so these tests skip without an NVIDIA
GPU; ``chip_smoke.py`` holds it at the main paths' shapes.  This file
imports no JAX:

    python -m pytest --noconftest tests/test_torch_bucket_cuda.py -m cuda

The kernel's atomics add in an order that changes from run to run, so it
is held to the float64 sum of the same rows under ``chip_smoke.py``'s
bound (``kernel_cases.float64_bound``): rtol 1e-5, atol 1e-7 of max
|cotangent|, and 8 float32 roundings of the entry's absolute row sum.
"""

import numpy as np
import pytest
import torch
from kernel_cases import PATTERNS, float64_bound, key_pattern

from simplepathtracer_tpu_torch import tracing
from simplepathtracer_tpu_torch.ops import bucket


@pytest.mark.cuda
@pytest.mark.parametrize("k", bucket.COLS)
@pytest.mark.parametrize("n_buckets", (1, 3, 488, 4096))
@pytest.mark.parametrize("pattern", PATTERNS)
def test_bucket_kernel_matches_float64_on_card(pattern, n_buckets, k):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cols, idx = (torch.tensor(a).cuda() for a in key_pattern(
        pattern, n_buckets, k, np.random.default_rng(0), 65_536))
    before = tracing.counts()
    got = bucket.bucket_cols(cols, idx, n_buckets)
    assert (tracing.counts() - before)[f"launch.bucket.{k}"] == 1
    assert got.shape == (n_buckets, k) and got.dtype == torch.float32
    ref, tol = float64_bound(cols, idx, n_buckets)
    assert bool(((got.double() - ref).abs() <= tol).all())
