"""Bucket accumulation of per-iteration attribute cotangents into the sphere
table: the scatter-add transpose of the winner lookup.

Counterpart of the JAX package's ``ops/pallas_bucket.py``
(``bucket_cols_pallas``, kernel ``_bucket_kernel``):

    d[s, k] = sum over rows r of [idx[r] == s] * cols[k, r]

Rows with ``idx < 0`` or ``idx >= n_buckets`` contribute nothing: dead and
miss iterations (``idx == -1``) and ground-plane winners (``PLANE_IDX``,
whose cotangents the backward kernel sums on its own).

On a CUDA tensor ``bucket_cols`` launches the hand-written kernel in
``csrc/bucket.cu`` (shared-memory accumulators, shared atomics, one global
atomic per table entry and block); on a CPU tensor it calls the plain
version ``bucket_cols_reference`` (``index_add_``).  The TPU kernel's
bitcast idx row and bf16x3 split exist for the TPU's matrix unit only and
have no counterpart here.  The kernel's atomics add in an order that
changes from run to run, so it agrees with the plain version to rounding
(rtol 1e-5), not bit for bit.
"""

from __future__ import annotations

import torch

from .cuda_build import load_library

_KC = 9  # cotangent columns: cx cy cz r albedo rgb fuzz ior


def bucket_cols(cols, idx, n_buckets: int):
    """[n_buckets, 9] f32 table cotangent from ``cols`` [9, R] f32 and
    ``idx`` [R] int32 (any layout that flattens to R rows)."""
    if idx.device.type == "cpu":
        return bucket_cols_reference(cols, idx, n_buckets)
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    cols = cols.reshape(_KC, -1)
    idx = idx.reshape(-1)
    r = idx.shape[0]
    if cols.shape[1] != r or cols.device != idx.device:
        raise ValueError("cols must be [9, R] on the device of idx [R]")
    if cols.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError("cols must be float32 and idx int32")
    if not (cols.is_contiguous() and idx.is_contiguous()):
        raise ValueError("cols and idx must be contiguous")
    if not 0 < n_buckets <= 4096:
        raise ValueError(f"n_buckets={n_buckets} out of range (1..4096)")
    out = torch.zeros((n_buckets, _KC), dtype=torch.float32, device=idx.device)
    lib = load_library()
    with torch.cuda.device(idx.device):
        err = lib.lib.spt_bucket(
            cols.data_ptr(), idx.data_ptr(), r, n_buckets, out.data_ptr(),
            torch.cuda.current_stream(idx.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bucket kernel launch failed: CUDA error {err}")
    bucket_cols.launches += 1
    return out


bucket_cols.launches = 0


def bucket_cols_reference(cols, idx, n_buckets: int):
    """Plain version of ``bucket_cols``: ``index_add_`` over the rows whose
    index names a bucket."""
    bucket_cols_reference.calls += 1
    cols = cols.reshape(_KC, -1)
    idx = idx.reshape(-1).to(torch.int64)
    keep = (idx >= 0) & (idx < n_buckets)
    out = torch.zeros((n_buckets, _KC), dtype=torch.float32, device=idx.device)
    return out.index_add_(0, idx[keep], cols[:, keep].T)


bucket_cols_reference.calls = 0
