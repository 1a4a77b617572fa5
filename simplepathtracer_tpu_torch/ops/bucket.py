"""Bucket accumulation of per-iteration attribute cotangents into the sphere
table: the scatter-add transpose of the winner lookup.

Counterpart of the JAX package's ``ops/pallas_bucket.py``
(``bucket_cols_pallas``, kernel ``_bucket_kernel``):

    d[s, k] = sum over rows r of [idx[r] == s] * cols[k, r]

Rows with ``idx < 0`` or ``idx >= n_buckets`` contribute nothing: dead and
miss iterations (``idx == -1``) and ground-plane winners (the plane codes,
whose cotangents the backward kernel sums on its own).  The column count K
is a parameter: 9 winner-attribute columns, 12 on an emissive scene (the
winner's emission rgb appended), or the soft blocker's 4 (cx, cy, cz, r;
the JAX package pads those to 9).

On a CUDA tensor ``bucket_cols`` launches the hand-written kernel in
``csrc/bucket.cu`` (each warp sums its 32 rows by key in registers, one
lane per distinct key adds them to a shared-memory table, and each block
adds its table's nonzero entries to the output with global atomics); on a
CPU tensor it calls the plain version ``bucket_cols_reference``
(``index_add_``).  The TPU kernel's
bitcast idx row and bf16x3 split exist for the TPU's matrix unit only and
have no counterpart here.  The kernel's atomics add in an order that
changes from run to run, so it agrees with the plain version to rounding
(rtol 1e-5), not bit for bit.
"""

from __future__ import annotations

import torch

from .. import tracing
from .cuda_build import load_library

# Column counts the kernel is built for: the 9 winner-attribute cotangents
# (cx cy cz r albedo rgb fuzz ior), those and the winner's emission rgb
# (12), and the soft blocker's 4 (cx cy cz r).
COLS = (9, 4, 12)


def bucket_cols(cols, idx, n_buckets: int):
    """[n_buckets, K] f32 table cotangent from ``cols`` [K, R] f32 and
    ``idx`` [R] int32 (any layout that flattens to R rows), K in COLS."""
    if idx.device.type == "cpu":
        return bucket_cols_reference(cols, idx, n_buckets)
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    k = cols.shape[0]
    cols = cols.reshape(k, -1)
    idx = idx.reshape(-1)
    r = idx.shape[0]
    if cols.shape[1] != r or cols.device != idx.device or k not in COLS:
        raise ValueError(f"cols must be [K in {COLS}, R] on the device of idx [R]")
    if cols.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError("cols must be float32 and idx int32")
    if not (cols.is_contiguous() and idx.is_contiguous()):
        raise ValueError("cols and idx must be contiguous")
    if not 0 < n_buckets <= 4096:
        raise ValueError(f"n_buckets={n_buckets} out of range (1..4096)")
    out = torch.zeros((n_buckets, k), dtype=torch.float32, device=idx.device)
    lib = load_library()
    with torch.cuda.device(idx.device):
        err = lib.lib.spt_bucket(
            cols.data_ptr(), idx.data_ptr(), r, k, n_buckets, out.data_ptr(),
            torch.cuda.current_stream(idx.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bucket kernel launch failed: CUDA error {err}")
    tracing.count(f"launch.bucket.{k}")
    return out


def bucket_cols_reference(cols, idx, n_buckets: int):
    """Plain version of ``bucket_cols``: ``index_add_`` over the rows whose
    index names a bucket."""
    tracing.count("plain.bucket_cols_reference")
    cols = cols.reshape(cols.shape[0], -1)
    idx = idx.reshape(-1).to(torch.int64)
    keep = (idx >= 0) & (idx < n_buckets)
    out = torch.zeros((n_buckets, cols.shape[0]), dtype=torch.float32, device=idx.device)
    return out.index_add_(0, idx[keep], cols[:, keep].T)
