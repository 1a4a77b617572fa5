"""Differentiable sphere-table gathers whose backward buckets cotangents by
winner index (counterpart of the JAX package's ``ops/table_gather.py``).

The backward of both is the scatter-add transpose of the winner lookup,
d_table[s, k] = sum over rows r of [idx[r] == s] ct[r, k]; rows with idx
-1 (a miss or a dead ray) bucket nowhere.

* ``gather_rows`` (any [S, K] table) buckets through ``bucket_rows``, a
  plain ``index_add_``, on every device: the JAX package's ``gather_rows``
  sums with its jnp ``bucket_rows`` too, outside any Pallas kernel.  (Its
  chunked one-hot matmuls served the TPU's matrix unit and have no
  counterpart here.)
* ``attach_attr_columns`` is the ``use_pallas_hits`` bounce's: it
  reattaches the table's gradient to the winner attributes the closest-hit
  kernel read (``ops/closest_hit.py``), detached.  Its backward is
  ``ops/bucket.py:bucket_cols``: the CUDA kernel (sums by key within each
  warp, then shared-memory and global atomics) on a CUDA tensor, which
  takes the [S, 9] table of ``pack_tables`` (``bucket.COLS``; up to 4096
  slots), and its plain version on the CPU.

All float attributes come through ONE [S, 9] matrix (``pack_tables``), so
the backward buckets once per bounce.
"""

from __future__ import annotations

import torch

from . import bucket as _bucket


def pack_tables(scene) -> torch.Tensor:
    """[S, 9] float-attribute matrix: cx cy cz r albedo rgb fuzz ior.
    Differentiable in every scene leaf it holds: autograd splits the
    bucketed [S, 9] cotangent back into the leaves."""
    return torch.cat(
        [scene.centers, scene.radii[:, None], scene.albedo, scene.fuzz[:, None],
         scene.ior[:, None]],
        dim=1,
    )


def bucket_rows(ct, idx, s):
    """Plain bucketing of cotangent rows into table slots: [N, K], [N] ->
    [S, K] (``index_add_``; rows with idx outside [0, S) add nothing)."""
    return _bucket.bucket_cols_reference(ct.T, idx, s)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.s = table.shape[0]
        return table[idx.to(torch.int64)]

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return bucket_rows(ct, idx, ctx.s), None


def gather_rows(table, idx):
    """table [S, K], idx [N] in [0, S) -> [N, K], differentiable in
    ``table`` (idx is discrete)."""
    return _GatherRows.apply(table, idx)


class _AttachAttrColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, *cols):
        ctx.save_for_backward(idx)
        ctx.s = table.shape[0]
        return cols

    @staticmethod
    def backward(ctx, *ct_cols):
        (idx,) = ctx.saved_tensors
        d_table = _bucket.bucket_cols(torch.stack(ct_cols).to(torch.float32).contiguous(),
                                      idx.to(torch.int32).contiguous(), ctx.s)
        return (d_table, None) + (None,) * len(ct_cols)


def attach_attr_columns(table, idx, *cols):
    """Reattach ``table``'s gradient to the winner attributes ``cols`` (K [N]
    columns the closest-hit kernel read from rows ``idx`` of the table,
    equal to ``table[idx].T``, -1 for none).  Forward: the columns' values.
    Backward: the cotangents bucketed into d(table), as a gather's
    transpose would be (the discrete idx is locally constant)."""
    return _AttachAttrColumns.apply(table, idx, *cols)
