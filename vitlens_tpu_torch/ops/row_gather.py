"""Row gather: out[j, :] = table[ids[j], :], bit-exact.

On CUDA tensors :func:`row_gather` launches the hand-written Hopper kernel in
``csrc/row_gather.cu`` (the port of
``scripts/bench_dma_gather.py::dma_gather``) or raises on what the kernel does
not take. On CPU tensors it runs :func:`row_gather_reference`.

An id outside [0, V) is the caller's fault: the plain version raises an
``IndexError``, the kernel clamps it to the nearest row. The text tower's
embedding lookup does not go through this kernel, as the JAX package's does not
go through its prototype.
"""

from __future__ import annotations

import torch


def row_gather_reference(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: table [V, D], ids [J] -> [J, D]."""
    return table[ids.long()]


def _check_cuda_args(table, ids):
    if table.dim() != 2 or ids.dim() != 1:
        raise ValueError(f"row_gather: table must be [V, D] and ids [J], got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    if ids.device != table.device:
        raise ValueError(f"row_gather: ids is on {ids.device}, table on "
                         f"{table.device}")
    if ids.dtype != torch.int32:
        raise ValueError(f"row_gather: ids must be torch.int32, got {ids.dtype}")
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes == 0 or row_bytes % 16:
        raise ValueError(f"row_gather: a table row must be a multiple of 16 "
                         f"bytes, got {row_bytes}")
    if table.shape[0] == 0:
        raise ValueError("row_gather: the table has no rows")
    for name, t in (("table", table), ("ids", ids)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"row_gather: {name} must be contiguous and "
                             "16-byte aligned")


def row_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table [V, D] (any dtype), ids [J] int32 -> table[ids] [J, D].

    CPU tensors take :func:`row_gather_reference`. CUDA tensors launch the
    kernel (counted in ``row_gather.launches``): a contiguous table whose row
    is a multiple of 16 bytes, int32 ids. Anything else raises."""
    if not table.is_cuda:
        return row_gather_reference(table, ids)
    _check_cuda_args(table, ids)
    from vitlens_tpu_torch.ops import _build

    v, d = table.shape
    j = ids.shape[0]
    out = torch.empty((j, d), dtype=table.dtype, device=table.device)
    if j == 0:
        return out
    err = _build.library().vitlens_row_gather_fwd(
        table.data_ptr(), ids.data_ptr(), out.data_ptr(), j, v,
        d * table.element_size(), _build.stream_of(table))
    _build.check(err, "row_gather")
    row_gather.launches += 1
    return out


row_gather.launches = 0
