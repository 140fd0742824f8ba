"""int8 x int8 -> int32 matrix product, exact: the product of the W8A8 serving
mode (``quant.int8_matmul``).

On CUDA tensors :func:`int8_matmul` launches the hand-written Hopper kernel in
``csrc/int8_matmul.cu`` (the port of
``scripts/bench_int8_native.py::pallas_int8_matmul``) or raises on what the
kernel does not take. On CPU tensors it runs :func:`int8_matmul_reference`.

The kernel reads B transposed, ``b_t`` [N, K] (K contiguous): see the note in
the source. A quantized module keeps that copy beside ``w_q`` and passes it;
without it the wrapper makes one, which costs a pass over B at every call.
"""

from __future__ import annotations

from typing import Optional

import torch


def int8_matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a [M, K] int8 @ b [K, N] int8 -> int32 [M, N].

    The product runs in fp64, which is exact (|sum| <= 127 * 127 * K <
    2**53): CUDA has no integer ``matmul`` and the CPU's is slow. Blocks of
    rows bound the memory of the fp64 copies."""
    bd = b.double()
    rows = [(a[i:i + 8192].double() @ bd).to(torch.int32)
            for i in range(0, a.shape[0], 8192)]
    if not rows:
        return torch.empty((0, b.shape[1]), dtype=torch.int32, device=a.device)
    return torch.cat(rows)


def _check_cuda_args(a, b, b_t):
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"int8_matmul: a must be [M, K] and b [K, N], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    for name, t, shape in (("a", a, (m, k)), ("b", b, (k, n)),
                           ("b_t", b_t, (n, k))):
        if t.device != a.device:
            raise ValueError(f"int8_matmul: {name} is on {t.device}, a on {a.device}")
        if t.dtype != torch.int8:
            raise ValueError(f"int8_matmul: {name} must be torch.int8, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"int8_matmul: {name} must be {shape}, "
                             f"got {tuple(t.shape)}")
    for name, t in (("a", a), ("b_t", b_t)):  # what the kernel reads
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int8_matmul: {name} must be contiguous and "
                             "16-byte aligned")
    if k % 32 or n % 128:
        raise ValueError(f"int8_matmul: K={k} must be a multiple of 32 and "
                         f"N={n} of 128")


def int8_matmul(a: torch.Tensor, b: torch.Tensor,
                b_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> int32 [M, N], exact.

    CPU tensors take :func:`int8_matmul_reference`. CUDA tensors launch the
    kernel (counted in ``int8_matmul.launches``): a and ``b_t`` (b transposed,
    [N, K]; made here when not given) int8, contiguous; K a multiple of 32, N
    of 128. Anything else raises."""
    if not a.is_cuda:
        return int8_matmul_reference(a, b)
    if b_t is None:
        b_t = b.t().contiguous()
    _check_cuda_args(a, b, b_t)
    from vitlens_tpu_torch.ops import _build

    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if m == 0:
        return out
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _build.library().vitlens_int8_matmul_fwd(
        a.data_ptr(), b_t.data_ptr(), out.data_ptr(), m, n, k, stream)
    _build.check(err, "int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
