"""int8 x int8 products of the W8A8 serving mode (``quant.int8_matmul``) and
the per-row activation quantisation that feeds them.

* :func:`int8_matmul`: a [M, K] int8 @ b [K, N] int8 -> int32, exact (the
  ``INT32`` epilogue; the port of
  ``scripts/bench_int8_native.py::pallas_int8_matmul``).
* :func:`int8_quantize`: x [M, K] -> (int8 rows, fp32 row scales), the head
  of ``quant.int8_matmul``.
* :func:`int8_matmul_dequant`: the same product with the tail of
  ``quant.int8_matmul`` as its epilogue (the ``DEQUANT`` epilogue): row
  scale, column scale and bias applied in fp32, one cast to the output dtype.

On CUDA tensors each launches its hand-written Hopper kernel in
``csrc/int8_matmul.cu`` or raises on what the kernel does not take; on CPU
tensors each runs its plain version (``*_reference``), which the kernels are
held to bit for bit on the card.

The products read B transposed, ``b_t`` [N, K] (K contiguous): see the note
in the source. A quantized module keeps that copy beside ``w_q`` and passes
it; without it the wrapper makes one, which costs a pass over B at every call.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_Q = 127.0
_OUT_DTYPES = (torch.bfloat16, torch.float32)


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


def int8_quantize_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the quantise step: x [M, K] -> (xi int8 [M, K],
    xs fp32 [M, 1]) with xs = max(amax |x| / 127, 1e-12) and xi =
    clip(round(x / xs), -127, 127), rounding half to even.

    Both divisions are IEEE divisions on either device, as the JAX package's
    ``jnp`` ops compute them: PyTorch's CUDA division by a Python scalar
    multiplies by the reciprocal instead, which differs in the last bit of
    about one row scale in twenty, so 127 is a tensor here."""
    x2 = x.float()
    amax = x2.abs().amax(dim=-1, keepdim=True)
    xs = (amax / amax.new_tensor(_Q)).clamp_min(1e-12)
    xi = torch.round(x2 / xs).clamp(-_Q, _Q).to(torch.int8)
    return xi, xs


def dequant_reference(acc: torch.Tensor, xs: torch.Tensor, w_s: torch.Tensor,
                      bias: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """Plain version of the dequantise step: ((float(acc) * xs) * w_s) +
    bias in fp32, in that order, then one cast to ``dtype``."""
    y = acc.float() * xs.reshape(-1, 1) * w_s.reshape(1, -1)
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def _check_aligned(fn, name, t):
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} must be contiguous and 16-byte aligned")


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
        _check_aligned("int8_matmul", name, t)
    if k % 32 or n % 128:
        raise ValueError(f"int8_matmul: K={k} must be a multiple of 32 and "
                         f"N={n} of 128")


def _check_dequant_args(a, b, b_t, xs, w_s, bias, dtype):
    _check_cuda_args(a, b, b_t)
    m, n = a.shape[0], b.shape[1]
    if dtype not in _OUT_DTYPES:
        raise ValueError(f"int8_matmul_dequant: the output dtype must be one "
                         f"of {_OUT_DTYPES}, got {dtype}")
    for name, t, numel in (("xs", xs, m), ("w_s", w_s, n), ("bias", bias, n)):
        if t is None:
            continue
        if t.device != a.device:
            raise ValueError(f"int8_matmul_dequant: {name} is on {t.device}, "
                             f"a on {a.device}")
        if t.dtype != torch.float32 or t.numel() != numel:
            raise ValueError(f"int8_matmul_dequant: {name} must be {numel} "
                             f"torch.float32 values, got {t.numel()} {t.dtype}")
        _check_aligned("int8_matmul_dequant", name, t)


def _check_quantize_args(x):
    if x.dim() != 2:
        raise ValueError(f"int8_quantize: x must be [M, K], got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8_quantize: x must be bfloat16 or float32, got "
                         f"{x.dtype}")
    if x.shape[1] % 32:
        raise ValueError(f"int8_quantize: K={x.shape[1]} must be a multiple of 32")
    _check_aligned("int8_quantize", "x", x)


def int8_matmul(a: torch.Tensor, b: torch.Tensor,
                b_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> int32 [M, N], exact.

    CPU tensors take :func:`int8_matmul_reference`. CUDA tensors launch the
    kernel's INT32 epilogue (counted in ``int8_matmul.launches``): a and
    ``b_t`` (b transposed, [N, K]; made here when not given) int8,
    contiguous; K a multiple of 32, N of 128. Anything else raises."""
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
    err = _build.library().vitlens_int8_matmul_fwd(
        a.data_ptr(), b_t.data_ptr(), out.data_ptr(), m, n, k,
        _build.stream_of(a))
    _build.check(err, "int8_matmul")
    int8_matmul.launches += 1
    return out


def int8_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [M, K] -> (xi int8 [M, K], xs fp32 [M, 1]), per-row symmetric.

    CPU tensors take :func:`int8_quantize_reference`. CUDA tensors launch the
    quantise kernel (counted in ``int8_quantize.launches``): x bf16 or fp32,
    contiguous, K a multiple of 32. Anything else raises."""
    if not x.is_cuda:
        return int8_quantize_reference(x)
    _check_quantize_args(x)
    from vitlens_tpu_torch.ops import _build

    m, k = x.shape
    xi = torch.empty((m, k), dtype=torch.int8, device=x.device)
    xs = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m == 0:
        return xi, xs
    err = _build.library().vitlens_int8_quantize_fwd(
        x.data_ptr(), xi.data_ptr(), xs.data_ptr(), m, k,
        int(x.dtype == torch.bfloat16), _build.stream_of(x))
    _build.check(err, "int8_quantize")
    int8_quantize.launches += 1
    return xi, xs


def int8_matmul_dequant(a: torch.Tensor, b: torch.Tensor, xs: torch.Tensor,
                        w_s: torch.Tensor, bias: Optional[torch.Tensor] = None,
                        dtype=torch.bfloat16,
                        b_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """cast(((float(a @ b) * xs) * w_s) + bias) -> [M, N] in ``dtype``.

    a [M, K] int8 (quantised rows), b [K, N] int8, xs the M row scales,
    w_s the N column scales, bias N values or None, all fp32. CPU tensors
    take :func:`dequant_reference` of :func:`int8_matmul_reference`. CUDA
    tensors launch the kernel's DEQUANT epilogue (counted in
    ``int8_matmul_dequant.launches``): as :func:`int8_matmul`, with
    contiguous scales and bias and ``dtype`` bf16 or fp32. Anything else
    raises."""
    if not a.is_cuda:
        return dequant_reference(int8_matmul_reference(a, b), xs, w_s, bias,
                                 dtype)
    if b_t is None:
        b_t = b.t().contiguous()
    _check_dequant_args(a, b, b_t, xs, w_s, bias, dtype)
    from vitlens_tpu_torch.ops import _build

    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=dtype, device=a.device)
    if m == 0:
        return out
    err = _build.library().vitlens_int8_matmul_dequant_fwd(
        a.data_ptr(), b_t.data_ptr(), xs.data_ptr(), w_s.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), m, n, k,
        int(dtype == torch.bfloat16), _build.stream_of(a))
    _build.check(err, "int8_matmul_dequant")
    int8_matmul_dequant.launches += 1
    return out


int8_matmul.launches = 0
int8_quantize.launches = 0
int8_matmul_dequant.launches = 0
