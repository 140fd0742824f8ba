"""Residual MLP half of a transformer block: out = x + act(LN(x) @ W1 + b1) @ W2 + b2.

On a CUDA tensor :func:`fused_mlp` launches the hand-written Hopper kernel in
``csrc/fused_mlp.cu`` (the port of
``vitlens_tpu/ops/fused_mlp.py::_pallas_fused_mlp``, forward only) or raises on
what the kernel does not take. On a CPU tensor it runs
:func:`fused_mlp_reference`, the plain PyTorch version, which mirrors the JAX
package's ``_xla_reference``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

ACTS = ("gelu", "quick_gelu")


def _act(h32: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu":
        return F.gelu(h32)
    return h32 * torch.sigmoid(1.702 * h32)


def fused_mlp_reference(x, lnw, lnb, w1, b1, w2, b2, act: str = "gelu",
                        eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version. x [M, D]; lnw, lnb [D]; w1 [D, H]; b1 [H];
    w2 [H, D]; b2 [D]. LN in fp32 rounded to x.dtype, biases cast to x.dtype,
    the activation in fp32 rounded once."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps) * lnw.float() + lnb.float())
    y = y.to(x.dtype)
    h = y @ w1.to(x.dtype) + b1.to(x.dtype)
    h = _act(h.float(), act).to(x.dtype)
    return x + (h @ w2.to(x.dtype) + b2.to(x.dtype))


def _check_cuda_args(x, lnw, lnb, w1, b1, w2, b2, act):
    if act not in ACTS:
        raise ValueError(f"fused_mlp: act must be one of {ACTS}, got {act!r}")
    if x.dim() != 2:
        raise ValueError(f"fused_mlp: x must be [M, D], got {tuple(x.shape)}")
    m, d = x.shape
    h = w1.shape[-1]
    for name, t, shape, dtype in (
            ("x", x, (m, d), torch.bfloat16),
            ("w1", w1, (d, h), torch.bfloat16),
            ("w2", w2, (h, d), torch.bfloat16),
            ("lnw", lnw, (d,), torch.float32),
            ("lnb", lnb, (d,), torch.float32),
            ("b1", b1, (h,), torch.float32),
            ("b2", b2, (d,), torch.float32)):
        if t.device != x.device:
            raise ValueError(f"fused_mlp: {name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise ValueError(f"fused_mlp: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_mlp: {name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_mlp: {name} must be contiguous and "
                             "16-byte aligned")
    if d % 64 or h % 64:
        raise ValueError(f"fused_mlp: D={d} and H={h} must be multiples of 64")


def fused_mlp(x, lnw, lnb, w1, b1, w2, b2, act: str = "gelu",
              eps: float = 1e-5) -> torch.Tensor:
    """x [M, D] -> x + act(LN(x) @ w1 + b1) @ w2 + b2.

    CPU tensors take :func:`fused_mlp_reference`. CUDA tensors launch the
    kernel: x, w1, w2 bf16; lnw, lnb, b1, b2 fp32; all contiguous; D and H
    multiples of 64. Anything else raises."""
    if not x.is_cuda:
        return fused_mlp_reference(x, lnw, lnb, w1, b1, w2, b2, act, eps)
    _check_cuda_args(x, lnw, lnb, w1, b1, w2, b2, act)
    from vitlens_tpu_torch.ops import _build

    m, d = x.shape
    h = w1.shape[1]
    out = torch.empty_like(x)
    if m == 0:
        return out
    y_scratch = torch.empty_like(x)
    h_scratch = torch.empty((m, h), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.library().vitlens_fused_mlp_fwd(
        x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), y_scratch.data_ptr(),
        h_scratch.data_ptr(), out.data_ptr(), m, d, h, ACTS.index(act),
        float(eps), stream)
    _build.check(err, "fused_mlp")
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0
