"""The residual MLP half of a block, optionally with the attention
out-projection in front of it.

    chunked MLP:   row32 = x
    attn-out+MLP:  row32 = x + ctx @ Wo + bo        (fp32, never rounded)
    out = (row32 + b2 + act(LN(row32) @ W1 + b1) @ W2) rounded once

On CUDA tensors :func:`fused_mlp_chunked` and :func:`fused_attnout_mlp` launch
hand-written Hopper kernels or raise on what the kernels do not take.
:func:`fused_mlp_chunked` (the port of ``scripts/fused_mlp_pallas.py::fused_mlp``)
runs kernel 1's launches in ``csrc/fused_mlp.cu`` with the tanh GELU;
:func:`fused_attnout_mlp` (the port of
``scripts/fused_attnout_mlp_pallas.py::fused``) runs ``csrc/fused_mlp_chain.cu``:
the out-projection on ``gemm_sm90.cuh`` with an epilogue that writes the fp32
row, then kernel 1's launches on that row. On CPU tensors they run :func:`fused_mlp_chain_reference`.

``act`` is ``"gelu_tanh"``, which both TPU prototypes compute (Mosaic has no
erf), or ``"gelu"``, the exact GELU that the resblock means and that
``ops.fused_mlp`` computes: with it the chunked MLP is the same function as
``ops.fused_mlp`` and the two kernels can be timed against each other.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

ACTS = ("gelu", "gelu_tanh")
_GEMM_ACT = {"gelu": 0, "gelu_tanh": 2}  # gemm_sm90.cuh's act_fn codes


def _act(a32: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu":
        return F.gelu(a32)
    return 0.5 * a32 * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (a32 + 0.044715 * a32 * a32 * a32)))


def fused_mlp_chain_reference(x, lnw, lnb, w1, b1, w2, b2,
                              act: str = "gelu_tanh", eps: float = 1e-5,
                              outproj: Optional[Tuple] = None):
    """Plain PyTorch version of the kernels' contract. x [M, D]; lnw, lnb
    [D]; w1 [D, H]; b1 [H]; w2 [H, D]; b2 [D]; ``outproj`` is None or
    (ctx [M, D], wo [D, D], bo [D]). LayerNorm in fp32 rounded to x.dtype;
    both products on x.dtype values with fp32 accumulation; b1 and the
    activation in fp32, rounded once to x.dtype; the residual row (with the
    out-projection: the fp32 row, not its rounding), b2 and the second
    product summed in fp32 and rounded once."""
    if act not in ACTS:
        raise ValueError(f"fused_mlp_chain: act must be one of {ACTS}, got {act!r}")
    dt = x.dtype
    row32 = x.float()
    if outproj is not None:
        ctx, wo, bo = outproj
        row32 = row32 + ctx.float() @ wo.to(dt).float() + bo.float()
    mean = row32.mean(-1, keepdim=True)
    rstd = torch.rsqrt((row32 - mean).square().mean(-1, keepdim=True) + eps)
    z = ((row32 - mean) * rstd * lnw.float() + lnb.float()).to(dt)
    a32 = z.float() @ w1.to(dt).float() + b1.float()
    h = _act(a32, act).to(dt)
    return (row32 + b2.float() + h.float() @ w2.to(dt).float()).to(dt)


def _check_cuda_args(x, lnw, lnb, w1, b1, w2, b2, act, outproj):
    if act not in ACTS:
        raise ValueError(f"fused_mlp_chain: act must be one of {ACTS}, got {act!r}")
    if x.dim() != 2:
        raise ValueError(f"fused_mlp_chain: x must be [M, D], got {tuple(x.shape)}")
    m, d = x.shape
    h = w1.shape[-1]
    bf, f32 = torch.bfloat16, torch.float32
    specs = [("x", x, (m, d), bf), ("w1", w1, (d, h), bf), ("w2", w2, (h, d), bf),
             ("lnw", lnw, (d,), f32), ("lnb", lnb, (d,), f32),
             ("b1", b1, (h,), f32), ("b2", b2, (d,), f32)]
    if outproj is not None:
        ctx, wo, bo = outproj
        specs += [("ctx", ctx, (m, d), bf), ("wo", wo, (d, d), bf),
                  ("bo", bo, (d,), f32)]
    for name, t, shape, dtype in specs:
        if t.device != x.device:
            raise ValueError(f"fused_mlp_chain: {name} is on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != dtype:
            raise ValueError(f"fused_mlp_chain: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_mlp_chain: {name} must be {shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_mlp_chain: {name} must be contiguous and "
                             "16-byte aligned")
    if d == 0 or h == 0 or d % 64 or h % 64:
        raise ValueError(f"fused_mlp_chain: D={d} and H={h} must be nonzero "
                         "multiples of 64")


def _launch(x, lnw, lnb, w1, b1, w2, b2, act, eps, outproj):
    _check_cuda_args(x, lnw, lnb, w1, b1, w2, b2, act, outproj)
    from vitlens_tpu_torch.ops import _build

    m, d = x.shape
    h = w1.shape[1]
    out = torch.empty_like(x)
    if m == 0:
        return out
    lib = _build.library()
    params = [lnw.data_ptr(), lnb.data_ptr(), w1.data_ptr(), b1.data_ptr(),
              w2.data_ptr(), b2.data_ptr()]
    tail = (m, d, h, _GEMM_ACT[act], float(eps), _build.stream_of(x))
    if outproj is None:  # kernel 1's entry point: scratch y [M, D], h [M, H]
        y = torch.empty((m, d), dtype=x.dtype, device=x.device)
        hid = torch.empty((m, h), dtype=x.dtype, device=x.device)
        err = lib.vitlens_fused_mlp_fwd(x.data_ptr(), *params, y.data_ptr(),
                                        hid.data_ptr(), out.data_ptr(), *tail)
    else:  # y [M, D] and h [M, H] bf16, then row32 [M, D] fp32
        work = torch.empty(2 * m * (d + h) + 4 * m * d, dtype=torch.uint8,
                           device=x.device)
        err = lib.vitlens_fused_attnout_mlp_fwd(
            x.data_ptr(), *(t.data_ptr() for t in outproj), *params,
            work.data_ptr(), out.data_ptr(), *tail)
    _build.check(err, "fused_mlp_chain")
    return out


def fused_mlp_chunked(x, lnw, lnb, w1, b1, w2, b2, act: str = "gelu_tanh",
                      eps: float = 1e-5) -> torch.Tensor:
    """x [M, D] -> x + b2 + act(LN(x) @ w1 + b1) @ w2.

    CPU tensors take :func:`fused_mlp_chain_reference`. CUDA tensors launch
    the kernels (counted in ``fused_mlp_chunked.launches``): x, w1, w2 bf16;
    lnw, lnb, b1, b2 fp32; all contiguous; D and H multiples of 64. Anything
    else raises."""
    if not x.is_cuda:
        return fused_mlp_chain_reference(x, lnw, lnb, w1, b1, w2, b2, act, eps)
    out = _launch(x, lnw, lnb, w1, b1, w2, b2, act, eps, None)
    fused_mlp_chunked.launches += 1
    return out


def fused_attnout_mlp(x, ctx, wo, bo, lnw, lnb, w1, b1, w2, b2,
                      act: str = "gelu_tanh", eps: float = 1e-5) -> torch.Tensor:
    """(x, ctx) [M, D] -> y + b2 + act(LN(y) @ w1 + b1) @ w2 with
    y = x + ctx @ wo + bo kept in fp32.

    CPU tensors take :func:`fused_mlp_chain_reference`. CUDA tensors launch
    the kernels (counted in ``fused_attnout_mlp.launches``): as
    :func:`fused_mlp_chunked`, with ctx and wo bf16 and bo fp32."""
    if not x.is_cuda:
        return fused_mlp_chain_reference(x, lnw, lnb, w1, b1, w2, b2, act, eps,
                                         outproj=(ctx, wo, bo))
    out = _launch(x, lnw, lnb, w1, b1, w2, b2, act, eps, (ctx, wo, bo))
    fused_attnout_mlp.launches += 1
    return out


fused_mlp_chunked.launches = 0
fused_attnout_mlp.launches = 0
