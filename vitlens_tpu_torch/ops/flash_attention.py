"""Unmasked softmax attention: softmax(q @ k^T * scale) @ v.

On a CUDA tensor :func:`flash_attention` launches the hand-written Hopper
kernel in ``csrc/flash_attention.cu`` (the port of
``vitlens_tpu/ops/flash_attention.py::_fused_attention_fwd_impl``) or raises
on what the kernel does not take. The kernel reads q, k and v where they lie
(strided views, such as the packed qkv projection's) and writes its output
in [B, NQ, H, Dh] order. On a CPU tensor it runs
:func:`attention_reference`, the plain PyTorch version of the same contract:
fp32 scores, softmax and P @ V, rounded once to the input dtype.

Training follows the JAX package's ``custom_vjp``: the forward is the kernel
(or the plain version on the CPU), and the backward recomputes the
probabilities in fp32 from the saved q, k, v (the JAX ``_bwd``), on both
devices.
"""

from __future__ import annotations

from typing import Optional

import torch

from vitlens_tpu_torch.ops.custom import through_ops

# Head dims the kernel takes: multiples of 8 from 8 to 128 (it pads to 64
# or 128 columns in shared memory and stores only the true ones).
HEAD_DIMS = range(8, 129, 8)


def flash_attention_applicable(q: torch.Tensor) -> bool:
    """The dtype gate of ``ops.attention``: the kernel takes bf16; calls in
    any other dtype (the fp32 default) take the plain path, as the JAX
    package sends them to XLA. The wrapper itself still raises on a non-bf16
    CUDA tensor."""
    return q.dtype == torch.bfloat16


def attention_reference(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """q [B, H, NQ, Dh], k/v [B, H, NK, Dh] -> [B, H, NQ, Dh]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    return (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)


def _check_cuda_args(q, k, v, scale: Optional[float] = None):
    """Raises on what the kernel does not take. q, k, v may be views (the
    packed qkv projection's, a transposed [B, N, H, Dh]): the last dim must be
    contiguous, every other stride a multiple of 8 elements (16 bytes, as
    TMA reads rows) and not 0 on a dim of more than one entry (a broadcast
    view, such as an ``expand``ed query), and each base 16-byte aligned.
    The scale must be > 0 (the kernel takes the row max of the unscaled
    scores); it defaults to the head dim ** -0.5."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not scale > 0:
        raise ValueError(f"flash_attention: scale must be > 0, got {scale}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, H, N, Dh]")
    if k.shape != v.shape or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim must be a multiple of 8 "
                         f"from 8 to 128, got {q.shape[3]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention: {name} must be bfloat16, "
                             f"got {t.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s last dim must be "
                             f"contiguous, got stride {t.stride(3)}")
        if 0 in _strides(t):
            raise ValueError(f"flash_attention: {name} is a broadcast view "
                             f"(strides {tuple(t.stride())}): the kernel does "
                             "not read a stride of 0; pass a contiguous copy")
        if any(st % 8 for st in _strides(t)):
            raise ValueError(f"flash_attention: {name}'s strides "
                             f"{tuple(t.stride())} must be multiples of 8 "
                             "elements (16 bytes)")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte aligned")
    if k.shape[2] == 0:
        raise ValueError("flash_attention: no keys")


def _strides(t):
    """(batch, head, row) strides in elements; a dim of size 1 is never
    stepped, so its stride is reported as one row (the head dim)."""
    return tuple(st if n > 1 else t.shape[3]
                 for n, st in zip(t.shape[:3], t.stride()[:3]))


def _forward(q, k, v, scale: float) -> torch.Tensor:
    if not q.is_cuda:
        return attention_reference(q, k, v, scale)
    _check_cuda_args(q, k, v, scale)
    from vitlens_tpu_torch.ops import _build

    B, H, NQ, dh = q.shape
    out = torch.empty((B, NQ, H, dh), dtype=q.dtype, device=q.device)
    if B * H * NQ == 0:
        return out.transpose(1, 2)
    stream = _build.stream_of(q)
    err = _build.library().vitlens_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, NQ,
        k.shape[2], dh, *_strides(q), *_strides(k), *_strides(v), float(scale),
        stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out.transpose(1, 2)


def attention_backward(g, q, k, v, scale: float, needs=(True, True, True)):
    """The JAX ``_bwd``: probabilities recomputed in fp32; (dq, dk, dv), each
    None unless ``needs`` asks for it."""
    q32, k32, v32, g32 = q.float(), k.float(), v.float(), g.float()
    p = torch.softmax((q32 @ k32.transpose(-1, -2)) * scale, dim=-1)
    dv = (p.transpose(-1, -2) @ g32).to(v.dtype) if needs[2] else None
    dq = dk = None
    if needs[0] or needs[1]:
        dp = g32 @ v32.transpose(-1, -2)
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        if needs[0]:
            dq = ((ds @ k32) * scale).to(q.dtype)
        if needs[1]:
            dk = ((ds.transpose(-1, -2) @ q32) * scale).to(k.dtype)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*attention_backward(g, q, k, v, ctx.scale,
                                    ctx.needs_input_grad[:3]), None)


def flash_attention(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """q [B, H, NQ, Dh], k/v [B, H, NK, Dh] -> [B, H, NQ, Dh], no mask.

    CPU tensors take :func:`attention_reference`. CUDA tensors launch the
    kernel: bf16, a head dim that is a multiple of 8 from 8 to 128, views
    with a contiguous last dim and strides of 16 bytes (see
    :func:`_check_cuda_args`); the result is a [B, NQ, H, Dh] tensor seen as
    [B, H, NQ, Dh], so that ``out.transpose(1, 2).reshape(B, NQ, H * Dh)``
    is a view. Anything else raises. When autograd records and an input
    requires grad, this is :class:`FlashAttentionFunction`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if through_ops():  # a trace (ops/custom.py): the op, run forward only
        return torch.ops.vitlens.flash_attention(q, k, v, float(scale))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, scale)
    return _forward(q, k, v, scale)


flash_attention.launches = 0


@torch.library.custom_op("vitlens::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    return _forward(q, k, v, scale)


@_flash_attention_op.register_fake
def _(q, k, v, scale):
    B, H, NQ, dh = q.shape  # the kernel's [B, NQ, H, Dh] seen as [B, H, NQ, Dh]
    return q.new_empty((B, NQ, H, dh)).transpose(1, 2)
