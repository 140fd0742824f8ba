"""Core transformer building blocks (port of vitlens_tpu/models/layers.py).

Parameter names and layouts follow the JAX pytree so that
``weights/from_jax.py`` is a plain copy: matmul weights are [in, out], the
LayerNorm parameters are ``scale``/``bias``, attention keeps the packed
``qkv_w``. The stacked trunk (one leading [layers] axis in JAX) is an
``nn.ModuleList`` of blocks here.

Numerical contracts, as in JAX: LayerNorm in fp32 cast back; exact-erf GELU;
QuickGELU x * sigmoid(1.702 x); weights, biases and LayerNorm parameters cast
to the activation dtype at use (a no-op for frozen matmul weights, which the
factory casts to the compute dtype once at load; trainable ones stay fp32
masters and the cast carries their gradient).

A ``Linear`` or ``MHA`` quantized by ``quant.py`` holds int8 weights and
their scales as buffers in place of its float weight and sends its product
through ``quant.int8_matmul``; the dispatch is on the presence of ``w_q``, as
the JAX package dispatches on the key.

Each module's ``init_(g)`` fills its parameters from the ``torch.Generator``
``g`` with the JAX package's init distributions.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vitlens_tpu_torch.ops.attention import dot_product_attention
from vitlens_tpu_torch.ops.fused_ln_proj import (fused_ln_proj_applicable,
                                                 fused_ln_proj_available,
                                                 fused_ln_qkv)
from vitlens_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_applicable
from vitlens_tpu_torch.quant import int8_matmul

# Leaf names of the parameters that feed a matmul or a convolution: the
# factory casts exactly these to the compute dtype once, at load.
MATMUL_WEIGHTS = frozenset({"w", "qkv_w", "out_w", "proj", "text_projection"})


def _param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device), requires_grad=False)


def _quant_slots(module: nn.Module, name: str) -> None:
    """Empty buffers for the int8 form of the weight ``name``: ``<name>_q``
    (int8 [K, N]), ``<name>_s`` (fp32 [1, N]) and ``<name>_qt`` (int8 [N, K],
    what the CUDA kernel reads). ``quant.py`` fills them."""
    for suffix in ("_q", "_s", "_qt"):
        module.register_buffer(name + suffix, None)


def normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    with torch.no_grad():
        t.normal_(0.0, std, generator=g)


def uniform_(t: torch.Tensor, bound: float, g: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=g)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, fp32 compute, cast back to x.dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = _param(dim, device=device)
        self.bias = _param(dim, device=device)

    def init_(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, self.eps)


class Linear(nn.Module):
    """y = x @ w + b with w [in, out]."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, device=None):
        super().__init__()
        self.w = _param(d_in, d_out, device=device)
        self.b = _param(d_out, device=device) if bias else None
        _quant_slots(self, "w")

    def init_(self, g: torch.Generator) -> None:
        """torch nn.Linear's default init, in the [in, out] layout."""
        fan_in = self.w.shape[0]
        uniform_(self.w, math.sqrt(1.0 / fan_in) * math.sqrt(3.0), g)
        if self.b is not None:
            uniform_(self.b, 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0, g)

    def forward(self, x):
        if self.w_q is not None:  # int8-quantized (quant.py)
            return int8_matmul(x, self.w_q, self.w_s, self.b, self.w_qt)
        y = x @ self.w.to(x.dtype)
        if self.b is not None:
            y = y + self.b.to(x.dtype)
        return y


class MHA(nn.Module):
    """Self-attention on [B, N, D] with a packed qkv projection
    (torch nn.MultiheadAttention semantics)."""

    def __init__(self, dim: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.qkv_w = _param(dim, 3 * dim, device=device)
        self.qkv_b = _param(3 * dim, device=device)
        self.out_w = _param(dim, dim, device=device)
        self.out_b = _param(dim, device=device)
        _quant_slots(self, "qkv_w")
        _quant_slots(self, "out_w")

    def init_(self, g: torch.Generator) -> None:
        dim = self.out_w.shape[0]
        # xavier_uniform_ over the packed [3*dim, dim] in_proj weight
        uniform_(self.qkv_w, math.sqrt(6.0 / (dim + 3 * dim)), g)
        uniform_(self.out_w, math.sqrt(1.0 / dim) * math.sqrt(3.0), g)
        with torch.no_grad():
            self.qkv_b.zero_()
            self.out_b.zero_()

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        if self.qkv_w_q is not None:  # int8-quantized (quant.py)
            qkv = int8_matmul(x, self.qkv_w_q, self.qkv_w_s, self.qkv_b,
                              self.qkv_w_qt)
        else:
            qkv = x @ self.qkv_w.to(x.dtype) + self.qkv_b.to(x.dtype)
        return self.from_qkv(qkv, mask)

    def from_qkv(self, qkv, mask: Optional[torch.Tensor] = None):
        """Attention and the out-projection given the packed [B, N, 3D]
        projection (JAX ``_attn_from_qkv``)."""
        B, N, D3 = qkv.shape
        D = D3 // 3
        # q, k, v are strided views of the packed projection (the kernel
        # reads them in place) and the kernel's output is [B, N, H, Dh] seen
        # as [B, H, N, Dh], so the reshape back to [B, N, D] is a view too.
        q, k, v = qkv.view(B, N, 3, self.heads, D // self.heads).permute(2, 0, 3, 1, 4)
        o = dot_product_attention(q, k, v, mask=mask)
        o = o.transpose(1, 2).reshape(B, N, D)
        if self.out_w_q is not None:  # int8-quantized (quant.py)
            return int8_matmul(o, self.out_w_q, self.out_w_s, self.out_b,
                               self.out_w_qt)
        return o @ self.out_w.to(qkv.dtype) + self.out_b.to(qkv.dtype)


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc = Linear(dim, hidden, device=device)
        self.proj = Linear(hidden, dim, device=device)

    def init_(self, g: torch.Generator) -> None:
        self.fc.init_(g)
        self.proj.init_(g)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float, device=None):
        super().__init__()
        self.init_value = init_value
        self.gamma = _param(dim, device=device)

    def init_(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.gamma.fill_(self.init_value)

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class ResBlock(nn.Module):
    """Pre-LN residual attention block. The MLP half of a bf16 block goes
    through ``ops.fused_mlp`` (the kernel on CUDA); a block in another dtype
    (``fused_mlp_applicable``) or with layer-scale takes the plain
    composition, as in JAX, since the kernel takes bf16 and has no
    layer-scale.
    With ``VITLENS_ENABLE_FUSED_LNQKV`` set, the front half (ln_1 + the
    packed qkv projection) goes through ``ops.fused_ln_proj`` where it
    applies (bf16, widths multiples of 128), as in JAX. A quantized block
    (``quant.quantize_resblocks``) takes the plain composition for both
    halves, as in JAX: neither kernel reads int8 weights."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0,
                 ls_init_value: Optional[float] = None,
                 quick: bool = False, device=None):
        super().__init__()
        self.act = "quick_gelu" if quick else "gelu"
        self.ln_1 = LayerNorm(dim, device=device)
        self.attn = MHA(dim, heads, device=device)
        self.ln_2 = LayerNorm(dim, device=device)
        self.mlp = MLP(dim, int(dim * mlp_ratio), device=device)
        if ls_init_value is not None:
            self.ls_1 = LayerScale(dim, ls_init_value, device=device)
            self.ls_2 = LayerScale(dim, ls_init_value, device=device)
        else:
            self.ls_1 = self.ls_2 = None

    def init_(self, g: torch.Generator) -> None:
        for m in (self.ln_1, self.attn, self.ln_2, self.mlp, self.ls_1,
                  self.ls_2):
            if m is not None:
                m.init_(g)

    @property
    def quantized(self) -> bool:
        return self.attn.qkv_w_q is not None

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        if (not self.quantized and fused_ln_proj_available()
                and fused_ln_proj_applicable(x, self.attn.qkv_w)):
            a = self.attn.from_qkv(fused_ln_qkv(x, self.ln_1, self.attn), mask)
        else:
            a = self.attn(self.ln_1(x), mask)
        if self.ls_1 is not None:
            a = self.ls_1(a)
        x = x + a
        if (self.ls_2 is not None or self.mlp.fc.w_q is not None
                or not fused_mlp_applicable(x)):
            act = quick_gelu if self.act == "quick_gelu" else gelu
            h = self.mlp.proj(act(self.mlp.fc(self.ln_2(x))))
            return x + (h if self.ls_2 is None else self.ls_2(h))
        d = x.shape[-1]
        fc, proj = self.mlp.fc, self.mlp.proj
        out = fused_mlp(x.reshape(-1, d), self.ln_2.scale.float(),
                        self.ln_2.bias.float(), fc.w.to(x.dtype), fc.b.float(),
                        proj.w.to(x.dtype), proj.b.float(), self.act,
                        self.ln_2.eps)
        return out.reshape(x.shape)


class Transformer(nn.Module):
    """A stack of residual blocks (JAX: stacked params under ``blocks``)."""

    def __init__(self, dim: int, layers: int, heads: int,
                 mlp_ratio: float = 4.0, ls_init_value: Optional[float] = None,
                 quick: bool = False, device=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            ResBlock(dim, heads, mlp_ratio, ls_init_value, quick, device=device)
            for _ in range(layers))

    def init_(self, g: torch.Generator) -> None:
        for b in self.blocks:
            b.init_(g)

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                skip_first_n: Optional[int] = None, remat: bool = False):
        """``skip_first_n`` drops the first N blocks (the vitlensG recipe).
        ``remat=True`` recomputes each block's activations in the backward
        pass (JAX ``jax.checkpoint`` of the scan body) with non-reentrant
        ``torch.utils.checkpoint``; it only acts while autograd records."""
        if remat not in (False, True):
            raise NotImplementedError(
                f"remat={remat!r}: only full remat (True) is ported; the "
                "'dots' policy is not")
        for b in self.blocks[skip_first_n or 0:]:
            if remat and torch.is_grad_enabled():
                x = checkpoint(b, x, mask, use_reentrant=False)
            else:
                x = b(x, mask)
        return x
