"""Perceiver "Lens" and the PointPerceiver head (port of
vitlens_tpu/models/perceiver.py).

depth x [cross-attention(latents <- tokens) + GEGLU FF
         + self_per_cross_attn x (self-attention + GEGLU FF)]
with pre-norm (a separate LayerNorm on the context), residuals outside the
normed function, and learned latents [num_latents, latent_dim]. Attention goes
through ``ops.attention`` (unmasked: the kernel on CUDA).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from vitlens_tpu_torch.config import PerceiverConfig
from vitlens_tpu_torch.models.layers import (LayerNorm, Linear, _param, gelu,
                                             normal_, uniform_)
from vitlens_tpu_torch.ops.attention import dot_product_attention


def _xavier_(t: torch.Tensor, g: torch.Generator) -> None:
    uniform_(t, math.sqrt(6.0 / (t.shape[0] + t.shape[1])), g)


class Attention(nn.Module):
    """to_q / to_kv without bias, to_out with bias."""

    def __init__(self, query_dim: int, context_dim: int, heads: int,
                 dim_head: int, device=None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(query_dim, inner, bias=False, device=device)
        self.to_kv = Linear(context_dim, 2 * inner, bias=False, device=device)
        self.to_out = Linear(inner, query_dim, device=device)

    def init_(self, g: torch.Generator) -> None:
        _xavier_(self.to_q.w, g)
        _xavier_(self.to_kv.w, g)
        _xavier_(self.to_out.w, g)
        with torch.no_grad():
            self.to_out.b.zero_()

    def forward(self, x, context):
        B, Nq, _ = x.shape
        Nk = context.shape[1]
        h, dh = self.heads, self.dim_head
        # Views, read in place by the kernel; its output's reshape is a view.
        q = self.to_q(x).view(B, Nq, h, dh).transpose(1, 2)
        k, v = self.to_kv(context).view(B, Nk, 2, h, dh).permute(2, 0, 3, 1, 4)
        o = dot_product_attention(q, k, v, scale=dh ** -0.5)
        return self.to_out(o.transpose(1, 2).reshape(B, Nq, h * dh))


class GEGLU(nn.Module):
    """fc to 2 * mult * dim, a * gelu(gates), proj back to dim."""

    def __init__(self, dim: int, mult: int, device=None):
        super().__init__()
        self.fc = Linear(dim, dim * mult * 2, device=device)
        self.proj = Linear(dim * mult, dim, device=device)

    def init_(self, g: torch.Generator) -> None:
        _xavier_(self.fc.w, g)
        _xavier_(self.proj.w, g)
        with torch.no_grad():
            self.fc.b.zero_()
            self.proj.b.zero_()

    def forward(self, x):
        a, gates = self.fc(x).chunk(2, dim=-1)
        return self.proj(a * gelu(gates))


class CrossAttn(nn.Module):
    def __init__(self, cfg: PerceiverConfig, device=None):
        super().__init__()
        self.ln_q = LayerNorm(cfg.latent_dim, device=device)
        self.ln_kv = LayerNorm(cfg.input_dim, device=device)
        self.attn = Attention(cfg.latent_dim, cfg.input_dim, cfg.cross_heads,
                              cfg.cross_dim_head, device=device)

    def init_(self, g):
        for m in (self.ln_q, self.ln_kv, self.attn):
            m.init_(g)

    def forward(self, x, tokens):
        return self.attn(self.ln_q(x), self.ln_kv(tokens))


class NormedFF(nn.Module):
    def __init__(self, dim: int, mult: int, device=None):
        super().__init__()
        self.ln = LayerNorm(dim, device=device)
        self.ff = GEGLU(dim, mult, device=device)

    def init_(self, g):
        self.ln.init_(g)
        self.ff.init_(g)

    def forward(self, x):
        return self.ff(self.ln(x))


class SelfBlock(nn.Module):
    def __init__(self, cfg: PerceiverConfig, device=None):
        super().__init__()
        d = cfg.latent_dim
        self.attn_ln = LayerNorm(d, device=device)
        self.attn = Attention(d, d, cfg.latent_heads, cfg.latent_dim_head,
                              device=device)
        self.ff_ln = LayerNorm(d, device=device)
        self.ff = GEGLU(d, cfg.ff_mult, device=device)

    def init_(self, g):
        for m in (self.attn_ln, self.attn, self.ff_ln, self.ff):
            m.init_(g)

    def forward(self, x):
        normed = self.attn_ln(x)
        x = x + self.attn(normed, normed)
        return x + self.ff(self.ff_ln(x))


class PerceiverLayer(nn.Module):
    def __init__(self, cfg: PerceiverConfig, device=None):
        super().__init__()
        self.cross_attn = CrossAttn(cfg, device=device)
        self.cross_ff = NormedFF(cfg.latent_dim, cfg.ff_mult, device=device)
        self.self_blocks = nn.ModuleList(
            SelfBlock(cfg, device=device) for _ in range(cfg.self_per_cross_attn))

    def init_(self, g):
        self.cross_attn.init_(g)
        self.cross_ff.init_(g)
        for b in self.self_blocks:
            b.init_(g)

    def forward(self, x, tokens):
        x = x + self.cross_attn(x, tokens)
        x = x + self.cross_ff(x)
        for b in self.self_blocks:
            x = b(x)
        return x


class Perceiver(nn.Module):
    """Compress [B, N, input_dim] tokens to [B, num_latents, latent_dim]."""

    def __init__(self, cfg: PerceiverConfig, device=None):
        super().__init__()
        if cfg.fourier_encode_data:
            raise NotImplementedError(
                "fourier_encode_data is off in all released ViT-Lens configs")
        self.cfg = cfg
        self.latents = _param(cfg.num_latents, cfg.latent_dim, device=device)
        n_unique = 1 if cfg.weight_tie_layers else cfg.depth
        self.layers = nn.ModuleList(
            PerceiverLayer(cfg, device=device) for _ in range(n_unique))

    def init_(self, g: torch.Generator) -> None:
        normal_(self.latents, 1.0, g)
        for layer in self.layers:
            layer.init_(g)

    def forward(self, tokens):
        B = tokens.shape[0]
        x = self.latents.to(tokens.dtype).unsqueeze(0).expand(
            (B,) + tuple(self.latents.shape))
        for i in range(self.cfg.depth):
            x = self.layers[0 if self.cfg.weight_tie_layers else i](x, tokens)
        return x


class PointPerceiver(nn.Module):
    """The standalone point-cloud head (JAX ``point_perceiver_init`` /
    ``point_perceiver_apply``; reference PointPerceiver, perceiver.py:335-
    366): the Perceiver, the mean over its latents, a LayerNorm and
    ``@ proj``. The tokens come from a point tokenizer run separately."""

    def __init__(self, cfg: PerceiverConfig, embed_dim: int, device=None):
        super().__init__()
        self.perceiver = Perceiver(cfg, device=device)
        self.layer_norm = LayerNorm(cfg.latent_dim, device=device)
        self.proj = _param(cfg.latent_dim, embed_dim, device=device)

    def init_(self, g: torch.Generator) -> None:
        self.perceiver.init_(g)
        self.layer_norm.init_(g)
        normal_(self.proj, self.proj.shape[0] ** -0.5, g)

    def forward(self, tokens):
        """tokens [B, N, input_dim] -> [B, embed_dim]."""
        x = self.layer_norm(self.perceiver(tokens).mean(dim=1))
        return x @ self.proj.to(x.dtype)
