"""Lens-aware vision tower (port of vitlens_tpu/models/vit.py): audio and
point clouds.

    fbank or points -> adapter (+ adapter pos) -> Perceiver Lens -> prepend
    CLS -> + positional embedding -> ln_pre -> trunk -> CLS pool -> ln_post
    -> @ proj

Raw waveforms (the JAX package's on-device fbank), the PNSA point tokenizer
and the other modalities are not yet ported and raise
``NotImplementedError``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from vitlens_tpu_torch.adapters.tokenizers import AudioAdapter, PointTokenizer
from vitlens_tpu_torch.config import TowerConfig
from vitlens_tpu_torch.models.layers import (LayerNorm, Transformer, _param,
                                             normal_)
from vitlens_tpu_torch.models.perceiver import Perceiver


class VisionTower(nn.Module):
    def __init__(self, cfg: TowerConfig, device=None):
        super().__init__()
        if cfg.modality not in ("audio", "pc"):
            raise NotImplementedError(
                f"the {cfg.modality!r} tower is not yet ported")
        p = cfg.perceiver
        if p is None or p.as_identity or p.as_transformer:
            raise NotImplementedError(
                "only the cross-attending perceiver Lens is ported")
        self.cfg = cfg
        arch = cfg.arch
        width = arch.width
        if cfg.modality == "audio":
            self.adapter = AudioAdapter(cfg, device=device)
        else:
            self.adapter = PointTokenizer(cfg.point, device=device)
        self.perceiver = Perceiver(p, device=device)
        self.class_embedding = _param(width, device=device)
        self.positional_embedding = _param(cfg.num_tokens + 1, width,
                                           device=device)
        self.ln_pre = LayerNorm(width, device=device)
        self.trunk = Transformer(width, arch.layers, arch.heads, arch.mlp_ratio,
                                 arch.ls_init_value, cfg.quick_gelu,
                                 device=device)
        self.ln_post = LayerNorm(width, device=device)
        self.proj = _param(width, cfg.embed_dim, device=device)

    def init_(self, g: torch.Generator) -> None:
        scale = self.cfg.arch.width ** -0.5
        self.adapter.init_(g)
        self.perceiver.init_(g)
        normal_(self.class_embedding, scale, g)
        normal_(self.positional_embedding, scale, g)
        self.ln_pre.init_(g)
        self.trunk.init_(g)
        self.ln_post.init_(g)
        normal_(self.proj, scale, g)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32, *,
                train: bool = False, remat: bool = False):
        """x: fbank [B, target_length, mel_bins] or points [B, N, 3] ->
        features [B, embed_dim]. The input is cast to ``compute_dtype`` first,
        so FPS sees the rounded coordinates, as in JAX. ``remat`` recomputes
        the trunk's blocks in the backward pass. ``train`` marks a training
        pass: train-time patch dropout and the point tokenizer's batch
        BatchNorm and random FPS starts are not ported and raise."""
        if self.cfg.modality == "audio" and x.dim() != 3:
            raise NotImplementedError(
                "raw-waveform audio input (on-device fbank) is not yet ported; "
                "pass a [B, target_length, mel_bins] fbank")
        cfg = self.cfg
        if train and cfg.patch_dropout > 0:
            raise NotImplementedError(
                "train-time patch dropout (patch_dropout > 0) is not yet ported")
        if train and cfg.modality == "pc":
            raise NotImplementedError(
                "point-cloud training (batch BatchNorm, random FPS starts) is "
                "not yet ported")
        x = x.to(compute_dtype)
        tokens, pos = self.adapter(x)
        if cfg.use_adapter_pos:
            tokens = tokens + pos.to(tokens.dtype)
        tokens = self.perceiver(tokens)
        B, _, width = tokens.shape
        cls = self.class_embedding.to(tokens.dtype).expand(B, 1, width)
        h = torch.cat([cls, tokens], dim=1)
        if cfg.use_orig_pos:
            h = h + self.positional_embedding.to(h.dtype)
        h = self.ln_pre(h)
        h = self.trunk(h, skip_first_n=cfg.skip_first_n_layers, remat=remat)
        pooled = h.mean(dim=1) if cfg.arch.global_average_pool else h[:, 0]
        pooled = self.ln_post(pooled)
        return pooled @ self.proj.to(pooled.dtype)
