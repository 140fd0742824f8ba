"""Modality adapters (port of vitlens_tpu/adapters/tokenizers.py).

Only the AST-style audio adapter is ported; the other modalities' adapters
are not yet ported.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vitlens_tpu_torch.config import TowerConfig
from vitlens_tpu_torch.models.layers import _param, normal_


class AudioAdapter(nn.Module):
    """Overlapping-patch strided conv over a log-mel fbank, plus its own
    positional embedding. ``conv1.w`` keeps the JAX OIHW layout
    [width, 1, p, p]; ``pos_emb`` is [num_patches, width]."""

    def __init__(self, cfg: TowerConfig, device=None):
        super().__init__()
        a = cfg.audio
        self.audio = a
        self.conv1 = nn.Module()
        self.conv1.w = _param(cfg.arch.width, 1, a.patch_size, a.patch_size,
                              device=device)
        self.pos_emb = _param(a.num_patches, cfg.arch.width, device=device)

    def init_(self, g: torch.Generator) -> None:
        normal_(self.conv1.w, (self.audio.patch_size ** 2) ** -0.5, g)
        normal_(self.pos_emb, self.pos_emb.shape[1] ** -0.5, g)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, T (target_length), F (mel_bins)] -> (tokens [B, fdim*tdim,
        width], pos_emb). The conv sees the fbank transposed to [B, 1, F, T]."""
        x = x.unsqueeze(1).transpose(2, 3)
        y = F.conv2d(x, self.conv1.w.to(x.dtype),
                     stride=(self.audio.fstride, self.audio.tstride))
        return y.flatten(2).transpose(1, 2), self.pos_emb
