"""Lens tower + CLIP text tower (port of vitlens_tpu/models/tri.py).

The frozen CLIP image tower is not yet ported, so the port's model holds the
Lens ("visual") tower, the text tower and the logit scale. ``train`` and
``remat`` thread through the encode helpers as in JAX.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from vitlens_tpu_torch.config import ModelConfig
from vitlens_tpu_torch.models.text import TextTower
from vitlens_tpu_torch.models.vit import VisionTower


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize(dim=-1) equivalent, computed in fp32, cast back."""
    x32 = x.float()
    n = x32.square().sum(-1, keepdim=True).sqrt()
    return (x32 / n.clamp_min(eps)).to(x.dtype)


class TriModel(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.visual = VisionTower(cfg.tower, device=device)
        self.text = TextTower(cfg.text, cfg.embed_dim, cfg.quick_gelu,
                              device=device)
        self.logit_scale = nn.Parameter(torch.empty((), device=device),
                                        requires_grad=False)

    def init_(self, g: torch.Generator) -> None:
        self.visual.init_(g)
        self.text.init_(g)
        with torch.no_grad():
            self.logit_scale.fill_(math.log(1.0 / self.cfg.init_logit_scale_inv_temp))


def encode_visual(model: TriModel, x: torch.Tensor, *, normalize: bool = False,
                  train: bool = False, compute_dtype=torch.float32,
                  remat: bool = False) -> torch.Tensor:
    feats = model.visual(x, compute_dtype, train=train, remat=remat)
    return _l2_normalize(feats) if normalize else feats


def encode_text(model: TriModel, text: torch.Tensor, *, normalize: bool = False,
                compute_dtype=torch.float32, remat: bool = False) -> torch.Tensor:
    feats = model.text(text, compute_dtype, remat=remat)
    return _l2_normalize(feats) if normalize else feats
