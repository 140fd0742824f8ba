"""Linear probe on a frozen Lens backbone (port of
vitlens_tpu/models/linear_probe.py), and the LARS optimizer its trainer uses.

backbone (a frozen Lens ``VisionTower``; without ``enable_vit_proj`` it has
no projection and gives the pooled ``ln_post`` features) -> Dropout ->
BatchNorm1d(affine=False, eps 1e-6; running statistics with momentum 0.1 and
the unbiased variance) -> Linear(num_classes). Only the head trains: the
backbone runs under ``torch.no_grad()`` (JAX masks its gradients away, which
gives the same head). Parameter and buffer names are the JAX trees' (the
backbone's ``proj`` aside, which a probe without the projection lacks).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from vitlens_tpu_torch.config import TowerConfig
from vitlens_tpu_torch.models.layers import Linear
from vitlens_tpu_torch.models.vit import VisionTower

BN_EPS = 1e-6
BN_MOMENTUM = 0.1


class HeadBN(nn.Module):
    """BatchNorm1d(affine=False): running ``mean`` and ``var`` buffers."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.register_buffer("mean", torch.zeros(dim, device=device))
        self.register_buffer("var", torch.ones(dim, device=device))


def dropout(h: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Each element kept with probability 1 - rate (a uniform draw from
    ``generator`` below it) and scaled by 1 / (1 - rate), else 0."""
    keep = 1.0 - rate
    draw = torch.rand(h.shape, generator=generator, device=h.device)
    return torch.where(draw < keep, h / keep, torch.zeros_like(h))


class LinearProbe(nn.Module):
    def __init__(self, tower_cfg: TowerConfig, num_classes: int,
                 enable_vit_proj: bool = False, device=None):
        super().__init__()
        self.enable_vit_proj = enable_vit_proj
        self.backbone = VisionTower(tower_cfg, device=device, proj=enable_vit_proj)
        lp_dim = tower_cfg.embed_dim if enable_vit_proj else tower_cfg.arch.width
        self.lp_head = Linear(lp_dim, num_classes, device=device)
        self.head_bn = HeadBN(lp_dim, device=device)

    def init_(self, g: torch.Generator) -> None:
        self.backbone.init_(g)
        self.lp_head.init_(g)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32, *,
                train: bool = False, dropout_rate: float = 0.0,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x -> logits [B, num_classes] (fp32). ``train`` normalises with the
        batch statistics and moves the running ones; dropout (rate
        ``dropout_rate``, draws from ``dropout_generator``) acts in train
        mode only."""
        with torch.no_grad():
            feats = self.backbone(x, compute_dtype)
        h = feats.float()
        if train and dropout_rate > 0:
            h = dropout(h, dropout_rate, dropout_generator)
        bn = self.head_bn
        if train:
            mean = h.mean(0)
            var = h.square().mean(0) - mean.square()
            n = h.shape[0]
            with torch.no_grad():
                bn.mean.copy_((1 - BN_MOMENTUM) * bn.mean + BN_MOMENTUM * mean)
                bn.var.copy_((1 - BN_MOMENTUM) * bn.var
                             + BN_MOMENTUM * var * (n / max(n - 1, 1)))
        else:
            mean, var = bn.mean, bn.var
        h = (h - mean) * torch.rsqrt(var + BN_EPS)
        return h @ self.lp_head.w.float() + self.lp_head.b.float()


def softmax_cross_entropy_loss(logits: torch.Tensor,
                               labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    picked = logits.gather(-1, labels.long()[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - picked).mean()


class LARS:
    """``optax.lars(schedule, weight_decay, weight_decay_mask,
    trust_coefficient, trust_ratio_mask, momentum)`` (eps 0, no Nesterov),
    step for step in optax's order, over ``params`` {name: parameter}:
    u = g + wd * p (where ``decay[name]``); u *= trust_coefficient * |p| /
    |u| (where ``trust[name]`` and both norms are nonzero); u *= -lr(count);
    t = u + momentum * t; p += t. ``count`` starts at 0."""

    def __init__(self, params: Dict[str, torch.Tensor], schedule,
                 weight_decay: float, decay: Dict[str, bool],
                 trust_coefficient: float, trust: Dict[str, bool],
                 momentum: float = 0.9):
        self.params, self.schedule = params, schedule
        self.weight_decay, self.decay = weight_decay, decay
        self.trust_coefficient, self.trust = trust_coefficient, trust
        self.momentum = momentum
        self.trace = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        lr = float(self.schedule(self.count))
        for n, p in self.params.items():
            u = grads[n].float()
            if self.decay[n]:
                u = u + self.weight_decay * p
            if self.trust[n]:
                pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
                ratio = self.trust_coefficient * pn / un
                u = u * torch.where((pn == 0) | (un == 0), torch.ones_like(ratio),
                                    ratio)
            t = -lr * u + self.momentum * self.trace[n]
            self.trace[n] = t
            p.add_(t)
        self.count += 1


def lars_for_head(model: LinearProbe, schedule, weight_decay: float) -> LARS:
    """The trainer's LARS over the head (the backbone is frozen): weight
    decay and the trust ratio on the matrices only (ndim > 1), trust
    coefficient 0.001, momentum 0.9."""
    params = {n: p for n, p in model.lp_head.named_parameters()}
    nd = {n: p.dim() > 1 for n, p in params.items()}
    return LARS(params, schedule, weight_decay, nd, 0.001, nd, 0.9)

