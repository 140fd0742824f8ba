"""Modality adapters (port of vitlens_tpu/adapters/tokenizers.py).

The image/tactile patch embedding (and the video tower's, with its learned
temporal positions), the 1-channel depth patch embedding, the EEG Conv1d
patch embedding, the AST-style audio adapter, the PointBERT point tokenizer
and the PNSA point tokenizer (OpenShape's set abstraction, the vitlensG pc
tower's). Both point tokenizers take JAX's ``train`` flag: batch statistics
in their BatchNorms (the running ones updated in place) and FPS from the
given starts or generator.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vitlens_tpu_torch.config import PointAdapterConfig, TowerConfig
from vitlens_tpu_torch.models.layers import (LayerNorm, Linear, _param, gelu,
                                             normal_)
from vitlens_tpu_torch.ops.fps import ball_query, fps, group_points, take_points
from vitlens_tpu_torch.ops.fused_point_encoder import (
    BN_EPS, fused_point_encoder, mini_pointnet, point_encoder_applicable,
    point_encoder_reference)
from vitlens_tpu_torch.parallel.mesh import all_reduce_mean

BN_MOMENTUM = 0.1  # JAX's batch_norm default; no caller sets another


def patchify_2d(x: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, (H/p)*(W/p), C*p*p], flattened in (c, ph, pw)
    order: the same as a conv with kernel = stride = patch."""
    B, C, H, W = x.shape
    gh, gw = H // patch, W // patch
    x = x.reshape(B, C, gh, patch, gw, patch).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, gh * gw, C * patch * patch)


class ImageAdapter(nn.Module):
    """Patch embedding of the image and tactile towers as patchify + one
    product. ``conv1.w`` keeps the JAX layout [C*p*p, width], so
    ``weights/from_jax.py`` copies it unchanged. No adapter positional
    embedding: the ViT's own covers the image path."""

    def __init__(self, cfg: TowerConfig, device=None):
        super().__init__()
        self.patch = cfg.arch.patch_size
        self.conv1 = nn.Module()
        self.conv1.w = _param(3 * self.patch ** 2, cfg.arch.width,
                              device=device)

    def init_(self, g: torch.Generator) -> None:
        normal_(self.conv1.w, self.conv1.w.shape[0] ** -0.5, g)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, None]:
        """x [B, 3, H, W] -> (tokens [B, grid^2, width], None)."""
        return patchify_2d(x, self.patch) @ self.conv1.w.to(x.dtype), None


class VideoAdapter(ImageAdapter):
    """The image patch embedding applied frame by frame, plus the learned
    temporal position ``ltpos`` [n_frames, width] (JAX keeps it in the
    adapter's tree; absent when ``use_ltpos`` is off). The tower adds
    ``ltpos`` and the spatial positions per frame (``VisionTower``)."""

    def __init__(self, cfg: TowerConfig, device=None):
        super().__init__(cfg, device=device)
        self.ltpos = (_param(cfg.video.n_frames, cfg.arch.width, device=device)
                      if cfg.video.use_ltpos else None)

    def init_(self, g: torch.Generator) -> None:
        super().init_(g)
        if self.ltpos is not None:
            normal_(self.ltpos, 0.02, g)


class DepthAdapter(nn.Module):
    """1-channel patch embedding (patchify + one product, ``conv1.w``
    [p*p, width]) with its own positional embedding ``pos_emb``
    [num_patches, width]."""

    def __init__(self, cfg: TowerConfig, device=None):
        super().__init__()
        self.patch = cfg.arch.patch_size
        self.conv1 = nn.Module()
        self.conv1.w = _param(self.patch ** 2, cfg.arch.width, device=device)
        self.pos_emb = _param(cfg.arch.num_patches, cfg.arch.width,
                              device=device)

    def init_(self, g: torch.Generator) -> None:
        normal_(self.conv1.w, self.conv1.w.shape[0] ** -0.5, g)
        normal_(self.pos_emb, self.pos_emb.shape[1] ** -0.5, g)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, 1, H, W] -> (tokens [B, grid^2, width], pos_emb)."""
        return patchify_2d(x, self.patch) @ self.conv1.w.to(x.dtype), self.pos_emb


class EEGAdapter(nn.Module):
    """Conv1d patch embedding over time, as a product: ``proj.w``
    [chans * window, width] flattened chans-major (the layout of torch's
    Conv1d weight [width, chans, window] reshaped), plus ``pos_emb``
    [num_patches, width]. With the released window 1 and stride 1 it is one
    product over the channels."""

    def __init__(self, cfg: TowerConfig, device=None):
        super().__init__()
        e = self.eeg = cfg.eeg
        self.proj = Linear(e.chans * e.window_size, cfg.arch.width,
                           device=device)
        self.pos_emb = _param(e.num_patches, cfg.arch.width, device=device)

    def init_(self, g: torch.Generator) -> None:
        self.proj.init_(g)
        normal_(self.pos_emb, self.pos_emb.shape[1] ** -0.5, g)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, chans, time] -> (tokens [B, num_patches, width], pos_emb)."""
        e = self.eeg
        if e.window_size == 1 and e.stride == 1:
            return self.proj(x.transpose(1, 2)), self.pos_emb
        # windows [B, chans, n, window] -> [B, n, chans * window], chans-major
        w = x[..., :(e.num_patches - 1) * e.stride + e.window_size]
        w = w.unfold(2, e.window_size, e.stride).permute(0, 2, 1, 3)
        return self.proj(w.reshape(x.shape[0], e.num_patches, -1)), self.pos_emb


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


class BatchNorm(nn.Module):
    """BatchNorm over the last axis: ``scale`` and ``bias`` are parameters,
    the running ``mean`` and ``var`` buffers (JAX keeps them in the state
    tree; ``weights.from_jax.load_state`` copies them). ``sync`` is the data
    mesh whose ranks share the batch statistics in train mode (JAX's
    ``bn_axis_name``; set it for a step with :func:`batch_norm_synced`), or
    None."""

    def __init__(self, dim: int, eps: float = BN_EPS, device=None):
        super().__init__()
        self.eps = eps
        self.sync = None
        self.scale = _param(dim, device=device)
        self.bias = _param(dim, device=device)
        self.register_buffer("mean", torch.empty(dim, device=device))
        self.register_buffer("var", torch.empty(dim, device=device))

    def init_(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def stats(self) -> Tuple[torch.Tensor, ...]:
        return self.mean, self.var, self.scale, self.bias

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Eval: the running statistics. Train: JAX's ``batch_norm(train=
        True)``, the fp32 mean and E[x^2] over every axis but the last (the
        gradient flows through both), var = E[x^2] - mean^2; the running
        mean and var move by BN_MOMENTUM towards the batch's mean and
        unbiased var (var * n / (n - 1)). Both in fp32, rounded back to x's
        dtype. Synced, the moments (not per-rank variances) are averaged
        over the ranks in one differentiable all-reduce of the stacked
        [mean, E[x^2]] pair, and n counts every rank's rows."""
        x32 = x.float()
        if not train:
            mean, var = self.mean.float(), self.var.float()
        else:
            axes = tuple(range(x.dim() - 1))
            mean = x32.mean(dim=axes)
            ex2 = x32.square().mean(dim=axes)
            n = x.numel() // x.shape[-1]
            if self.sync is not None:
                mean, ex2 = all_reduce_mean(torch.stack([mean, ex2]), self.sync)
                n *= self.sync.data
            var = ex2 - mean.square()
            m = BN_MOMENTUM
            with torch.no_grad():
                self.mean.copy_((1 - m) * self.mean + m * mean)
                self.var.copy_((1 - m) * self.var + m * (var * (n / max(n - 1, 1))))
        inv = torch.rsqrt(var + self.eps) * self.scale.float()
        return ((x32 - mean) * inv + self.bias.float()).to(x.dtype)


@contextlib.contextmanager
def batch_norm_synced(module: nn.Module, mesh):
    """Every BatchNorm of ``module`` syncs its train-mode statistics over
    ``mesh`` inside the block (None: each rank its own, as DDP without
    SyncBatchNorm); restored on exit."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    saved = [bn.sync for bn in bns]
    for bn in bns:
        bn.sync = mesh
    try:
        yield
    finally:
        for bn, s in zip(bns, saved):
            bn.sync = s


class PointTokenizer(nn.Module):
    """PointBERT tokenizer: FPS centers and kNN groups, the mini-PointNet
    per group, ``reduce_dim`` to the token width, and an MLP of the centers
    as the adapter's positional embedding. Module names follow the JAX param
    tree (``encoder.conv1..4``, ``encoder.bn1/bn2``, ``reduce_dim``,
    ``pos_embed.fc1/fc2``).

    Eval: the mini-PointNet is ``ops.fused_point_encoder`` (the kernel on
    CUDA) for the groups its gate takes, else its plain version, as in JAX.
    Train: the plain mini-PointNet with batch BatchNorm; the kernel is
    eval-only, as JAX's is."""

    def __init__(self, cfg: PointAdapterConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e = self.encoder = nn.Module()
        e.conv1 = Linear(3, 128, device=device)
        e.conv2 = Linear(128, 256, device=device)
        e.conv3 = Linear(512, 512, device=device)
        e.conv4 = Linear(512, cfg.encoder_dims, device=device)
        e.bn1 = BatchNorm(128, device=device)
        e.bn2 = BatchNorm(512, device=device)
        self.reduce_dim = Linear(cfg.encoder_dims, cfg.trans_dim, device=device)
        self.pos_embed = nn.Module()
        self.pos_embed.fc1 = Linear(3, 128, device=device)
        self.pos_embed.fc2 = Linear(128, cfg.trans_dim, device=device)

    def init_(self, g: torch.Generator) -> None:
        e = self.encoder
        for m in (e.conv1, e.conv2, e.conv3, e.conv4, self.reduce_dim,
                  self.pos_embed.fc1, self.pos_embed.fc2, e.bn1, e.bn2):
            m.init_(g)

    def forward(self, pts: torch.Tensor, train: bool = False,
                start: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """pts [B, N, 3] -> (tokens [B, G, trans_dim], pos [B, G, trans_dim]).
        FPS starts at ``start`` [B], or draws from ``generator``, or starts
        at point 0 (JAX's eval)."""
        cfg, e = self.cfg, self.encoder
        nb, center = group_points(pts, cfg.num_group, cfg.group_size,
                                  start=start, generator=generator)
        if train:
            feat = mini_pointnet(
                nb, e.conv1.w, e.conv1.b, functools.partial(e.bn1, train=True),
                e.conv2.w, e.conv2.b, e.conv3.w, e.conv3.b,
                functools.partial(e.bn2, train=True), e.conv4.w, e.conv4.b)
        else:
            takes = point_encoder_applicable(nb, e.conv1.w, e.conv2.w,
                                             e.conv3.w, e.conv4.w)
            encoder = fused_point_encoder if takes else point_encoder_reference
            feat = encoder(
                nb, e.conv1.w, e.conv1.b, e.bn1.stats(), e.conv2.w, e.conv2.b,
                e.conv3.w, e.conv3.b, e.bn2.stats(), e.conv4.w, e.conv4.b,
                e.bn1.eps)
        tokens = self.reduce_dim(feat)
        fc1, fc2 = self.pos_embed.fc1, self.pos_embed.fc2
        return tokens, fc2(gelu(fc1(center.to(tokens.dtype))))


class PNSATokenizer(nn.Module):
    """PNSA tokenizer (OpenShape's set abstraction, the vitlensG pc tower):
    FPS centers, ball-query groups of ``group_size`` within ``radius``,
    [grouped xyz - center ; grouped features] through a shared MLP (three
    pointwise products of widths 64, 64 and ``encoder_dims``, each with
    BatchNorm and ReLU), a max-pool over the group, then ``lift``: a
    pointwise product of [center ; feature] to ``trans_dim`` and a
    LayerNorm. Plain PyTorch: JAX has no kernel on this path but FPS. Module
    names follow the JAX tree (``sa.{i}.conv``, ``sa.{i}.bn``,
    ``lift.conv``, ``lift.ln``)."""

    def __init__(self, cfg: PointAdapterConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.sa = nn.ModuleList()
        last = cfg.in_channel + 3
        for out in (64, 64, cfg.encoder_dims):
            layer = nn.Module()
            layer.conv = Linear(last, out, device=device)
            layer.bn = BatchNorm(out, device=device)
            self.sa.append(layer)
            last = out
        self.lift = nn.Module()
        self.lift.conv = Linear(cfg.encoder_dims + 3, cfg.trans_dim,
                                device=device)
        self.lift.ln = LayerNorm(cfg.trans_dim, device=device)

    def init_(self, g: torch.Generator) -> None:
        for layer in self.sa:
            layer.conv.init_(g)
            layer.bn.init_(g)
        self.lift.conv.init_(g)
        self.lift.ln.init_(g)

    def forward(self, features: torch.Tensor, xyz: torch.Tensor,
                train: bool = False, start: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, None]:
        """features [B, N, in_channel] (xyz + rgb for vitlensG), xyz [B, N, 3]
        -> (tokens [B, G, trans_dim], None). FPS starts as in
        :class:`PointTokenizer`."""
        cfg = self.cfg
        center = fps(xyz, cfg.num_group, start=start, generator=generator)
        idx = ball_query(xyz, center, cfg.radius, cfg.group_size)
        # one gather over [xyz ; features], as JAX takes it
        dt = torch.promote_types(xyz.dtype, features.dtype)
        grouped = take_points(torch.cat([xyz.to(dt), features.to(dt)], -1), idx)
        h = torch.cat([grouped[..., :3] - center[:, :, None, :],
                       grouped[..., 3:]], -1)
        for layer in self.sa:
            h = torch.relu(layer.bn(layer.conv(h), train=train))
        feat = h.amax(dim=2)
        lifted = self.lift.conv(torch.cat([center.to(feat.dtype), feat], -1))
        return self.lift.ln(lifted), None
