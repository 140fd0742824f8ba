"""Lens-aware vision tower (port of vitlens_tpu/models/vit.py): images,
tactile frames, depth maps, audio, EEG, video and point clouds.

    input -> adapter (+ adapter pos) -> Lens -> prepend CLS -> + positional
    embedding -> ln_pre -> trunk -> CLS pool -> ln_post -> @ proj

The Lens is a Perceiver (cross-attention onto latents), a plain transformer
at trunk width (``as_transformer``), the identity (``as_identity``: tokens
pass straight through) or absent (the image and tactile towers). Video
frames [B, T, 3, H, W] go through the image patch embedding frame by frame;
each frame's tokens get the learned temporal position of their frame and,
whenever a Lens is configured (the identity included), the spatial
positional embedding; the frames are then flattened into one sequence.

A raw waveform [B, samples] into the audio tower goes through the Kaldi
fbank on its own device, in fp32, before the cast to the compute dtype. A
point cloud goes through the PointBERT tokenizer (vitlensL) or the PNSA
tokenizer (vitlensG), whose features are the whole cloud when its width is
the tokenizer's ``in_channel`` (OpenShape feeds xyz + rgb) and the channels
after xyz otherwise, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from vitlens_tpu_torch.adapters.tokenizers import (AudioAdapter, DepthAdapter,
                                                  EEGAdapter, ImageAdapter,
                                                  PNSATokenizer, PointTokenizer,
                                                  VideoAdapter)
from vitlens_tpu_torch.config import TowerConfig
from vitlens_tpu_torch.models.layers import (LayerNorm, Transformer, _param,
                                             normal_)
from vitlens_tpu_torch.models.perceiver import Perceiver
from vitlens_tpu_torch.ops.fbank import fbank_fixed_length


def draw_patch_keep(cfg: TowerConfig, batch: int,
                    generator: torch.Generator) -> torch.Tensor:
    """Train-time patch dropout's draw (reference transformer.py:53-90, JAX
    ``vision_tower_apply``): the indices [batch, keep] of the patches each
    sample keeps, ``keep = max(1, int(n * (1 - patch_dropout)))`` of the
    tower's ``n`` patch tokens, the top ``keep`` of a standard normal draw
    from ``generator`` (on its device): distinct, ordered by their draws,
    the largest first, as ``lax.top_k`` orders them."""
    n = cfg.num_tokens
    keep = max(1, int(n * (1.0 - cfg.patch_dropout)))
    rand = torch.randn((batch, n), generator=generator, device=generator.device)
    return torch.topk(rand, keep, dim=1).indices


def apply_patch_dropout(h: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """h [B, 1 + n, D] (CLS first) -> [B, 1 + keep, D]: CLS, then the patches
    at ``keep`` [B, keep] in that order (JAX's ``take_along_axis``)."""
    idx = keep.to(h.device, torch.long)[..., None].expand(-1, -1, h.shape[-1])
    return torch.cat([h[:, :1], torch.gather(h[:, 1:], 1, idx)], dim=1)


_ADAPTERS = {"image": ImageAdapter, "tactile": ImageAdapter,
             "video": VideoAdapter, "depth": DepthAdapter,
             "audio": AudioAdapter, "eeg": EEGAdapter}


class VisionTower(nn.Module):
    def __init__(self, cfg: TowerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        arch = cfg.arch
        width = arch.width
        if cfg.modality == "pc":
            tokenizers = {"pointbert": PointTokenizer, "pnsa": PNSATokenizer}
            if cfg.point.tokenizer not in tokenizers:
                raise ValueError(f"unknown point tokenizer {cfg.point.tokenizer!r}")
            self.adapter = tokenizers[cfg.point.tokenizer](cfg.point, device=device)
        else:
            self.adapter = _ADAPTERS[cfg.modality](cfg, device=device)
        p = cfg.perceiver
        self.perceiver = self.perceiver_transformer = None
        if p is not None and p.as_transformer:
            self.perceiver_transformer = Transformer(
                width, p.depth, arch.heads, arch.mlp_ratio, arch.ls_init_value,
                cfg.quick_gelu, device=device)
        elif p is not None and not p.as_identity:
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
        for lens in (self.perceiver, self.perceiver_transformer):
            if lens is not None:
                lens.init_(g)
        normal_(self.class_embedding, scale, g)
        normal_(self.positional_embedding, scale, g)
        self.ln_pre.init_(g)
        self.trunk.init_(g)
        self.ln_post.init_(g)
        normal_(self.proj, scale, g)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32, *,
                train: bool = False, remat: bool = False,
                output_tokens: bool = False,
                fps_start: Optional[torch.Tensor] = None,
                fps_generator: Optional[torch.Generator] = None,
                patch_keep: Optional[torch.Tensor] = None):
        """x: images [B, 3, H, W], depth maps [B, 1, H, W], fbank [B,
        target_length, mel_bins], raw waveforms [B, samples], EEG [B, chans,
        time], video frames [B, T, 3, H, W] or points [B, N, C] -> features
        [B, embed_dim]. A waveform goes through the fbank in fp32 on its own
        device first; then the input is cast to ``compute_dtype``, so FPS
        sees the rounded coordinates, as in JAX. ``remat`` recomputes the
        trunk's blocks (and the transformer Lens's) in the backward pass.
        ``train`` marks a training pass: the point tokenizers normalise with
        batch statistics and update their running ones, and with
        ``patch_keep`` ([B, keep] from :func:`draw_patch_keep`) and
        ``patch_dropout`` > 0 each sample keeps CLS and those patches after
        the positional embedding (JAX applies it where ``fps_key`` is
        given). A point tokenizer's FPS starts at
        ``fps_start`` [B], or draws the starts from ``fps_generator``, or
        starts at point 0 (JAX's ``fps_key``: given, or None).
        ``output_tokens`` returns ``(features, tokens)``:
        the trunk's output before ``ln_post`` without the CLS token ([B,
        N, width]), or all of it under global average pooling."""
        cfg = self.cfg
        if cfg.modality == "audio" and x.dim() == 2:
            a = cfg.audio
            x = fbank_fixed_length(x.float(), target_length=a.target_length,
                                   sample_frequency=float(a.sampling_rate),
                                   num_mel_bins=a.mel_bins)
        x = x.to(compute_dtype)
        if cfg.modality == "video":
            tokens = self._video_tokens(x)
        else:
            if cfg.modality != "pc":
                tokens, pos = self.adapter(x)
            elif cfg.point.tokenizer == "pnsa":
                feats = x if cfg.point.in_channel == x.shape[-1] else x[..., 3:]
                tokens, pos = self.adapter(feats, x[..., :3], train, fps_start,
                                           fps_generator)
            else:
                tokens, pos = self.adapter(x, train, fps_start, fps_generator)
            if pos is not None and cfg.use_adapter_pos:
                tokens = tokens + pos.to(tokens.dtype)
        if self.perceiver is not None:
            tokens = self.perceiver(tokens)
        elif self.perceiver_transformer is not None:
            tokens = self.perceiver_transformer(tokens, remat=remat)
        B, _, width = tokens.shape
        cls = self.class_embedding.to(tokens.dtype).expand(B, 1, width)
        h = torch.cat([cls, tokens], dim=1)
        if cfg.use_orig_pos:
            h = h + self.positional_embedding.to(h.dtype)
        if train and cfg.patch_dropout > 0 and patch_keep is not None:
            h = apply_patch_dropout(h, patch_keep)
        h = self.ln_pre(h)
        h = self.trunk(h, skip_first_n=cfg.skip_first_n_layers, remat=remat)
        if cfg.arch.global_average_pool:
            pooled, toks = h.mean(dim=1), h
        else:
            pooled, toks = h[:, 0], h[:, 1:]
        pooled = self.ln_post(pooled)
        feats = pooled @ self.proj.to(pooled.dtype)
        return (feats, toks) if output_tokens else feats

    def _video_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """Frames [B, T, 3, H, W] -> tokens [B, T * L, width]: the patch
        embedding of each frame, + ltpos of its frame, + the spatial
        positions ``positional_embedding[1:]`` whenever a Lens is configured,
        in that order (two adds in the compute dtype, as in JAX)."""
        B, T = x.shape[:2]
        ftokens, _ = self.adapter(x.reshape((B * T,) + tuple(x.shape[2:])))
        L = ftokens.shape[1]
        if self.adapter.ltpos is not None:
            lt = self.adapter.ltpos.to(ftokens.dtype)
            ftokens = (ftokens.reshape(B, T, L, -1) + lt[None, :, None, :]
                       ).reshape(B * T, L, -1)
        if self.cfg.perceiver is not None:
            ftokens = ftokens + self.positional_embedding[1:].to(ftokens.dtype)
        return ftokens.reshape(B, T * L, -1)
