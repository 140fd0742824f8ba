"""Tri-tower model: the frozen CLIP image tower, the Lens ("visual") tower,
the CLIP text tower and the shared logit scale (port of
vitlens_tpu/models/tri.py). ``train`` and ``remat`` thread through the
encode helpers as in JAX; so do the point tokenizer's FPS starts
(``fps_start`` [B] or ``fps_generator``, where JAX passes ``fps_key``), and
the Lens tower's train-time patch dropout (``patch_keep``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn

from vitlens_tpu_torch.config import ModelConfig, image_tower_config
from vitlens_tpu_torch.models.text import TextTower
from vitlens_tpu_torch.models.vit import VisionTower


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize(dim=-1) equivalent, computed in fp32, cast back."""
    x32 = x.float()
    n = x32.square().sum(-1, keepdim=True).sqrt()
    return (x32 / n.clamp_min(eps)).to(x.dtype)


def _frame_mean(x: torch.Tensor, b: int, t: int) -> torch.Tensor:
    """[B * T, ...] -> the mean over T, [B, ...]: summed in fp32 and rounded
    once to ``x``'s dtype, as ``jnp.mean`` of a bf16 array is."""
    return x.reshape((b, t) + tuple(x.shape[1:])).float().mean(1).to(x.dtype)


class TriModel(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.image = VisionTower(image_tower_config(cfg), device=device)
        self.visual = VisionTower(cfg.tower, device=device)
        self.text = TextTower(cfg.text, cfg.embed_dim, cfg.quick_gelu,
                              device=device)
        self.logit_scale = nn.Parameter(torch.empty((), device=device),
                                        requires_grad=False)

    def init_(self, g: torch.Generator) -> None:
        # the image tower draws last, so that a seed gives the Lens and text
        # towers the weights it gave them before the image tower was added
        self.visual.init_(g)
        self.text.init_(g)
        self.image.init_(g)
        with torch.no_grad():
            self.logit_scale.fill_(math.log(1.0 / self.cfg.init_logit_scale_inv_temp))


def encode_image(model: TriModel, images: torch.Tensor, *,
                 normalize: bool = False, compute_dtype=torch.float32,
                 remat: bool = False) -> torch.Tensor:
    """Images [B, 3, H, W], or frames [B, T, 3, H, W] whose features are
    averaged over T, -> [B, embed_dim]."""
    if images.dim() == 5:
        b, t = images.shape[:2]
        feats = model.image(images.reshape((b * t,) + tuple(images.shape[2:])),
                            compute_dtype, remat=remat)
        feats = _frame_mean(feats, b, t)
    else:
        feats = model.image(images, compute_dtype, remat=remat)
    return _l2_normalize(feats) if normalize else feats


def encode_visual(model: TriModel, x: torch.Tensor, *, normalize: bool = False,
                  train: bool = False, compute_dtype=torch.float32,
                  remat: bool = False, fps_start: Optional[torch.Tensor] = None,
                  fps_generator: Optional[torch.Generator] = None,
                  patch_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    feats = model.visual(x, compute_dtype, train=train, remat=remat,
                         fps_start=fps_start, fps_generator=fps_generator,
                         patch_keep=patch_keep)
    return _l2_normalize(feats) if normalize else feats


def encode_text(model: TriModel, text: torch.Tensor, *, normalize: bool = False,
                compute_dtype=torch.float32, remat: bool = False) -> torch.Tensor:
    feats = model.text(text, compute_dtype, remat=remat)
    return _l2_normalize(feats) if normalize else feats


def tri_forward_video_distill(model: TriModel, *, video_frames: torch.Tensor,
                              text: torch.Tensor, visual_x: torch.Tensor,
                              train: bool = False, compute_dtype=torch.float32,
                              remat: bool = False) -> Dict[str, torch.Tensor]:
    """The video distill-tokens forward: the image tower over every frame of
    ``video_frames`` [B, T, 3, H, W], its features and tokens averaged over
    T; the Lens tower's features and tokens of ``visual_x``; the text
    features. Features are L2-normalised, tokens are not."""
    b, t = video_frames.shape[:2]
    frames = video_frames.reshape((b * t,) + tuple(video_frames.shape[2:]))
    img_feats, img_tokens = model.image(frames, compute_dtype, remat=remat,
                                        output_tokens=True)
    vis_feats, vis_tokens = model.visual(visual_x, compute_dtype, train=train,
                                         remat=remat, output_tokens=True)
    return {
        "image_features": _l2_normalize(_frame_mean(img_feats, b, t)),
        "image_tokens": _frame_mean(img_tokens, b, t),
        "text_features": encode_text(model, text, normalize=True,
                                     compute_dtype=compute_dtype, remat=remat),
        "visual_features": _l2_normalize(vis_feats),
        "visual_tokens": vis_tokens,
        "logit_scale": model.logit_scale.exp().float(),
    }


def tri_forward(model: TriModel, *, images: Optional[torch.Tensor] = None,
                text: Optional[torch.Tensor] = None,
                visual_x: Optional[torch.Tensor] = None, train: bool = False,
                compute_dtype=torch.float32, remat: bool = False,
                fps_start: Optional[torch.Tensor] = None,
                fps_generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
    """The normalised features of whichever inputs are given, and the logit
    scale."""
    out = {"logit_scale": model.logit_scale.exp().float()}
    kw = dict(normalize=True, compute_dtype=compute_dtype, remat=remat)
    if images is not None:
        out["image_features"] = encode_image(model, images, **kw)
    if text is not None:
        out["text_features"] = encode_text(model, text, **kw)
    if visual_x is not None:
        out["visual_features"] = encode_visual(
            model, visual_x, train=train, fps_start=fps_start,
            fps_generator=fps_generator, **kw)
    return out
