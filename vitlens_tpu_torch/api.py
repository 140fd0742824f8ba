"""One-stop inference API (port of vitlens_tpu/api.py::ViTLens): audio, point
clouds and text.

``ViTLens(...).encode({modality: inputs})`` -> {modality: [B, embed_dim]}.
Audio inputs are fbank arrays, [B, n_clip, T, F] (clip embeddings are
mean-pooled) or [B, T, F], passed with ``preprocessed=True``; point-cloud
inputs are raw clouds (arrays [N, C] or ``.npy`` paths, sampled to the
tower's point count by the host processor) or, with ``preprocessed=True``,
[B, npoints, 3]; text inputs are caption strings (or token ids with
``preprocessed=True``). The host fbank processor, the image tower and the
other modalities are not yet ported.

The model is built on the card unless ``device`` names another device.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from vitlens_tpu_torch.config import make_model_config
from vitlens_tpu_torch.data.processors import PointCloudProcessor, TextProcessor
from vitlens_tpu_torch.factory import (cast_matmul_weights_, make_generator,
                                       resolve_device)
from vitlens_tpu_torch.models.text import TextTower
from vitlens_tpu_torch.models.vit import VisionTower

PORTED_MODALITIES = ("audio", "pc", "text")
_TRUNKS = {"vitlensL": "ViT-L-14", "vitlensB": "ViT-B-16",
           "vitlensG": "ViT-bigG-14"}


def _l2n(x: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True)
    return x / n.clamp_min(1e-12)


def _as_tensor(data, dtype: torch.dtype) -> torch.Tensor:
    """A torch tensor (left on its device) or anything numpy can read."""
    if isinstance(data, torch.Tensor):
        return data.to(dtype)
    return torch.as_tensor(np.asarray(data), dtype=dtype)


class ViTLens(nn.Module):
    """Multi-modal encoder bound to one trunk (default ViT-L-14).

    Weights are made on ``device`` (default: the CUDA device; pass
    ``device="cpu"`` for the host) from a generator seeded with ``seed``;
    matmul weights are cast to ``compute_dtype`` once. ``batch_buckets`` pads
    each encode batch up to the next bucket with zero rows, which are sliced
    off (rows are computed independently)."""

    def __init__(self, model_var: str = "vitlensL",
                 modality_loaded: Sequence[str] = ("audio", "text"),
                 device=None, compute_dtype: torch.dtype = torch.float32,
                 seed: int = 0,
                 batch_buckets: Optional[Sequence[int]] = None):
        super().__init__()
        self.model_var = model_var
        self.trunk = _TRUNKS[model_var]
        self.modalities = list(modality_loaded)
        for m in self.modalities:
            if m not in PORTED_MODALITIES:
                raise NotImplementedError(f"modality {m!r} is not yet ported")
        if model_var == "vitlensG" and "pc" in self.modalities:
            raise NotImplementedError(
                "the vitlensG pc tower (PNSA tokenizer) is not yet ported")
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.batch_buckets = (tuple(sorted(batch_buckets))
                              if batch_buckets else None)
        self.towers = nn.ModuleDict()
        g = make_generator(seed, device)
        for m in self.modalities:
            cfg = make_model_config(self.trunk, m if m != "text" else "image")
            if m == "text":
                tower = TextTower(cfg.text, cfg.embed_dim, cfg.quick_gelu,
                                  device=device)
            else:
                tower = VisionTower(cfg.tower, device=device)
            tower.init_(g)
            self.towers[m] = cast_matmul_weights_(tower, compute_dtype)
        self.processors = {}
        if "text" in self.modalities:
            self.processors["text"] = TextProcessor()
        if "pc" in self.modalities:
            # the processor samples to the tower's point count and width
            pt = self.towers["pc"].cfg.point
            self.processors["pc"] = PointCloudProcessor(
                n_sample_points=pt.npoints, channels=pt.in_channel)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _pad_to_bucket(self, x: torch.Tensor) -> torch.Tensor:
        if self.batch_buckets is None:
            return x
        B = x.shape[0]
        bucket = next((b for b in self.batch_buckets if b >= B), B)
        if bucket == B:
            return x
        pad = x.new_zeros((bucket - B,) + tuple(x.shape[1:]))
        return torch.cat([x, pad], dim=0)

    @torch.inference_mode()
    def encode(self, inputs, normalize: bool = True,
               preprocessed: bool = False) -> Dict[str, torch.Tensor]:
        """inputs: {modality: captions (text), clouds (pc) or fbank arrays
        (audio, with ``preprocessed=True``)}. Returns {modality: [B,
        embed_dim]} on the model's device (fp32 when normalized)."""
        out: Dict[str, torch.Tensor] = {}
        dev, dt = self.device, self.compute_dtype
        for m, data in inputs.items():
            if m not in self.towers:
                raise KeyError(f"modality {m!r} not loaded; have {self.modalities}")
            if m == "text":
                x = _as_tensor(data if preprocessed
                               else self.processors["text"](data), torch.long)
            elif m == "pc":
                x = _as_tensor(data if preprocessed
                               else self.processors["pc"](data), torch.float32)
            else:
                if not preprocessed:
                    raise NotImplementedError(
                        "the host audio processor (waveform -> fbank) is not "
                        "yet ported; pass fbank arrays with preprocessed=True")
                x = _as_tensor(data, torch.float32)
            x = x.to(dev)
            B = x.shape[0]
            x = self._pad_to_bucket(x)
            tower = self.towers[m]
            if m == "audio" and x.dim() == 4:
                Bp, S = x.shape[:2]
                feats = tower(x.reshape((Bp * S,) + tuple(x.shape[2:])), dt)
                feats = feats.reshape(Bp, S, -1).mean(dim=1)  # clip mean
            else:
                feats = tower(x, dt)
            feats = feats[:B]
            out[m] = _l2n(feats) if normalize else feats
        return out
