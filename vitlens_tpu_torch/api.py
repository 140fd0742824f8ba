"""One-stop inference API (port of vitlens_tpu/api.py::ViTLens): images,
tactile frames, depth maps, audio, EEG, video, point clouds and text.

``ViTLens(...).encode({modality: inputs})`` -> {modality: [B, embed_dim]}.
Raw inputs go through the host processors (``data/processors.py``,
``data/video_processors.py``): image and tactile paths or PIL images,
disparity maps (arrays or ``.npy``/``.npz``, 16-bit ``.png`` and ``.pt``
paths), WAV/FLAC paths (3 clips a file, their embeddings mean-pooled), EEG
(arrays [chans, T] or ``.pt`` paths), video (frame directories or frame
arrays), clouds (arrays [N, C] or ``.npy`` paths, sampled to the tower's
point count) and captions. With ``preprocessed=True`` the inputs are
model-ready arrays: images [B, 3, H, W]; depth [B, 1, H, W]; audio as raw 16
kHz waveforms [B, samples] (the fbank then runs inside the tower, on the
model's device), an fbank [B, T, F] or clips [B, n_clip, T, F]; EEG [B,
chans, time_len]; video [B, n_frames, 3, H, W]; points [B, npoints, C];
token ids [B, 77].

The vitlensG pc tower is the published OpenShape recipe's: the PNSA
tokenizer over 10000 xyz + rgb points (xyz-only clouds get OpenShape's 0.4
grey) and the ViT-bigG-14 trunk with its first 16 blocks skipped.

``checkpoints={modality: path, "all": path}`` loads reference-layout state
dicts (the released per-modality files, a merged file with
``vitlens.{modality}.`` keys, or a CLIP file). The model is built on the card
unless ``device`` names another device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from vitlens_tpu_torch.config import image_tower_config, make_model_config
from vitlens_tpu_torch.data.processors import default_processors
from vitlens_tpu_torch.factory import (cast_matmul_weights_, make_generator,
                                       resolve_device)
from vitlens_tpu_torch.models.text import TextTower
from vitlens_tpu_torch.models.vit import VisionTower
from vitlens_tpu_torch.train.openshape import vitlensG_tower_config

PORTED_MODALITIES = ("image", "tactile", "depth", "audio", "eeg", "video",
                     "pc", "text")
VISUAL_MODALITIES = ("pc", "audio", "depth", "tactile", "eeg", "video")
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


def _read_checkpoint(path: str) -> dict:
    from vitlens_tpu_torch.weights.torch_convert import (load_torch_checkpoint,
                                                         strip_prefixes)

    return strip_prefixes(load_torch_checkpoint(path))


class ViTLens(nn.Module):
    """Multi-modal encoder bound to one trunk (default ViT-L-14).

    Weights are made on ``device`` (default: the CUDA device; pass
    ``device="cpu"`` for the host) from a generator seeded with ``seed``, or
    loaded from ``checkpoints`` where given: {modality: path} for the
    released per-modality files and/or "all" for one merged file. Matmul
    weights are cast to ``compute_dtype`` once; ``param_dtype`` instead casts
    every floating parameter at load (bf16 halves the memory of the vitlensG
    trunk), and the weights are cast to the compute dtype at use.
    ``batch_buckets`` pads each encode batch up to the next bucket with zero
    rows, which are sliced off (rows are computed independently)."""

    def __init__(self, model_var: str = "vitlensL",
                 modality_loaded: Sequence[str] = ("image", "text"),
                 device=None, compute_dtype: torch.dtype = torch.float32,
                 seed: int = 0,
                 batch_buckets: Optional[Sequence[int]] = None,
                 checkpoints: Optional[Dict[str, str]] = None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.model_var = model_var
        self.trunk = _TRUNKS[model_var]
        self.modalities = list(modality_loaded)
        for m in self.modalities:
            if m not in PORTED_MODALITIES:
                raise NotImplementedError(f"modality {m!r} is not yet ported")
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.param_dtype = param_dtype
        self.batch_buckets = (tuple(sorted(batch_buckets))
                              if batch_buckets else None)
        self.processors = default_processors(self.modalities)
        self.towers = nn.ModuleDict()
        checkpoints = checkpoints or {}
        state_dicts: Dict[str, dict] = {}  # each file is read once
        g = make_generator(seed, device)
        for m in self.modalities:
            cfg = make_model_config(self.trunk,
                                    m if m in VISUAL_MODALITIES else "image")
            if model_var == "vitlensG" and m == "pc":
                # the published vitlensG pc recipe (OpenShape-Triplets): the
                # PNSA tokenizer, 10000 xyz + rgb points, the bigG trunk with
                # its first 16 blocks skipped
                cfg = dataclasses.replace(cfg, tower=vitlensG_tower_config())
            if m == "text":
                tower = TextTower(cfg.text, cfg.embed_dim, cfg.quick_gelu,
                                  device=device)
            elif m == "image":
                tower = VisionTower(image_tower_config(cfg), device=device)
            else:
                tower = VisionTower(cfg.tower, device=device)
            path = checkpoints.get(m) or checkpoints.get("all")
            if path:  # a strict load: every parameter comes from the file
                if path not in state_dicts:
                    state_dicts[path] = _read_checkpoint(path)
                self._load_ckpt(tower, m, path, state_dicts[path])
            else:
                tower.init_(g)
            if param_dtype is None:
                cast_matmul_weights_(tower, compute_dtype)
            else:
                for p in tower.parameters():
                    if p.is_floating_point():
                        p.data = p.data.to(param_dtype)
            self.towers[m] = tower
        if "pc" in self.modalities:
            # the processor samples to the tower's point count and width
            pt = self.towers["pc"].cfg.point
            self.processors["pc"].n = pt.npoints
            self.processors["pc"].channels = pt.in_channel

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # -- construction ------------------------------------------------------

    @staticmethod
    def _load_ckpt(tower: nn.Module, m: str, path: str,
                   sd: Optional[dict] = None) -> None:
        """Copy the reference-layout checkpoint at ``path`` (or its state
        dict ``sd``, already read) into ``tower``; strict: the file must
        hold the whole tower."""
        from vitlens_tpu_torch.weights.from_jax import load_params, load_state
        from vitlens_tpu_torch.weights.torch_convert import (
            convert_text_tower, convert_vision_tower, sub)

        if sd is None:
            sd = _read_checkpoint(path)
        # a merged multi-modality checkpoint: keys vitlens.{modality}.{...}
        if any(k.startswith(f"vitlens.{m}.") for k in sd):
            sd = sub(sd, f"vitlens.{m}.")
        if m == "text":
            layers = tower.cfg.layers
            if "token_embedding.weight" in sd:
                params = convert_text_tower(sd, layers)
            elif any(k.startswith("text.") for k in sd):
                params = convert_text_tower(sub(sd, "text."), layers)
            else:
                # loud: returning here would serve the random text weights,
                # whose normalised embeddings look plausible
                raise ValueError(
                    f"checkpoint {path!r} matches no known text-tower layout "
                    f"(no 'token_embedding.weight', no 'text.' prefix); first "
                    f"keys: {sorted(sd)[:5]}")
            load_params(tower, params)
            return
        prefix = ("image." if m == "image"
                  and any(k.startswith("image.") for k in sd) else "visual.")
        tower_sd = sub(sd, prefix) if any(k.startswith(prefix) for k in sd) else sd
        params, state = convert_vision_tower(tower_sd, tower.cfg)
        load_params(tower, params)
        load_state(tower, state)

    # -- encoding ----------------------------------------------------------

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
        """inputs: {modality: paths, PIL images, clouds or captions (or
        model-ready arrays with ``preprocessed=True``)}. Returns {modality:
        [B, embed_dim]} on the model's device (fp32 when normalized)."""
        out: Dict[str, torch.Tensor] = {}
        dev, dt = self.device, self.compute_dtype
        for m, data in inputs.items():
            if m not in self.towers:
                raise KeyError(f"modality {m!r} not loaded; have {self.modalities}")
            x = data if preprocessed else self.processors[m](data)
            x = _as_tensor(x, torch.long if m == "text" else torch.float32)
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

    # -- warmup (serving cold start) ---------------------------------------

    def _warmup_sample(self, m: str, b: int, n_clips: int = 3) -> np.ndarray:
        """A zero input of the processor's output shape for one modality."""
        tower = self.towers[m]
        if m == "text":
            return np.zeros((b, tower.cfg.context_length), np.int64)
        t = tower.cfg
        hw = t.arch.image_size
        shapes = {
            "image": (3, hw, hw),
            "tactile": (3, hw, hw),
            "depth": (1, hw, hw),
            "pc": (t.point.npoints, t.point.in_channel) if t.point else None,
            "audio": ((n_clips, t.audio.target_length, t.audio.mel_bins)
                      if t.audio else None),
            "eeg": (t.eeg.chans, t.eeg.time_len) if t.eeg else None,
            "video": (t.video.n_frames, 3, hw, hw) if t.video else None,
        }
        shape = shapes.get(m)
        if shape is None:
            raise ValueError(f"no warmup shape for modality {m!r}")
        return np.zeros((b,) + shape, np.float32)

    def warmup(self, batch_sizes=None, log=None) -> None:
        """Run every (modality, batch bucket) encode once on zero inputs, so
        that the first real request pays no one-time cost: on the card the
        first call builds the kernels (nvcc, or the build cache) and each
        bucket's first call sets up its launches and the allocator's
        blocks."""
        sizes = list(batch_sizes if batch_sizes is not None
                     else (self.batch_buckets or [1]))
        for m in self.modalities:
            for b in sizes:
                feats = self.encode({m: self._warmup_sample(m, b)},
                                    normalize=True, preprocessed=True)
                feats[m].cpu()  # waits for the device
                if log:
                    log(f"warmup {m} b{b} done")

    # -- checkpoint export (reference vitlens.py:153-159) ------------------

    def export_params(self, merge_lora: bool = True) -> Dict[str, Dict[str, torch.Tensor]]:
        """{modality: {parameter name: tensor}} of every loaded tower (the
        live tensors). ``merge_lora`` is the JAX signature's: the port's
        towers carry no LoRA factors yet (ROADMAP Queue 1, item 11), so
        there is nothing to merge."""
        del merge_lora
        return {m: dict(self.towers[m].named_parameters())
                for m in self.modalities}

    def _ckpt_tree(self):
        state = {m: dict(self.towers[m].named_buffers()) for m in self.modalities}
        return {"params": self.export_params(),
                "state": {m: b for m, b in state.items() if b}}

    def export_checkpoint(self, save_path: str) -> str:
        """Save a multi-modality checkpoint (parameters and buffers, e.g.
        BatchNorm statistics) with ``vitlens_meta.json``, loadable with
        :meth:`load_checkpoint`. The format is the port's
        (``train/checkpoint.py``: ``torch.save``), not JAX's orbax tree."""
        import json
        import os

        from vitlens_tpu_torch.train import checkpoint as C

        C._save_tree(save_path, C.snapshot(self._ckpt_tree()))
        with open(os.path.join(save_path, "vitlens_meta.json"), "w") as f:
            json.dump({"model_var": self.model_var,
                       "modalities": list(self.modalities)}, f)
        return save_path

    def load_checkpoint(self, path: str) -> None:
        """Restore a checkpoint written by :meth:`export_checkpoint` into the
        loaded towers, each tensor cast to the live one's dtype."""
        from vitlens_tpu_torch.train import checkpoint as C

        live = self._ckpt_tree()
        restored = C.load_checkpoint(path, live)
        with torch.no_grad():
            for kind in ("params", "state"):
                for m, tensors in live[kind].items():
                    for n, t in tensors.items():
                        t.copy_(restored[kind][m][n])
