"""Model factory (port of vitlens_tpu/factory.py::create_model).

Parameters are made on ``device`` and filled from an explicit
``torch.Generator`` seeded with ``seed``, with the JAX package's init
distributions (the values differ from JAX's: the generators differ). Matmul
and convolution weights are then cast to ``dtype`` once; LayerNorm
parameters, biases and embeddings stay fp32 and are cast at use, as in JAX.

For training, build the model in fp32 and call :func:`make_trainable_` with
the trainability mask: trainable parameters stay fp32 masters, cast at use,
and only the frozen matmul weights are cast to the compute dtype.

The entry points run on the card: ``device=None`` means ``"cuda"``, and with
no CUDA device they raise unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from vitlens_tpu_torch.config import make_model_config
from vitlens_tpu_torch.models.layers import MATMUL_WEIGHTS
from vitlens_tpu_torch.models.tri import TriModel


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA device, which must exist; anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "vitlens_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run on the host")
        device = "cuda"
    return torch.device(device)


def make_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def cast_matmul_weights_(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast, in place, every frozen parameter whose leaf name is in
    ``MATMUL_WEIGHTS`` to ``dtype``. A parameter that requires grad is a
    trainable fp32 master and is never cast."""
    for name, p in module.named_parameters():
        if name.rsplit(".", 1)[-1] in MATMUL_WEIGHTS and not p.requires_grad:
            p.data = p.data.to(dtype)
    return module


def make_trainable_(model: nn.Module, mask, dtype: torch.dtype) -> nn.Module:
    """Mark the parameters that ``mask`` ({name: trainable}, from
    ``train.freeze``) trains as requiring grad, then cast the frozen matmul
    weights to the compute ``dtype``. The model must be fp32."""
    from vitlens_tpu_torch.train.freeze import apply_mask

    for name, p in model.named_parameters():
        if p.dtype != torch.float32:
            raise ValueError(f"{name} is {p.dtype}: build the model in fp32 "
                             "before making it trainable")
    return cast_matmul_weights_(apply_mask(model, mask), dtype)


def create_model(model: str = "ViT-L-14", modality: str = "audio", *,
                 seed: int = 0, quick_gelu: bool = False, device=None,
                 dtype: torch.dtype = torch.float32,
                 checkpoint_path: Optional[str] = None,
                 **tower_overrides) -> TriModel:
    """Build the Lens + text model for ``modality`` on trunk ``model``.

    ``checkpoint_path`` names a reference (TriCLIP or CLIP) state dict,
    merged non-strictly over the initial weights, as in JAX: what the file
    holds is loaded, the rest keeps its initial values. A file with no
    ``image.`` keys (a plain CLIP file) serves its ``visual.`` keys to the
    image tower too."""
    device = resolve_device(device)
    cfg = make_model_config(model, modality, quick_gelu=quick_gelu,
                            **tower_overrides)
    m = TriModel(cfg, device=device)
    m.init_(make_generator(seed, device))
    if checkpoint_path is not None:
        from vitlens_tpu_torch.weights.from_jax import merge_params
        from vitlens_tpu_torch.weights.torch_convert import (
            convert_tri_state_dict, load_torch_checkpoint)

        params, state = convert_tri_state_dict(
            load_torch_checkpoint(checkpoint_path), cfg)
        merge_params(m, params, state)
    return cast_matmul_weights_(m, dtype)
