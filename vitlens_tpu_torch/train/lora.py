"""LoRA adapters for a tower's trunk (port of vitlens_tpu/train/lora.py).

Rank-r factors on the trunk's matmuls train while the base weights stay
frozen. As in JAX:

  * :func:`lora_init` attaches a :class:`LoRA` module
    (``models/lora.py``) to a tower as
    ``tower.lora``, whose parameters mirror the targeted weights of every
    trunk block: a target W [in, out] of block i gets ``a`` [in, r] and
    ``b`` [r, out] at ``lora.trunk.blocks.<i>.<target path>`` (b zero, so
    that the adapted model at init is the base model), beside ``lora.scale``
    = alpha / r. These are the names ``weights/from_jax.py`` gives JAX's
    ``"lora"`` subtree, so a JAX tree loads whole.
  * The merge W + scale * a @ b happens at forward time, block by block
    inside ``Transformer.forward`` (``models/lora.py``
    :func:`merged_block_weights`), under
    autograd: gradients reach a and b while the base W stays frozen, and the
    merged weights reach the kernels' autograd Functions (the fused MLP's
    save-preact variant, attention) as any trunk weight does. The merge runs
    inside a block's remat checkpoint, so a recomputed block merges again.
  * :func:`lora_mask` trains the factors alone (the scale is frozen);
    :func:`merge_lora` gives the merged weights, :func:`reset_lora` zeroes
    every ``b``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn

from vitlens_tpu_torch.models.lora import (
    DEFAULT_TARGETS, LoRA, merged_block_weights)


def lora_init(tower: nn.Module, rank: int, generator: torch.Generator, *,
              alpha=None, targets: Sequence[str] = DEFAULT_TARGETS) -> LoRA:
    """Attach a :class:`LoRA` of rank ``rank`` to ``tower`` (a tower with a
    ``trunk`` of blocks: ``VisionTower``, ``TextTower``), drawn from
    ``generator``, on the trunk's device; returns it."""
    trunk = getattr(tower, "trunk", None)
    if trunk is None or not hasattr(trunk, "blocks"):
        raise ValueError("the tower has no trunk.blocks to adapt")
    device = next(trunk.parameters()).device
    lora = LoRA(trunk, rank, alpha, targets, device=device)
    lora.init_(generator)
    tower.lora = lora
    return lora


def has_lora(tower: nn.Module) -> bool:
    return getattr(tower, "lora", None) is not None


@torch.no_grad()
def reset_lora(tower: nn.Module) -> None:
    """Zero every ``b`` of the tower's LoRA: the adapters then add nothing,
    so a tower that just restored merged weights equals them and keeps
    trainable factors."""
    for name, p in tower.lora.named_parameters():
        if name.endswith(".b"):
            p.zero_()


def merge_lora(tower: nn.Module) -> Dict[str, torch.Tensor]:
    """{parameter name: tensor} of the tower without its ``lora.*``
    parameters, each adapted weight replaced by W + scale * a @ b (a plain
    tower's parameters, as JAX's ``merge_lora`` returns a plain tree)."""
    out = {n: p for n, p in tower.named_parameters()
           if not n.startswith("lora.")}
    if not has_lora(tower):
        return out
    with torch.no_grad():
        for i, block in enumerate(tower.trunk.blocks):
            for name, w in merged_block_weights(tower.lora, i, block).items():
                out[f"trunk.blocks.{i}.{name}"] = w
    return out


def lora_mask(tower: nn.Module) -> Dict[str, bool]:
    """Trainability of a tower carrying a LoRA, named relative to it: the
    factors train; the base weights and the scale do not."""
    return {n: n.startswith("lora.") and n.endswith((".a", ".b"))
            for n, _ in tower.named_parameters()}
