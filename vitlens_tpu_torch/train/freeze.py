"""Freeze and partial-unfreeze masks (port of vitlens_tpu/train/freeze.py).

The JAX package expresses the reference lock zoo (transformer.py:553-627
VisionTransformer.lock, model.py:448-502 TriCLIP.lock_*_tower) as 0/1 masks
over its parameter pytree, with a leading [layers] axis for the stacked
trunk. The port's trunk blocks are separate modules, so a mask here is a
``{parameter name: trainable}`` dict over ``named_parameters()``, one bool per
Parameter, and :func:`apply_mask` makes it real as ``requires_grad``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch.nn as nn

Mask = Dict[str, bool]


def _unlock(mask: Mask, prefix: str) -> None:
    """Unlock every parameter named ``prefix`` or under ``prefix.``."""
    for name in mask:
        if name == prefix or name.startswith(prefix + "."):
            mask[name] = True


def vision_tower_mask(tower: nn.Module, n_layers: int, *, locked: bool = True,
                      unlocked_groups: int = 0, unlock_from_head: bool = False,
                      unlock_cls: bool = False, unlock_pos_emb: bool = False,
                      unlock_trans_first_n_layers: Optional[int] = None,
                      lens_always_unlocked: bool = True) -> Mask:
    """Trainability of one vision tower's parameters, named relative to it.

    Group layout as in the reference (transformer.py:564-578):
      group 0       = adapter, class_embedding, positional_embedding, ln_pre
      groups 1..L-1 = trunk blocks 0..L-2
      group L       = trunk block L-1 + ln_post
      group L+1     = proj
    The perceiver and the adapter of a Lens tower always train
    (transformer.py:598-603)."""
    mask = {name: not locked for name, _ in tower.named_parameters()}
    if not locked:
        return mask
    n_groups = n_layers + 2
    if unlocked_groups:
        groups = (range(unlocked_groups) if unlock_from_head
                  else range(n_groups - unlocked_groups, n_groups))
        for gi in groups:
            if gi == 0:
                for k in ("adapter", "class_embedding", "positional_embedding",
                          "ln_pre"):
                    _unlock(mask, k)
            elif 1 <= gi <= n_layers - 1:
                _unlock(mask, f"trunk.blocks.{gi - 1}")
            elif gi == n_layers:
                _unlock(mask, f"trunk.blocks.{n_layers - 1}")
                _unlock(mask, "ln_post")
            elif gi == n_layers + 1:
                _unlock(mask, "proj")
    if lens_always_unlocked:
        _unlock(mask, "perceiver")
        _unlock(mask, "adapter")
    if unlock_cls:
        _unlock(mask, "class_embedding")
    if unlock_pos_emb:
        _unlock(mask, "positional_embedding")
    for i in range(min(unlock_trans_first_n_layers or 0, n_layers)):
        _unlock(mask, f"trunk.blocks.{i}")
    return mask


def image_tower_image_mask(tower: nn.Module, n_layers: int, *,
                           locked: bool = True, unlocked_groups: int = 0,
                           unlock_cls: bool = False,
                           unlock_pos_emb: bool = False) -> Mask:
    """The image tower's lock (model.py:458-468): its patch embedding (the
    adapter) belongs to group 0 and stays locked unless group 0 is
    unlocked."""
    return vision_tower_mask(tower, n_layers, locked=locked,
                             unlocked_groups=unlocked_groups,
                             unlock_cls=unlock_cls,
                             unlock_pos_emb=unlock_pos_emb,
                             lens_always_unlocked=False)


def tri_model_mask(model: nn.Module, cfg, *, lock_image: bool = True,
                   lock_text: bool = True, lock_visual: bool = True,
                   image_unlocked_groups: int = 0,
                   visual_unlocked_groups: int = 0,
                   unlock_from_head: bool = False, unlock_cls: bool = False,
                   unlock_pos_emb: bool = False,
                   unlock_trans_first_n_layers: Optional[int] = None,
                   train_logit_scale: bool = True) -> Mask:
    """Trainability of a ``TriModel``'s parameters, mirroring the reference
    flags (--lock-image/--lock-text/--lock-visual and the unlock-* flags)."""
    image = image_tower_image_mask(model.image, cfg.vision.layers,
                                   locked=lock_image,
                                   unlocked_groups=image_unlocked_groups)
    mask: Mask = {f"image.{k}": v for k, v in image.items()}
    visual = vision_tower_mask(
        model.visual, cfg.tower.arch.layers, locked=lock_visual,
        unlocked_groups=visual_unlocked_groups,
        unlock_from_head=unlock_from_head, unlock_cls=unlock_cls,
        unlock_pos_emb=unlock_pos_emb,
        unlock_trans_first_n_layers=unlock_trans_first_n_layers)
    mask.update({f"visual.{k}": v for k, v in visual.items()})
    mask.update({f"text.{k}": not lock_text
                 for k, _ in model.text.named_parameters()})
    mask["logit_scale"] = train_logit_scale
    return mask


def apply_mask(model: nn.Module, mask: Mask) -> nn.Module:
    """Set each parameter's ``requires_grad`` to its mask entry."""
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    return model


def count_trainable(model: nn.Module, mask: Mask) -> int:
    """Trainable-parameter census (reference audio_main.py:323-343)."""
    return sum(p.numel() for name, p in model.named_parameters() if mask[name])
