"""Attention entry point shared by every tower (ViT trunk, text tower, Lens).

Dispatch: an unmasked bf16 call goes to
:func:`vitlens_tpu_torch.ops.flash_attention.flash_attention`: on a CUDA
tensor the hand-written kernel, which raises on what it does not take, and on
a CPU tensor its plain version; on both devices its backward is the JAX
package's fp32 recompute. Masked calls (the text tower's causal mask) and
calls in any other dtype (the fp32 default; ``flash_attention_applicable``)
take :func:`plain_attention`, which mirrors the JAX package's
``_xla_attention``, with native autograd, as the JAX package sends them to
XLA. Eager PyTorch does not fuse the plain path, so on the
card it would write the [B, H, NQ, NK] scores to HBM in every layer; the JAX
package's KV >= 4096 threshold was a TPU choice and is not carried over.
"""

from __future__ import annotations

from typing import Optional

import torch

from vitlens_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_applicable)


def plain_attention(q, k, v, mask: Optional[torch.Tensor], scale: float):
    """q [B, H, NQ, Dh], k/v [B, H, NK, Dh]; mask additive, broadcastable
    to [B, H, NQ, NK]. Logits in the compute dtype, softmax in fp32, the
    probabilities cast back before the product with v."""
    logits = (q @ k.transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return probs @ v


def dot_product_attention(q, k, v, mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention core: q [B, H, NQ, Dh], k/v [B, H, NK, Dh] ->
    [B, H, NQ, Dh]. ``scale`` defaults to Dh ** -0.5."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if mask is None and flash_attention_applicable(q):
        return flash_attention(q, k, v, scale)
    return plain_attention(q, k, v, mask, scale)


def causal_mask(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Additive causal mask [n, n]: 0 on and below the diagonal, -inf above."""
    return torch.triu(torch.full((n, n), float("-inf"), dtype=dtype,
                                 device=device), diagonal=1)
