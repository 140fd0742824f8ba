"""CLIP text tower (port of vitlens_tpu/models/text.py).

Token + positional embedding -> causal transformer -> ln_final -> EOT pooling
(argmax of the token ids: EOT is the highest id in CLIP BPE) -> @
text_projection. The causal mask sends the trunk's attention down the plain
path; the MLP halves go through the fused-MLP kernel on CUDA. The
hf-text archs (``TextArch.hf_style``) take ``models/bert_text.py``'s
``HFTextTower`` instead: :func:`make_text_tower` picks the one of the arch.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from vitlens_tpu_torch.config import TextArch
from vitlens_tpu_torch.models.layers import (LayerNorm, Transformer, _param,
                                             normal_)
from vitlens_tpu_torch.ops.attention import causal_mask


class TextTower(nn.Module):
    def __init__(self, cfg: TextArch, embed_dim: int, quick_gelu: bool = False,
                 device=None):
        super().__init__()
        if cfg.hf_style:
            raise ValueError(f"an hf-style ({cfg.hf_style}) text arch builds "
                             "models.bert_text.HFTextTower (make_text_tower)")
        self.cfg = cfg
        width = cfg.width
        self.token_embedding = _param(cfg.vocab_size, width, device=device)
        self.positional_embedding = _param(cfg.context_length, width,
                                           device=device)
        self.trunk = Transformer(width, cfg.layers, cfg.heads, 4.0,
                                 cfg.ls_init_value, quick_gelu, device=device)
        self.ln_final = LayerNorm(width, device=device)
        self.text_projection = _param(width, embed_dim, device=device)
        self.lora = None  # train/lora.py::lora_init attaches one

    def init_(self, g: torch.Generator) -> None:
        normal_(self.token_embedding, 0.02, g)
        normal_(self.positional_embedding, 0.01, g)
        self.trunk.init_(g)
        self.ln_final.init_(g)
        normal_(self.text_projection, self.cfg.width ** -0.5, g)

    def forward(self, text: torch.Tensor, compute_dtype=torch.float32, *,
                remat: bool = False):
        """text: [B, context_length] token ids -> [B, embed_dim]. ``remat``
        recomputes the trunk's blocks in the backward pass."""
        x = self.token_embedding[text].to(compute_dtype)
        x = x + self.positional_embedding.to(compute_dtype)
        mask = causal_mask(self.cfg.context_length, device=x.device)
        x = self.ln_final(self.trunk(x, mask=mask, remat=remat, lora=self.lora))
        eot = text.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.text_projection.to(pooled.dtype)


def make_text_tower(cfg: TextArch, embed_dim: int, quick_gelu: bool = False,
                    device=None) -> nn.Module:
    """The CLIP text tower, or the BERT-family one of an hf-text arch (JAX
    ``tri_model_init``'s dispatch on ``hf_style``)."""
    if cfg.hf_style:
        from vitlens_tpu_torch.models.bert_text import HFTextTower

        return HFTextTower(cfg, embed_dim, device=device)
    return TextTower(cfg, embed_dim, quick_gelu, device=device)
