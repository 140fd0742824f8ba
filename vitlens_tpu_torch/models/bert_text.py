"""BERT-family text tower (port of vitlens_tpu/models/bert_text.py).

The reference's HFTextEncoder (a transformers BertModel / RobertaModel +
pooler + linear or MLP projection) rebuilt as plain modules whose parameter
names are the JAX pytree's, so that ``weights/from_jax.py`` copies a JAX tree
and :func:`convert_hf_bert_state_dict` maps a transformers state dict.

Semantics (transformers BertModel, post-LN):
  emb = LN(word[ids] + pos + token_type[0])
  per layer: h = LN(h + proj(attn(h)));  h = LN(h + W2 gelu(W1 h))
  attention_mask: an additive -1e9 on padded keys.
LayerNorm eps is 1e-12 (BERT) or 1e-5 (the RoBERTa family). The attention is
masked, so it takes the plain path on both devices, as in JAX: no kernel.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from vitlens_tpu_torch.models.layers import (LayerNorm, Linear, _param, gelu,
                                             layer_norm, normal_)

LN_EPS = 1e-12         # BertConfig.layer_norm_eps default
LN_EPS_ROBERTA = 1e-5  # RobertaConfig/XLMRobertaConfig.layer_norm_eps


def _init_linear_(lin: Linear, g: torch.Generator, std: float = 0.02) -> None:
    normal_(lin.w, std, g)
    if lin.b is not None:
        with torch.no_grad():
            lin.b.zero_()


class Embeddings(nn.Module):
    def __init__(self, vocab_size: int, hidden: int, max_positions: int,
                 type_vocab_size: int, device=None):
        super().__init__()
        self.word = _param(vocab_size, hidden, device=device)
        self.position = _param(max_positions, hidden, device=device)
        self.token_type = _param(type_vocab_size, hidden, device=device)
        self.ln = LayerNorm(hidden, device=device)

    def init_(self, g: torch.Generator) -> None:
        for t in (self.word, self.position, self.token_type):
            normal_(t, 0.02, g)
        self.ln.init_(g)


class BertBlock(nn.Module):
    def __init__(self, hidden: int, heads: int, intermediate: int, eps: float,
                 device=None):
        super().__init__()
        self.heads = heads
        for n in ("q", "k", "v", "attn_out"):
            setattr(self, n, Linear(hidden, hidden, device=device))
        self.attn_ln = LayerNorm(hidden, eps, device=device)
        self.inter = Linear(hidden, intermediate, device=device)
        self.out = Linear(intermediate, hidden, device=device)
        self.out_ln = LayerNorm(hidden, eps, device=device)

    def init_(self, g: torch.Generator) -> None:
        for n in ("q", "k", "v", "attn_out", "inter", "out"):
            _init_linear_(getattr(self, n), g)
        self.attn_ln.init_(g)
        self.out_ln.init_(g)

    def forward(self, h, bias):
        B, N, D = h.shape
        dh = D // self.heads

        def split(t):
            return t.reshape(B, N, self.heads, dh).transpose(1, 2)

        q, k, v = split(self.q(h)), split(self.k(h)), split(self.v(h))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(dh) + bias
        attn = torch.softmax(scores.float(), dim=-1)
        ctx = (attn.to(v.dtype) @ v).transpose(1, 2).reshape(B, N, D)
        x = self.attn_ln(h + self.attn_out(ctx))
        return self.out_ln(x + self.out(gelu(self.inter(x))))


class BertEncoder(nn.Module):
    """Embeddings, post-LN blocks and the optional tanh pooler (absent from a
    checkpoint without a BertPooler: :meth:`drop_pooler`)."""

    def __init__(self, vocab_size: int, hidden: int, layers: int, heads: int,
                 intermediate: int, max_positions: int = 512,
                 type_vocab_size: int = 2, eps: float = LN_EPS, device=None):
        super().__init__()
        self.eps = eps
        self.embeddings = Embeddings(vocab_size, hidden, max_positions,
                                     type_vocab_size, device=device)
        self.embeddings.ln.eps = eps
        self.blocks = nn.ModuleList(
            BertBlock(hidden, heads, intermediate, eps, device=device)
            for _ in range(layers))
        self.pooler = Linear(hidden, hidden, device=device)

    def init_(self, g: torch.Generator) -> None:
        self.embeddings.init_(g)
        for b in self.blocks:
            b.init_(g)
        _init_linear_(self.pooler, g)

    def drop_pooler(self) -> None:
        self.pooler = None

    def forward(self, input_ids, attention_mask, position_style: str = "bert",
                pad_id: int = 0, compute_dtype=torch.float32,
                remat: bool = False):
        """input_ids [B, N], attention_mask [B, N] (1 real, 0 pad) ->
        (last_hidden_state [B, N, H], pooled [B, H]). ``position_style``
        "roberta" numbers the non-pad tokens from pad_id + 1 and gives pads
        pad_id (transformers' create_position_ids_from_input_ids)."""
        emb = self.embeddings
        N = input_ids.shape[1]
        if position_style == "roberta":
            not_pad = (input_ids != pad_id).to(torch.int32)
            pos_ids = torch.cumsum(not_pad, dim=1) * not_pad + pad_id
            pos = emb.position[pos_ids.long()]
        elif position_style == "bert":
            pos = emb.position[None, :N, :]
        else:
            raise ValueError(f"unknown position_style {position_style!r}")
        h = emb.word[input_ids.long()] + pos + emb.token_type[0][None, None, :]
        h = layer_norm(h, emb.ln.scale, emb.ln.bias, self.eps).to(compute_dtype)
        bias = ((1.0 - attention_mask.float()) * -1e9)[:, None, None, :]
        for b in self.blocks:
            if remat and torch.is_grad_enabled():
                h = checkpoint(b, h, bias, use_reentrant=False)
            else:
                h = b(h, bias)
        if self.pooler is not None:
            pooled = torch.tanh(self.pooler(h[:, 0]))
        else:
            # no BertPooler in the checkpoint: the reference ClsPooler falls
            # back to last_hidden[:, 0]
            pooled = h[:, 0]
        return h, pooled


def pool(last_hidden, pooler_output, attention_mask, pooler_type: str):
    """The reference poolers (hf_model.py:46-104)."""
    if pooler_type == "mean_pooler":
        m = attention_mask[..., None].to(last_hidden.dtype)
        return (last_hidden * m).sum(1) / m.sum(1)
    if pooler_type == "max_pooler":
        # pads masked (the paper's semantics), as in JAX
        neg = torch.where(attention_mask[..., None] > 0, last_hidden,
                          torch.full_like(last_hidden, float("-inf")))
        return neg.max(dim=1).values
    if pooler_type == "cls_pooler":
        return pooler_output
    if pooler_type == "cls_last_hidden_state_pooler":
        return last_hidden[:, 0]
    raise ValueError(f"unknown pooler_type {pooler_type!r}")


class Projection(nn.Module):
    """``linear``: fc without bias; ``mlp``: fc1 -> GELU -> fc2, no biases,
    hidden (d_model + output_dim) // 2."""

    def __init__(self, d_model: int, output_dim: int, proj: str = "linear",
                 device=None):
        super().__init__()
        if proj == "linear":
            self.fc = Linear(d_model, output_dim, bias=False, device=device)
            self.fc1 = self.fc2 = None
        else:
            hidden = (d_model + output_dim) // 2
            self.fc = None
            self.fc1 = Linear(d_model, hidden, bias=False, device=device)
            self.fc2 = Linear(hidden, output_dim, bias=False, device=device)

    def init_(self, g: torch.Generator) -> None:
        for lin in (self.fc, self.fc1, self.fc2):
            if lin is not None:
                _init_linear_(lin, g)

    def forward(self, x):
        if self.fc is not None:
            return self.fc(x)
        return self.fc2(gelu(self.fc1(x)))


class HFTextTower(nn.Module):
    """The text tower of the hf-text archs (``TextArch.hf_style`` set):
    token ids [B, N] (pad = ``hf_pad_id``) -> [B, embed_dim]."""

    def __init__(self, cfg, embed_dim: int, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = BertEncoder(
            cfg.vocab_size, cfg.width, cfg.layers, cfg.heads,
            cfg.hf_intermediate, cfg.hf_max_positions,
            type_vocab_size=1 if cfg.hf_style == "roberta" else 2,
            eps=LN_EPS_ROBERTA if cfg.hf_style == "roberta" else LN_EPS,
            device=device)
        self.proj = Projection(cfg.width, embed_dim, cfg.hf_proj, device=device)

    def init_(self, g: torch.Generator) -> None:
        self.encoder.init_(g)
        self.proj.init_(g)

    def forward(self, text: torch.Tensor, compute_dtype=torch.float32, *,
                remat: bool = False):
        t = self.cfg
        mask = (text != t.hf_pad_id).to(torch.int32)
        hidden, pooled = self.encoder(text, mask, t.hf_style, t.hf_pad_id,
                                      compute_dtype, remat)
        return self.proj(pool(hidden, pooled, mask, t.hf_pooler_type))


# ---------------------------------------------------------------------------
# transformers BertModel / RobertaModel state dicts
# ---------------------------------------------------------------------------


def _np32(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def convert_hf_bert_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A transformers BertModel/RobertaModel/XLMRobertaModel state dict (bare
    or under ``bert.``/``roberta.``/``text.transformer.``) -> the JAX tree
    layout (blocks stacked); ``pooler`` is None without a BertPooler."""
    from vitlens_tpu_torch.weights.torch_convert import _stack

    for prefix in ("bert.", "roberta.", "text.transformer."):
        if any(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items()
                  if k.startswith(prefix)}
            break

    def lin(name):
        p = {"w": np.ascontiguousarray(_np32(sd[f"{name}.weight"]).T)}
        if f"{name}.bias" in sd:
            p["b"] = _np32(sd[f"{name}.bias"])
        return p

    def ln(name):
        return {"scale": _np32(sd[f"{name}.weight"]),
                "bias": _np32(sd[f"{name}.bias"])}

    emb = {"word": _np32(sd["embeddings.word_embeddings.weight"]),
           "position": _np32(sd["embeddings.position_embeddings.weight"]),
           "token_type": _np32(sd["embeddings.token_type_embeddings.weight"]),
           "ln": ln("embeddings.LayerNorm")}
    n_layers = 1 + max(int(k.split(".")[2]) for k in sd
                       if k.startswith("encoder.layer."))
    blocks = []
    for i in range(n_layers):
        pre = f"encoder.layer.{i}"
        blocks.append({
            "q": lin(f"{pre}.attention.self.query"),
            "k": lin(f"{pre}.attention.self.key"),
            "v": lin(f"{pre}.attention.self.value"),
            "attn_out": lin(f"{pre}.attention.output.dense"),
            "attn_ln": ln(f"{pre}.attention.output.LayerNorm"),
            "inter": lin(f"{pre}.intermediate.dense"),
            "out": lin(f"{pre}.output.dense"),
            "out_ln": ln(f"{pre}.output.LayerNorm"),
        })
    return {"embeddings": emb, "blocks": _stack(blocks),
            "pooler": lin("pooler.dense") if "pooler.dense.weight" in sd else None}


def load_hf_text_tower(tower: HFTextTower, params: Dict[str, Any]) -> None:
    """Copy a converted tree (``weights.torch_convert.convert_hf_text_tower``
    or a JAX ``hf_text_tower_init`` tree) into ``tower``; a tree whose
    ``encoder.pooler`` is None drops the tower's pooler first."""
    from vitlens_tpu_torch.weights.from_jax import load_params

    if params["encoder"].get("pooler") is None:
        tower.encoder.drop_pooler()
    load_params(tower, params)
