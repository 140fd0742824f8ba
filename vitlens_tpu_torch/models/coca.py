"""CoCa: contrastive + captioning model (port of vitlens_tpu/models/coca.py).

The pieces, with the JAX package's parameter names, so that
``weights/from_jax.load_coca_params`` copies a ``coca_init`` tree unchanged:

  * :class:`AttentionalPooler`: learned queries, LayerNormed once and
    projected, cross-attend the vision tokens (torch MHA with kdim/vdim =
    the context width). The queries are broadcast over the batch as a
    contiguous copy: the attention kernel does not read a batch stride of 0.
  * :class:`CoCaTextTower`: the CLIP text tower with ``cls_emb`` appended at
    the END of the sequence and one more positional row; an additive causal +
    pad mask (:func:`coca_cls_attn_mask`), pooled = the last position,
    ln_final'd and projected. The returned tokens are the trunk's output
    before ``ln_final``.
  * :class:`MultimodalDecoder`: per layer a causal self block and a cross
    block (``ln_1`` on the queries, ``ln_1_kv`` on the image tokens, its MLP
    linear -> exact GELU -> linear), then ``ln_final`` and the projection to
    the vocabulary.
  * :class:`CoCa`: the vision tower (patch embedding, CLS, trunk, the pooler
    over ``n_queries + 1`` queries, ``ln_post`` and ``proj`` at
    ``embed_dim``), the text tower, the decoder and ``logit_scale``.

The loss is ``train.losses.coca_loss``. Decoding, as in JAX, keeps every
sequence in a fixed [_, seq_len] buffer and re-decodes the whole buffer each
step, reading the logits at the current position (exact: the decoder is
causal): :func:`coca_generate_greedy` (fp32), and :func:`coca_generate` with
beam search or top-k / top-p sampling from a ``torch.Generator``.

Kernels: in bf16, every trunk block's MLP half (vision, text and decoder
self blocks) goes through the fused-MLP kernel, and every unmasked attention
(the vision trunk, the pooler, the decoder's cross blocks) through the
attention kernel; the text tower and the decoder's self blocks are masked and
take the plain path; the cross blocks' MLP is plain, as in JAX.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from vitlens_tpu_torch.config import TextArch, TowerConfig, VisionArch
from vitlens_tpu_torch.models.layers import (LayerNorm, ResBlock, Transformer,
                                             _param, gelu, normal_, uniform_)
from vitlens_tpu_torch.models.text import TextTower
from vitlens_tpu_torch.models.vit import VisionTower
from vitlens_tpu_torch.ops.attention import causal_mask, dot_product_attention


@dataclass(frozen=True)
class MultimodalArch:
    """multimodal_cfg (coca_model.py:36-44): decoder depth etc."""

    width: int = 512
    heads: int = 8
    layers: int = 12
    context_length: int = 76
    mlp_ratio: float = 4.0


@dataclass(frozen=True)
class CoCaConfig:
    embed_dim: int = 512
    vision: VisionArch = VisionArch()
    text: TextArch = TextArch()
    multimodal: MultimodalArch = MultimodalArch()
    n_queries: int = 256  # attn pooler queries (+1 contrastive query row)
    attn_pooler_heads: int = 8  # reference CLIPVisionCfg.attn_pooler_heads
    pad_id: int = 0
    caption_loss_weight: float = 2.0
    contrastive_loss_weight: float = 1.0


def make_coca_config(name: str) -> CoCaConfig:
    """Named presets transcribed from the reference model_configs
    (coca_ViT-B-32.json / coca_ViT-L-14.json)."""
    if name == "coca_ViT-B-32":
        return CoCaConfig(
            embed_dim=512,
            vision=VisionArch(image_size=224, patch_size=32, width=768,
                              layers=12),
            text=TextArch(context_length=76, width=512, heads=8, layers=12),
            multimodal=MultimodalArch(context_length=76, width=512, heads=8,
                                      layers=12),
            attn_pooler_heads=8,
        )
    if name == "coca_ViT-L-14":
        return CoCaConfig(
            embed_dim=768,
            vision=VisionArch(image_size=224, patch_size=14, width=1024,
                              layers=24),
            text=TextArch(context_length=76, width=768, heads=12, layers=12),
            multimodal=MultimodalArch(context_length=76, width=768, heads=12,
                                      layers=12),
            attn_pooler_heads=8,
        )
    raise KeyError(f"unknown coca config {name!r}")


def _kaiming_uniform_(t: torch.Tensor, g: torch.Generator) -> None:
    """torch nn.Linear's default weight init in the [in, out] layout (JAX
    ``L._kaiming_uniform``)."""
    uniform_(t, math.sqrt(1.0 / t.shape[0]) * math.sqrt(3.0), g)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, N, D] -> the [B, H, N, D / H] view."""
    B, N, D = t.shape
    return t.view(B, N, heads, D // heads).transpose(1, 2)


def _merge_heads(o: torch.Tensor) -> torch.Tensor:
    """[B, H, N, Dh] -> [B, N, H * Dh]."""
    B, H, N, dh = o.shape
    return o.transpose(1, 2).reshape(B, N, H * dh)


# ---------------------------------------------------------------------------
# attentional pooler
# ---------------------------------------------------------------------------


class AttentionalPooler(nn.Module):
    """x [B, N, context_dim] -> [B, n_queries, d_model]."""

    def __init__(self, d_model: int, context_dim: int, n_queries: int = 256,
                 device=None):
        super().__init__()
        self.query = _param(n_queries, d_model, device=device)
        self.ln_q = LayerNorm(d_model, device=device)
        self.ln_k = LayerNorm(context_dim, device=device)
        self.q_w = _param(d_model, d_model, device=device)
        self.k_w = _param(context_dim, d_model, device=device)
        self.v_w = _param(context_dim, d_model, device=device)
        self.qkv_b = _param(3 * d_model, device=device)
        self.out_w = _param(d_model, d_model, device=device)
        self.out_b = _param(d_model, device=device)

    def init_(self, g: torch.Generator) -> None:
        normal_(self.query, 1.0, g)
        self.ln_q.init_(g)
        self.ln_k.init_(g)
        for w in (self.q_w, self.k_w, self.v_w, self.out_w):
            _kaiming_uniform_(w, g)
        with torch.no_grad():
            self.qkv_b.zero_()
            self.out_b.zero_()

    def forward(self, x: torch.Tensor, heads: int) -> torch.Tensor:
        B = x.shape[0]
        dt = x.dtype
        k_in = self.ln_k(x)
        q_in = self.ln_q(self.query.to(dt)[None])
        qb, kb, vb = self.qkv_b.to(dt).chunk(3)
        q = q_in @ self.q_w.to(dt) + qb
        k = k_in @ self.k_w.to(dt) + kb
        v = k_in @ self.v_w.to(dt) + vb
        q = _heads(q, heads)
        o = dot_product_attention(q.expand(B, *q.shape[1:]).contiguous(),
                                  _heads(k, heads), _heads(v, heads))
        return _merge_heads(o) @ self.out_w.to(dt) + self.out_b.to(dt)


# ---------------------------------------------------------------------------
# text tower with embed_cls
# ---------------------------------------------------------------------------


def coca_cls_attn_mask(text: torch.Tensor, pad_id: int = 0) -> torch.Tensor:
    """Causal + cls pad mask of the CLS-extended text tower (the reference
    build_cls_mask, transformer.py:879-889): only the LAST query row (CLS)
    is pad-masked, key j attendable iff j == 0 or text[j-1] != pad. Returns
    the additive fp32 [B, 1, T+1, T+1]."""
    B, T = text.shape
    seq = T + 1
    cmask = causal_mask(seq, device=text.device)
    valid = torch.cat([torch.ones(B, 1, dtype=torch.bool, device=text.device),
                       text != pad_id], dim=1)  # keys, shifted
    last = (torch.arange(seq, device=text.device) == seq - 1)[None, :, None]
    cls_pad = torch.zeros(B, seq, seq, device=text.device).masked_fill(
        last & ~valid[:, None, :], float("-inf"))
    return cmask[None, None] + cls_pad[:, None]


class CoCaTextTower(TextTower):
    """The text tower with ``cls_emb`` and ``context_length + 1`` positions.
    ``forward`` returns (pooled [B, E], token_embs [B, T, width])."""

    def __init__(self, cfg: TextArch, embed_dim: int, device=None):
        super().__init__(cfg, embed_dim, device=device)
        self.positional_embedding = _param(cfg.context_length + 1, cfg.width,
                                           device=device)
        self.cls_emb = _param(cfg.width, device=device)

    def init_(self, g: torch.Generator) -> None:
        super().init_(g)  # the extra positional row is 0.01 normal too
        normal_(self.cls_emb, 0.01, g)

    def forward(self, text: torch.Tensor, compute_dtype=torch.float32, *,
                pad_id: int = 0):
        B, T = text.shape
        x = self.token_embedding[text].to(compute_dtype)
        cls = self.cls_emb.to(x.dtype).expand(B, 1, x.shape[-1])
        x = torch.cat([x, cls], dim=1)
        x = x + self.positional_embedding[:T + 1].to(x.dtype)
        x = self.trunk(x, mask=coca_cls_attn_mask(text, pad_id))
        pooled, tokens = x[:, -1], x[:, :-1]
        pooled = self.ln_final(pooled)
        return pooled @ self.text_projection.to(pooled.dtype), tokens


# ---------------------------------------------------------------------------
# multimodal decoder
# ---------------------------------------------------------------------------


class CrossBlock(ResBlock):
    """The cross-attention resblock (reference transformer.py:253-272 with
    k_x/v_x): a resblock's parameters plus ``ln_1_kv``; the packed
    ``qkv_w`` split into q (on the text) and k, v (on the image tokens)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0,
                 device=None):
        super().__init__(dim, heads, mlp_ratio, device=device)
        self.ln_1_kv = LayerNorm(dim, device=device)

    def init_(self, g: torch.Generator) -> None:
        super().init_(g)
        self.ln_1_kv.init_(g)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        attn = self.attn
        q_in = self.ln_1(x)
        kv_in = self.ln_1_kv(context)
        wq, wk, wv = attn.qkv_w.to(dt).chunk(3, dim=1)
        qb, kb, vb = attn.qkv_b.to(dt).chunk(3)
        q = _heads(q_in @ wq + qb, attn.heads)
        k = _heads(kv_in @ wk + kb, attn.heads)
        v = _heads(kv_in @ wv + vb, attn.heads)
        o = _merge_heads(dot_product_attention(q, k, v))
        x = x + (o @ attn.out_w.to(dt) + attn.out_b.to(dt))
        h = self.mlp.proj(gelu(self.mlp.fc(self.ln_2(x))))
        return x + h


class MultimodalDecoder(nn.Module):
    """(image tokens [B, Ni, W], text tokens [B, T, W]) -> vocab logits
    [B, T, vocab] (reference MultimodalTransformer.forward :1003-1030)."""

    def __init__(self, cfg: MultimodalArch, vocab_size: int, device=None):
        super().__init__()
        self.cfg = cfg
        self.resblocks = Transformer(cfg.width, cfg.layers, cfg.heads,
                                     cfg.mlp_ratio, device=device)
        self.cross_attn = nn.Module()
        self.cross_attn.blocks = nn.ModuleList(
            CrossBlock(cfg.width, cfg.heads, cfg.mlp_ratio, device=device)
            for _ in range(cfg.layers))
        self.ln_final = LayerNorm(cfg.width, device=device)
        self.text_projection = _param(cfg.width, vocab_size, device=device)

    def init_(self, g: torch.Generator) -> None:
        self.resblocks.init_(g)
        for blk in self.cross_attn.blocks:
            blk.init_(g)
        self.ln_final.init_(g)
        normal_(self.text_projection, self.cfg.width ** -0.5, g)

    def forward(self, image_embs: torch.Tensor,
                text_embs: torch.Tensor) -> torch.Tensor:
        seq = text_embs.shape[1]
        mask = causal_mask(self.cfg.context_length,
                           device=text_embs.device)[:seq, :seq]
        x = text_embs
        for sa, ca in zip(self.resblocks.blocks, self.cross_attn.blocks):
            x = sa(x, mask)
            x = ca(x, image_embs)
        x = self.ln_final(x)
        return x @ self.text_projection.to(x.dtype)


# ---------------------------------------------------------------------------
# CoCa composition
# ---------------------------------------------------------------------------


class CoCaVisionTower(VisionTower):
    """The image tower with the attentional pooler; ``ln_post`` and ``proj``
    at ``embed_dim``, after the pooler."""

    def __init__(self, cfg: CoCaConfig, device=None):
        super().__init__(TowerConfig(arch=cfg.vision, embed_dim=cfg.embed_dim,
                                     modality="image"), device=device)
        self.attn_pool = AttentionalPooler(cfg.embed_dim, cfg.vision.width,
                                           cfg.n_queries + 1, device=device)
        self.ln_post = LayerNorm(cfg.embed_dim, device=device)
        self.proj = _param(cfg.embed_dim, cfg.embed_dim, device=device)
        self.pooler_heads = cfg.attn_pooler_heads

    def init_(self, g: torch.Generator) -> None:
        super().init_(g)
        self.attn_pool.init_(g)
        normal_(self.proj, self.proj.shape[0] ** -0.5, g)

    def forward(self, images: torch.Tensor, compute_dtype=torch.float32):
        """images [B, 3, H, W] -> (latent [B, E], tokens [B, n_queries, E])
        (the reference attentional-pool path, transformer.py:778-787)."""
        tokens, _ = self.adapter(images.to(compute_dtype))
        B, _, width = tokens.shape
        cls = self.class_embedding.to(tokens.dtype).expand(B, 1, width)
        h = torch.cat([cls, tokens], dim=1)
        h = h + self.positional_embedding.to(h.dtype)
        h = self.trunk(self.ln_pre(h))
        h = self.ln_post(self.attn_pool(h, self.pooler_heads))
        latent, tokens_out = h[:, 0], h[:, 1:]
        return latent @ self.proj.to(latent.dtype), tokens_out


def _normalize(v: torch.Tensor) -> torch.Tensor:
    """v / max(||v||, 1e-12), the norm in fp32 cast to v's dtype."""
    return v / v.float().norm(dim=-1, keepdim=True).clamp_min(1e-12).to(v.dtype)


class CoCa(nn.Module):
    """``coca_init``'s tree: ``visual``, ``text``, ``text_decoder`` and
    ``logit_scale`` (log 1/0.07)."""

    def __init__(self, cfg: CoCaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.visual = CoCaVisionTower(cfg, device=device)
        self.text = CoCaTextTower(cfg.text, cfg.embed_dim, device=device)
        self.text_decoder = MultimodalDecoder(cfg.multimodal,
                                              cfg.text.vocab_size,
                                              device=device)
        self.logit_scale = nn.Parameter(torch.empty((), device=device),
                                        requires_grad=False)

    def init_(self, g: torch.Generator) -> None:
        self.visual.init_(g)
        self.text.init_(g)
        self.text_decoder.init_(g)
        with torch.no_grad():
            self.logit_scale.fill_(math.log(1 / 0.07))

    def encode_image(self, images: torch.Tensor, compute_dtype=torch.float32):
        """(latent [B, E], token embeds [B, n_queries, E])."""
        return self.visual(images, compute_dtype)

    def encode_text(self, text: torch.Tensor, compute_dtype=torch.float32):
        """(pooled [B, E], token embeds [B, T, width])."""
        return self.text(text, compute_dtype, pad_id=self.cfg.pad_id)

    def forward(self, images: torch.Tensor, text: torch.Tensor,
                compute_dtype=torch.float32) -> Dict[str, torch.Tensor]:
        """The reference CoCa.forward (coca_model.py:158-173): the text
        tower reads ``text[:, :-1]`` (space for CLS), the labels are the
        last T columns."""
        text_latent, token_embs = self.encode_text(text[:, :-1], compute_dtype)
        image_latent, image_embs = self.encode_image(images, compute_dtype)
        labels = text[:, -token_embs.shape[1]:]
        logits = self.text_decoder(image_embs, token_embs)
        return {"image_features": _normalize(image_latent),
                "text_features": _normalize(text_latent),
                "logits": logits, "labels": labels,
                "logit_scale": self.logit_scale.exp()}


def make_coca(name: str = "coca_ViT-L-14", *, device=None, seed: int = 0,
              dtype: torch.dtype = torch.float32) -> CoCa:
    """The named CoCa (:func:`make_coca_config`) on ``device`` (the CUDA
    device unless given), drawn from a generator seeded with ``seed``, its
    matmul weights cast to ``dtype``."""
    from vitlens_tpu_torch.factory import (cast_matmul_weights_, make_generator,
                                           resolve_device)

    device = resolve_device(device)
    model = CoCa(make_coca_config(name), device=device)
    model.init_(make_generator(seed, device))
    return cast_matmul_weights_(model, dtype)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------
#
# The reference grows `out` one column a step (coca_model.py:175-491, built
# on HuggingFace GenerationMixin pieces). As in the JAX package, every
# sequence here lives in a fixed [_, seq_len] buffer and each step decodes
# the whole buffer and reads the logits at the current position. Semantics,
# as in JAX:
#  * beam search accumulates RAW decoder logits (the reference skips HF's
#    log_softmax);
#  * beam groups are independent width-(num_beams / num_beam_groups)
#    searches folded into the batch; group 0 is returned;
#  * finalisation follows t5x: an entry returns its best finished hypothesis
#    if any beam finished, else its best live beam;
#  * ties in every top-k and sort go to the lower index, as lax.top_k and
#    the stable jnp.argsort break them;
#  * the output is a fixed [B, seq_len] buffer padded after EOS;
#    fixed_output_length=False trims trailing all-pad columns on the host.


def _top_k(x: torch.Tensor, k: int):
    """lax.top_k over the last axis: the k largest, descending, ties to the
    lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _decode_pos_logits(model: CoCa, image_embs, tokens, pos: int,
                       compute_dtype=torch.float32) -> torch.Tensor:
    """Decode a padded [N, L] buffer; the vocab logits at ``pos`` [N, V]."""
    _, token_embs = model.encode_text(tokens, compute_dtype)
    return model.text_decoder(image_embs, token_embs)[:, pos]


def _min_length_mask(scores, cur_len, min_seq_len, eos_id):
    """HF MinLengthLogitsProcessor: EOS impossible before min_seq_len."""
    if cur_len >= min_seq_len:
        return scores
    scores = scores.clone()
    scores[:, eos_id] = float("-inf")
    return scores


def _repetition_penalty(scores, tokens, valid, penalty):
    """HF RepetitionPenaltyLogitsProcessor over a fixed buffer: for every
    token already in the valid part of the prefix, positive scores divide
    by ``penalty``, negative multiply."""
    if penalty == 1.0:
        return scores
    seen = torch.zeros(scores.shape, device=scores.device).scatter_add_(
        1, tokens.long(), valid.float()) > 0
    pen = torch.where(scores > 0, scores / penalty, scores * penalty)
    return torch.where(seen, pen, scores)


def _top_k_warp(scores, top_k: int):
    """HF TopKLogitsWarper: everything below the k-th largest -> -inf."""
    kth = _top_k(scores, top_k)[0][:, -1:]
    return scores.masked_fill(scores < kth, float("-inf"))


def _top_p_warp(scores, top_p: float):
    """HF TopPLogitsWarper: drop a token when the probability mass of
    strictly-higher-ranked tokens already covers top_p (rank 0 always
    kept). The order is the stable argsort of -scores."""
    order = torch.sort(-scores, dim=-1, stable=True).indices
    sorted_scores = scores.gather(-1, order)
    probs = torch.softmax(sorted_scores, dim=-1)
    mass_before = probs.cumsum(-1) - probs
    remove = mass_before >= top_p
    remove[:, 0] = False
    warped = sorted_scores.masked_fill(remove, float("-inf"))
    return torch.empty_like(warped).scatter_(-1, order, warped)


def _categorical(generator: torch.Generator, logits: torch.Tensor):
    """One draw a row from softmax(logits), by the Gumbel-max trick (what
    jax.random.categorical does), with uniforms from ``generator``."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(logits.shape, generator=generator,
                   device=logits.device).clamp_min(tiny)
    return (logits - torch.log(-torch.log(u))).argmax(dim=-1)


def _generate_sample(model, image_embs, generator, *, B, seq_len, temperature,
                     warper, min_seq_len, repetition_penalty, sot_id, eos_id,
                     pad_id, compute_dtype):
    """Sampling loop (reference generate() while-loop, coca_model.py:268-317):
    finished rows append pad; the final position is forced to EOS."""
    dev = image_embs.device
    out = torch.full((B, seq_len), pad_id, dtype=torch.long, device=dev)
    out[:, 0] = sot_id
    ar = torch.arange(seq_len, device=dev)
    for pos in range(1, seq_len):
        logits = _decode_pos_logits(model, image_embs, out, pos - 1,
                                    compute_dtype).float()
        last = out[:, pos - 1]
        finished = (last == eos_id) | ((last == pad_id) & (pos > 1))
        valid = (ar < pos)[None].expand(B, seq_len)
        logits = _min_length_mask(logits, pos, min_seq_len, eos_id)
        logits = _repetition_penalty(logits, out, valid, repetition_penalty)
        logits = warper(logits)
        sample = _categorical(generator, logits / temperature)
        if pos + 1 == seq_len:
            sample = torch.full_like(sample, eos_id)
        out[:, pos] = torch.where(finished, torch.full_like(sample, pad_id),
                                  sample)
    return out


def _generate_beam(model, image_embs, *, B, seq_len, n_beams, min_seq_len,
                   repetition_penalty, sot_id, eos_id, pad_id, compute_dtype):
    """Static-shape beam search (reference _generate_beamsearch,
    coca_model.py:322-491). image_embs is already beam-expanded
    [B*S, Ni, W]. Scores accumulate raw logits (reference quirk); finished
    hypotheses are length-normalised (HF length_penalty=1.0)."""
    S, L = n_beams, seq_len
    dev = image_embs.device
    NEG = -1e9
    live = torch.full((B, S, L), pad_id, dtype=torch.long, device=dev)
    live[:, :, 0] = sot_id
    lscore = torch.full((B, S), NEG, device=dev)
    lscore[:, 0] = 0.0
    fin = live.clone()
    fscore = torch.full((B, S), float("-inf"), device=dev)
    valid_all = torch.arange(L, device=dev)[None]
    for pos in range(1, L):
        flat = live.reshape(B * S, L)
        logits = _decode_pos_logits(model, image_embs, flat, pos - 1,
                                    compute_dtype).float()
        logits = _min_length_mask(logits, pos, min_seq_len, eos_id)
        logits = _repetition_penalty(logits, flat,
                                     (valid_all < pos).expand(B * S, L),
                                     repetition_penalty)
        V = logits.shape[-1]
        cand = lscore[:, :, None] + logits.reshape(B, S, V)
        # 2S candidates so S survive even if S end in EOS (HF 2*group_size)
        top_sc, top_ix = _top_k(cand.reshape(B, S * V), 2 * S)
        src_beam, tok = top_ix // V, top_ix % V
        seqs = live.gather(1, src_beam[:, :, None].expand(B, 2 * S, L)).clone()
        seqs[:, :, pos] = tok
        is_eos = tok == eos_id
        # finished pool: normalised by the hypothesis length (pos tokens
        # before EOS); EOS itself is kept out of the stored sequence
        new_f = torch.where(is_eos, top_sc / pos,
                            torch.full_like(top_sc, float("-inf")))
        f_seqs = seqs.clone()
        f_seqs[:, :, pos] = torch.where(is_eos, torch.full_like(tok, pad_id),
                                        tok)
        all_f = torch.cat([fscore, new_f], dim=1)  # [B, 3S]
        all_fs = torch.cat([fin, f_seqs], dim=1)
        fscore, f_ix = _top_k(all_f, S)
        fin = all_fs.gather(1, f_ix[:, :, None].expand(B, S, L))
        # live pool: the best S non-EOS candidates
        live_sc = top_sc.masked_fill(is_eos, float("-inf"))
        l_sc, l_ix = _top_k(live_sc, S)
        live = seqs.gather(1, l_ix[:, :, None].expand(B, S, L))
        lscore = l_sc.clamp_min(NEG)  # -inf + logit stays ordered
    # finalise: the best finished if any beam finished, else the best live
    # (normalised by the full length, HF finalize on non-done hypotheses)
    any_fin = torch.isfinite(fscore[:, 0])
    best = (lscore / float(L)).argmax(dim=1)
    best_live = live[torch.arange(B, device=dev), best]
    return torch.where(any_fin[:, None], fin[:, 0], best_live)


@torch.no_grad()
def coca_generate_greedy(model: CoCa, images: torch.Tensor, sot_token: int,
                         eot_token: int, seq_len: int = 20) -> torch.Tensor:
    """Minimal greedy decoding in fp32 (reference generate(),
    coca_model.py:175+): [B, seq_len + 1] token ids, the sequence grown one
    column a step. Full sampling and beam decoding: :func:`coca_generate`."""
    B = images.shape[0]
    _, image_embs = model.encode_image(images)
    out = torch.full((B, 1), sot_token, dtype=torch.long, device=images.device)
    for _ in range(seq_len):
        _, token_embs = model.encode_text(out)
        logits = model.text_decoder(image_embs, token_embs)
        out = torch.cat([out, logits[:, -1].argmax(dim=-1)[:, None]], dim=1)
    return out


@torch.no_grad()
def coca_generate(model: CoCa, images: torch.Tensor, *,
                  generator: Optional[torch.Generator] = None,
                  seq_len: int = 30, temperature: float = 1.0,
                  generation_type: str = "beam_search", top_p: float = 0.1,
                  top_k: int = 1, pad_token_id: Optional[int] = None,
                  eos_token_id: int = 49407, sot_token_id: int = 49406,
                  num_beams: int = 6, num_beam_groups: int = 3,
                  min_seq_len: int = 5, repetition_penalty: float = 1.0,
                  fixed_output_length: bool = True,
                  compute_dtype=torch.float32) -> torch.Tensor:
    """Caption generation (reference generate(), coca_model.py:175-320).

    generation_type: "beam_search" | "top_p" | "top_k". Returns int64
    [B, seq_len] token ids (pad-filled after EOS); fixed_output_length=False
    trims trailing all-pad columns on the host. The sampling modes draw from
    ``generator`` (on the images' device), which they require."""
    if not seq_len > min_seq_len:
        raise ValueError("seq_len must be larger than min_seq_len")
    pad_id = model.cfg.pad_id if pad_token_id is None else pad_token_id
    B = images.shape[0]
    _, image_embs = model.encode_image(images, compute_dtype)
    kw = dict(seq_len=seq_len, min_seq_len=min_seq_len,
              repetition_penalty=repetition_penalty, sot_id=sot_token_id,
              eos_id=eos_token_id, pad_id=pad_id, compute_dtype=compute_dtype)
    if generation_type == "beam_search":
        if num_beams % num_beam_groups:
            raise ValueError("num_beams must be divisible by num_beam_groups")
        G, sub = num_beam_groups, num_beams // num_beam_groups
        embs = image_embs.repeat_interleave(G * sub, dim=0)  # [B*G*sub, Ni, W]
        out = _generate_beam(model, embs, B=B * G, n_beams=sub, **kw)
        out = out.reshape(B, G, seq_len)[:, 0]  # groups identical; take 0
    elif generation_type in ("top_p", "top_k"):
        if generator is None:
            raise ValueError(f"{generation_type} sampling needs a generator")
        if generation_type == "top_p":
            def warper(s):
                return _top_p_warp(s, top_p)
        else:
            def warper(s):
                return _top_k_warp(s, top_k)
        out = _generate_sample(model, image_embs, generator, B=B,
                               temperature=temperature, warper=warper, **kw)
    else:
        raise ValueError(
            "generation_type has to be one of | beam_search | top_p | top_k |")
    if not fixed_output_length:
        arr = out.cpu().numpy()
        used = (arr != pad_id).any(axis=0)
        last = int(np.max(np.nonzero(used)[0])) + 1 if used.any() else 1
        return out[:, :last]
    return out
