"""Reference-layout checkpoints and audio files made from a seed, for the
tests and chip_smoke.py. Imports torch, numpy and the port's config only.

State dicts in the reference's key layout (what
``vitlens_tpu_torch/weights/torch_convert.py`` reads):

  * :func:`vision_tower_state_dict`: one VisionTransformer's keys relative to
    the tower: the open_clip trunk (``conv1.weight`` for the image and
    tactile towers, ``class_embedding``, ``positional_embedding``,
    ``ln_pre``, ``transformer.resblocks.{i}.*``, ``ln_post``, ``proj``), the
    Lens (``perceiver.latents``, ``perceiver.layers.{i}.{0,1,2}.*``; the
    transformer Lens's ``perceiver.resblocks.{i}.*``; no key for the
    identity Lens) and the adapters (``conv1.weight`` and ``ltpos.weight`` of
    video, ``visual_adapter.conv1.weight`` / ``pos_emb`` of depth and AST
    audio, ``visual_adapter.proj.*`` / ``pos_emb`` of EEG,
    ``visual_adapter.encoder.first_conv.*`` ... of PointBERT,
    ``visual_adapter.sa.mlp_convs.*`` / ``sa.mlp_bns.*`` / ``lift.*`` of
    PNSA);
  * :func:`text_tower_state_dict`: the CLIP text keys (``token_embedding``,
    ``positional_embedding``, ``transformer.resblocks.{i}.*``,
    ``ln_final``, ``text_projection``);
  * :func:`clip_state_dict`: a two-tower CLIP file (``visual.*`` + the text
    keys at the top level + ``logit_scale``); :func:`merged_state_dict`: a
    merged ViT-Lens export (``vitlens.{modality}.*``);
  * the OpenShape pc baselines' files, :func:`ppat_state_dict`,
    :func:`dgcnn_state_dict` and :func:`pointnet2_state_dict`, and the
    PointBERT classifier's, :func:`point_transformer_state_dict`;
  * :func:`eva_state_dict` (BLIP-2's EVA ViT-g), :func:`modified_resnet_state_dict`
    (open_clip's ModifiedResNet) and :func:`hf_bert_state_dict` (transformers'
    BertModel / RobertaModel).

Values come from a ``torch.Generator`` at open_clip's init scales (LayerNorm
and BatchNorm parameters perturbed from 1 and 0, so that a load that drops
them shows), drawn on the generator's device and stored on the CPU in
``dtype``.

Audio: :func:`write_wav` (8-, 16- and 32-bit PCM through ``wave``) and
:func:`write_flac`, a minimal FLAC encoder (verbatim or fixed-predictor
subframes with Rice-coded residuals, independent, left/side or mid/side
stereo, 8- to 24-bit, STREAMINFO with the PCM's MD5).
"""

from __future__ import annotations

import hashlib
import wave
from typing import Dict, Optional

import numpy as np
import torch

from vitlens_tpu_torch.config import (ModelConfig, PerceiverConfig, TextArch,
                                      TowerConfig, image_tower_config)

StateDict = Dict[str, torch.Tensor]


class _Maker:
    def __init__(self, gen: torch.Generator, dtype: torch.dtype):
        self.gen, self.dtype = gen, dtype

    def normal(self, shape, std: float, mean: float = 0.0) -> torch.Tensor:
        t = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                        device=self.gen.device)
        return (t * std + mean).to(self.dtype).cpu()

    def ln(self, sd: StateDict, name: str, dim: int) -> None:
        sd[f"{name}.weight"] = self.normal((dim,), 0.02, 1.0)
        sd[f"{name}.bias"] = self.normal((dim,), 0.02)

    def linear(self, sd: StateDict, name: str, n_in: int, n_out: int,
               std: Optional[float] = None, bias: bool = True) -> None:
        sd[f"{name}.weight"] = self.normal(
            (n_out, n_in), n_in ** -0.5 if std is None else std)
        if bias:
            sd[f"{name}.bias"] = self.normal((n_out,), 0.02)

    def bn(self, sd: StateDict, name: str, dim: int) -> None:
        self.ln(sd, name, dim)
        sd[f"{name}.running_mean"] = self.normal((dim,), 0.1)
        sd[f"{name}.running_var"] = (
            1.0 + self.normal((dim,), 0.1).float().abs()).to(self.dtype)
        sd[f"{name}.num_batches_tracked"] = torch.tensor(1000)


def _resblocks(mk: _Maker, sd: StateDict, prefix: str, width: int,
               layers: int, mlp_ratio: float = 4.0,
               ls: Optional[float] = None) -> None:
    """open_clip's Transformer keys under ``prefix`` (…``resblocks.{i}.``)."""
    hidden = int(width * mlp_ratio)
    attn_std = width ** -0.5
    proj_std = attn_std * (2 * layers) ** -0.5
    for i in range(layers):
        p = f"{prefix}resblocks.{i}."
        mk.ln(sd, p + "ln_1", width)
        sd[p + "attn.in_proj_weight"] = mk.normal((3 * width, width), attn_std)
        sd[p + "attn.in_proj_bias"] = mk.normal((3 * width,), 0.02)
        mk.linear(sd, p + "attn.out_proj", width, width, proj_std)
        mk.ln(sd, p + "ln_2", width)
        mk.linear(sd, p + "mlp.c_fc", width, hidden, (2 * width) ** -0.5)
        mk.linear(sd, p + "mlp.c_proj", hidden, width, proj_std)
        if ls is not None:
            sd[p + "ls_1.gamma"] = mk.normal((width,), 0.01, ls)
            sd[p + "ls_2.gamma"] = mk.normal((width,), 0.01, ls)


def _attention(mk: _Maker, sd: StateDict, prefix: str, q_dim: int,
               ctx_dim: int, heads: int, dim_head: int) -> None:
    inner = heads * dim_head
    mk.linear(sd, prefix + "to_q", q_dim, inner, bias=False)
    mk.linear(sd, prefix + "to_kv", ctx_dim, 2 * inner, bias=False)
    mk.linear(sd, prefix + "to_out", inner, q_dim)


def _geglu(mk: _Maker, sd: StateDict, prefix: str, dim: int, mult: int) -> None:
    mk.linear(sd, prefix + "net.0", dim, 2 * mult * dim)
    mk.linear(sd, prefix + "net.2", mult * dim, dim)


def _perceiver(mk: _Maker, sd: StateDict, cfg: PerceiverConfig) -> None:
    d = cfg.latent_dim
    sd["perceiver.latents"] = mk.normal((cfg.num_latents, d), 1.0)
    for i in range(1 if cfg.weight_tie_layers else cfg.depth):
        p = f"perceiver.layers.{i}."
        mk.ln(sd, p + "0.norm", d)
        mk.ln(sd, p + "0.norm_context", cfg.input_dim)
        _attention(mk, sd, p + "0.fn.", d, cfg.input_dim, cfg.cross_heads,
                   cfg.cross_dim_head)
        mk.ln(sd, p + "1.norm", d)
        _geglu(mk, sd, p + "1.fn.", d, cfg.ff_mult)
        for j in range(cfg.self_per_cross_attn):
            mk.ln(sd, p + f"2.{j}.0.norm", d)
            _attention(mk, sd, p + f"2.{j}.0.fn.", d, d, cfg.latent_heads,
                       cfg.latent_dim_head)
            mk.ln(sd, p + f"2.{j}.1.norm", d)
            _geglu(mk, sd, p + f"2.{j}.1.fn.", d, cfg.ff_mult)


def _adapter(mk: _Maker, sd: StateDict, cfg: TowerConfig) -> None:
    width, m = cfg.arch.width, cfg.modality
    if m in ("image", "tactile", "video"):
        p = cfg.arch.patch_size
        sd["conv1.weight"] = mk.normal((width, 3, p, p), (3 * p * p) ** -0.5)
        if m == "video" and cfg.video.use_ltpos:
            sd["ltpos.weight"] = mk.normal((cfg.video.n_frames, width), 0.02)
    elif m == "depth":
        p = cfg.arch.patch_size
        sd["visual_adapter.conv1.weight"] = mk.normal((width, 1, p, p), 1.0 / p)
        sd["visual_adapter.pos_emb"] = mk.normal((cfg.arch.num_patches, width),
                                                 width ** -0.5)
    elif m == "eeg":
        e = cfg.eeg
        fan_in = e.chans * e.window_size
        sd["visual_adapter.proj.weight"] = mk.normal(
            (width, e.chans, e.window_size), fan_in ** -0.5)
        sd["visual_adapter.proj.bias"] = mk.normal((width,), 0.02)
        sd["visual_adapter.pos_emb"] = mk.normal((e.num_patches, width),
                                                 width ** -0.5)
    elif m == "audio":
        a = cfg.audio
        sd["visual_adapter.conv1.weight"] = mk.normal(
            (width, 1, a.patch_size, a.patch_size), a.patch_size ** -1.0)
        sd["visual_adapter.pos_emb"] = mk.normal((a.num_patches, width),
                                                 width ** -0.5)
    elif m == "pc" and cfg.point.tokenizer == "pnsa":
        pt = cfg.point
        last = pt.in_channel + 3
        for i, out in enumerate((64, 64, pt.encoder_dims)):
            name = f"visual_adapter.sa.mlp_convs.{i}"
            sd[f"{name}.weight"] = mk.normal((out, last, 1, 1), last ** -0.5)
            sd[f"{name}.bias"] = mk.normal((out,), 0.02)
            mk.bn(sd, f"visual_adapter.sa.mlp_bns.{i}", out)
            last = out
        sd["visual_adapter.lift.0.weight"] = mk.normal(
            (pt.trans_dim, pt.encoder_dims + 3, 1), (pt.encoder_dims + 3) ** -0.5)
        sd["visual_adapter.lift.0.bias"] = mk.normal((pt.trans_dim,), 0.02)
        mk.ln(sd, "visual_adapter.lift.2", pt.trans_dim)
    elif m == "pc":
        pt = cfg.point
        e = "visual_adapter.encoder."
        for name, n_in, n_out in (("first_conv.0", 3, 128),
                                  ("first_conv.3", 128, 256),
                                  ("second_conv.0", 512, 512),
                                  ("second_conv.3", 512, pt.encoder_dims)):
            sd[f"{e}{name}.weight"] = mk.normal((n_out, n_in, 1), n_in ** -0.5)
            sd[f"{e}{name}.bias"] = mk.normal((n_out,), 0.02)
        mk.bn(sd, e + "first_conv.1", 128)
        mk.bn(sd, e + "second_conv.1", 512)
        mk.linear(sd, "visual_adapter.reduce_dim", pt.encoder_dims, pt.trans_dim)
        mk.linear(sd, "visual_adapter.pos_embed.0", 3, 128)
        mk.linear(sd, "visual_adapter.pos_embed.2", 128, pt.trans_dim)
    else:
        raise NotImplementedError(f"no reference layout for the {m!r} adapter")


def vision_tower_state_dict(cfg: TowerConfig, gen: torch.Generator,
                            dtype: torch.dtype = torch.float32,
                            pos_tokens: Optional[int] = None) -> StateDict:
    """One tower's keys (relative to the tower). ``pos_tokens`` sizes the
    positional embedding's grid rows (default: the tower's token count; a
    CLIP grid other than the Lens latents exercises the resize)."""
    mk = _Maker(gen, dtype)
    arch = cfg.arch
    width = arch.width
    sd: StateDict = {}
    _adapter(mk, sd, cfg)
    sd["class_embedding"] = mk.normal((width,), width ** -0.5)
    n = cfg.num_tokens if pos_tokens is None else pos_tokens
    sd["positional_embedding"] = mk.normal((n + 1, width), width ** -0.5)
    mk.ln(sd, "ln_pre", width)
    _resblocks(mk, sd, "transformer.", width, arch.layers, arch.mlp_ratio,
               arch.ls_init_value)
    mk.ln(sd, "ln_post", width)
    sd["proj"] = mk.normal((width, cfg.embed_dim), width ** -0.5)
    perc = cfg.perceiver
    if perc is not None and perc.as_transformer:
        _resblocks(mk, sd, "perceiver.", width, perc.depth, arch.mlp_ratio,
                   arch.ls_init_value)
    elif perc is not None and not perc.as_identity:
        _perceiver(mk, sd, perc)
    return sd


def text_tower_state_dict(text: TextArch, embed_dim: int,
                          gen: torch.Generator,
                          dtype: torch.dtype = torch.float32) -> StateDict:
    """The CLIP text tower's keys, as a CLIP file holds them at its top level."""
    mk = _Maker(gen, dtype)
    w = text.width
    sd: StateDict = {
        "token_embedding.weight": mk.normal((text.vocab_size, w), 0.02),
        "positional_embedding": mk.normal((text.context_length, w), 0.01),
    }
    _resblocks(mk, sd, "transformer.", w, text.layers, 4.0, text.ls_init_value)
    mk.ln(sd, "ln_final", w)
    sd["text_projection"] = mk.normal((w, embed_dim), w ** -0.5)
    return sd


def clip_state_dict(cfg: ModelConfig, gen: torch.Generator,
                    dtype: torch.dtype = torch.float32) -> StateDict:
    """A two-tower open_clip CLIP file: the image tower under ``visual.``,
    the text tower at the top level, and ``logit_scale``."""
    sd = {"visual." + k: v for k, v in vision_tower_state_dict(
        image_tower_config(cfg), gen, dtype).items()}
    sd.update(text_tower_state_dict(cfg.text, cfg.embed_dim, gen, dtype))
    sd["logit_scale"] = torch.tensor(float(np.log(1 / 0.07)))
    return sd


def merged_state_dict(towers: Dict[str, StateDict]) -> StateDict:
    """A merged ViT-Lens export: each tower's keys under
    ``vitlens.{modality}.``."""
    return {f"vitlens.{m}.{k}": v for m, sd in towers.items()
            for k, v in sd.items()}


# ---------------------------------------------------------------------------
# OpenShape pc baselines and the PointBERT classifier
# ---------------------------------------------------------------------------


def _conv2d(mk: _Maker, sd: StateDict, name: str, n_in: int, n_out: int,
            bias: bool = True) -> None:
    sd[f"{name}.weight"] = mk.normal((n_out, n_in, 1, 1), n_in ** -0.5)
    if bias:
        sd[f"{name}.bias"] = mk.normal((n_out,), 0.02)


def _conv1d(mk: _Maker, sd: StateDict, name: str, n_in: int,
            n_out: int) -> None:
    sd[f"{name}.weight"] = mk.normal((n_out, n_in, 1), n_in ** -0.5)
    sd[f"{name}.bias"] = mk.normal((n_out,), 0.02)


def _set_abstraction(mk: _Maker, sd: StateDict, prefix: str, n_in: int,
                     mlp) -> None:
    """PointNetSetAbstraction's ``mlp_convs.{i}`` / ``mlp_bns.{i}``."""
    for i, out in enumerate(mlp):
        _conv2d(mk, sd, f"{prefix}mlp_convs.{i}", n_in, out)
        mk.bn(sd, f"{prefix}mlp_bns.{i}", out)
        n_in = out


def ppat_state_dict(scaling: int, gen: torch.Generator, in_channel: int = 6,
                    out_channel: int = 1280,
                    dtype: torch.dtype = torch.float32) -> StateDict:
    """OpenShape's Projected(PointPatchTransformer, Linear) keys
    (ppat.py:86-156): ``ppat.sa.*``, ``ppat.lift.{0,2}``,
    ``ppat.cls_token``, ``ppat.transformer.layers.{l}.{0,1}.*`` and
    ``proj``."""
    from vitlens_tpu_torch.models.pc_baselines import (PPAT_DIM_HEAD,
                                                       PPAT_SCALINGS)

    mk, cfg = _Maker(gen, dtype), PPAT_SCALINGS[scaling]
    dim, inner = cfg["dim"], cfg["heads"] * PPAT_DIM_HEAD
    sd: StateDict = {}
    _set_abstraction(mk, sd, "ppat.sa.", in_channel + 3,
                     (64, 64, cfg["sa_dim"]))
    _conv1d(mk, sd, "ppat.lift.0", cfg["sa_dim"] + 3, dim)
    mk.ln(sd, "ppat.lift.2", dim)
    sd["ppat.cls_token"] = mk.normal((dim,), 1.0)
    for layer in range(cfg["depth"]):
        p = f"ppat.transformer.layers.{layer}."
        mk.ln(sd, p + "0.norm", dim)
        mk.linear(sd, p + "0.fn.to_qkv", dim, 3 * inner, bias=False)
        mk.linear(sd, p + "0.fn.to_out.0", inner, dim)
        mk.ln(sd, p + "1.norm", dim)
        mk.linear(sd, p + "1.fn.net.0", dim, cfg["mlp_dim"])
        mk.linear(sd, p + "1.fn.net.3", cfg["mlp_dim"], dim)
    mk.linear(sd, "proj", dim, out_channel)
    return sd


def dgcnn_state_dict(gen: torch.Generator, in_channel: int = 6,
                     out_channel: int = 1280, scaling: float = 1,
                     dtype: torch.dtype = torch.float32) -> StateDict:
    """DGCNN's keys (dgcnn.py:67-101): bias-free ``conv{1..4}.0`` (Conv2d)
    and ``conv5.0`` (Conv1d), BatchNorms under ``bn{i}.bn``, ``linear1``
    (no bias), ``bn6``, ``linear2``."""
    mk, base = _Maker(gen, dtype), int(64 * scaling)
    dims = [(in_channel * 2, base), (base * 2, base), (base * 2, base * 2),
            (base * 4, base * 4), (base * 8, base * 16)]
    sd: StateDict = {}
    for i, (n_in, n_out) in enumerate(dims, 1):
        if i < 5:
            _conv2d(mk, sd, f"conv{i}.0", n_in, n_out, bias=False)
        else:
            sd["conv5.0.weight"] = mk.normal((n_out, n_in, 1), n_in ** -0.5)
        mk.bn(sd, f"bn{i}.bn", n_out)
    mk.linear(sd, "linear1", base * 32, base * 8, bias=False)
    mk.bn(sd, "bn6", base * 8)
    mk.linear(sd, "linear2", base * 8, out_channel)
    return sd


def pointnet2_state_dict(gen: torch.Generator, num_class: int = 40,
                         normal_channel: bool = True,
                         dtype: torch.dtype = torch.float32) -> StateDict:
    """pointnet2.get_model's keys (pointnet2.py:6-20): the MSG levels'
    ``sa{1,2}.conv_blocks.{i}.{j}`` / ``bn_blocks.{i}.{j}``, ``sa3``'s
    ``mlp_convs`` / ``mlp_bns``, ``fc{1,2,3}``, ``bn{1,2}``."""
    from vitlens_tpu_torch.weights.torch_convert import POINTNET2_MSG

    mk = _Maker(gen, dtype)
    sd: StateDict = {}
    for level, n_in, mlps in (("sa1", 3 if normal_channel else 0,
                               POINTNET2_MSG[0]),
                              ("sa2", 320, POINTNET2_MSG[1])):
        for i, mlp in enumerate(mlps):
            last = n_in + 3
            for j, out in enumerate(mlp):
                _conv2d(mk, sd, f"{level}.conv_blocks.{i}.{j}", last, out)
                mk.bn(sd, f"{level}.bn_blocks.{i}.{j}", out)
                last = out
    _set_abstraction(mk, sd, "sa3.", 640 + 3, (256, 512, 1024))
    for i, (n_in, n_out) in enumerate(((1024, 512), (512, 256),
                                       (256, num_class)), 1):
        mk.linear(sd, f"fc{i}", n_in, n_out)
        if i < 3:
            mk.bn(sd, f"bn{i}", n_out)
    return sd


def point_transformer_state_dict(cfg, gen: torch.Generator,
                                 qkv_bias: bool = False,
                                 dtype: torch.dtype = torch.float32) -> StateDict:
    """The reference PointTransformer's keys (point_encoder.py:170-295) for
    a ``PointTransformerConfig``: the PointBERT ``encoder.*``,
    ``reduce_dim``, ``pos_embed``, ``cls_token`` / ``cls_pos`` [1, 1, d],
    ``blocks.blocks.{i}.*`` (timm blocks; the qkv has no bias unless
    ``qkv_bias``), ``norm`` and, with ``output_dim``, ``proj`` [cat * d,
    output_dim]."""
    mk, pt = _Maker(gen, dtype), cfg.point
    d = pt.trans_dim
    sd: StateDict = {}
    for name, n_in, n_out in (("first_conv.0", 3, 128), ("first_conv.3", 128, 256),
                              ("second_conv.0", 512, 512),
                              ("second_conv.3", 512, pt.encoder_dims)):
        _conv1d(mk, sd, f"encoder.{name}", n_in, n_out)
    mk.bn(sd, "encoder.first_conv.1", 128)
    mk.bn(sd, "encoder.second_conv.1", 512)
    mk.linear(sd, "reduce_dim", pt.encoder_dims, d)
    mk.linear(sd, "pos_embed.0", 3, 128)
    mk.linear(sd, "pos_embed.2", 128, d)
    sd["cls_token"] = mk.normal((1, 1, d), 0.02)
    sd["cls_pos"] = mk.normal((1, 1, d), 0.02)
    for i in range(cfg.depth):
        p = f"blocks.blocks.{i}."
        mk.ln(sd, p + "norm1", d)
        mk.linear(sd, p + "attn.qkv", d, 3 * d, bias=qkv_bias)
        mk.linear(sd, p + "attn.proj", d, d)
        mk.ln(sd, p + "norm2", d)
        mk.linear(sd, p + "mlp.fc1", d, 4 * d)
        mk.linear(sd, p + "mlp.fc2", 4 * d, d)
    mk.ln(sd, "norm", d)
    if cfg.output_dim is not None:
        cat = 2 if cfg.do_cat else 1
        sd["proj"] = mk.normal((cat * d, cfg.output_dim), cfg.output_dim ** -0.5)
    return sd


def eva_state_dict(arch, gen: torch.Generator, head: bool = True,
                   dtype: torch.dtype = torch.float32) -> StateDict:
    """BLIP-2's ``eva_vit_g.pth`` keys for an ``models.eva.EVAArch``:
    ``patch_embed.proj`` (a conv [W, 3, p, p]), ``cls_token`` [1, 1, W],
    ``pos_embed`` [1, N + 1, W], ``blocks.{i}.{norm1, attn.qkv (no bias),
    attn.q_bias, attn.v_bias, attn.proj, norm2, mlp.fc1, mlp.fc2}``,
    ``norm`` and, with ``head``, ``head`` [proj_dim, W]."""
    mk, w = _Maker(gen, dtype), arch.width
    hidden = int(w * arch.mlp_ratio)
    sd: StateDict = {}
    sd["patch_embed.proj.weight"] = mk.normal(
        (w, 3, arch.patch_size, arch.patch_size), (3 * arch.patch_size ** 2) ** -0.5)
    sd["patch_embed.proj.bias"] = mk.normal((w,), 0.02)
    sd["cls_token"] = mk.normal((1, 1, w), 0.02)
    sd["pos_embed"] = mk.normal((1, arch.num_patches + 1, w), 0.02)
    for i in range(arch.layers):
        p = f"blocks.{i}."
        mk.ln(sd, p + "norm1", w)
        mk.linear(sd, p + "attn.qkv", w, 3 * w, bias=False)
        sd[p + "attn.q_bias"] = mk.normal((w,), 0.02)
        sd[p + "attn.v_bias"] = mk.normal((w,), 0.02)
        mk.linear(sd, p + "attn.proj", w, w)
        mk.ln(sd, p + "norm2", w)
        mk.linear(sd, p + "mlp.fc1", w, hidden)
        mk.linear(sd, p + "mlp.fc2", hidden, w)
    mk.ln(sd, "norm", w)
    if head:
        mk.linear(sd, "head", w, arch.proj_dim)
    return sd


def modified_resnet_state_dict(arch, gen: torch.Generator,
                               dtype: torch.dtype = torch.float32) -> StateDict:
    """open_clip ModifiedResNet keys for a ``models.resnet.ResNetArch``: the
    stem's ``conv{1,2,3}`` / ``bn{1,2,3}``, ``layer{1..4}.{j}.{conv1..3,
    bn1..3, downsample.0 (conv), downsample.1 (bn)}`` and ``attnpool.
    {positional_embedding, q_proj, k_proj, v_proj, c_proj}``."""
    mk, width = _Maker(gen, dtype), arch.width
    sd: StateDict = {}

    def conv(name, n_in, n_out, k):
        sd[f"{name}.weight"] = mk.normal((n_out, n_in, k, k), (n_in * k * k) ** -0.5)

    conv("conv1", 3, width // 2, 3)
    mk.bn(sd, "bn1", width // 2)
    conv("conv2", width // 2, width // 2, 3)
    mk.bn(sd, "bn2", width // 2)
    conv("conv3", width // 2, width, 3)
    mk.bn(sd, "bn3", width)
    inplanes = width
    for li, n_blocks in enumerate(arch.layers):
        planes = width * 2 ** li
        for bi in range(n_blocks):
            p = f"layer{li + 1}.{bi}."
            stride = (1 if li == 0 else 2) if bi == 0 else 1
            conv(p + "conv1", inplanes, planes, 1)
            mk.bn(sd, p + "bn1", planes)
            conv(p + "conv2", planes, planes, 3)
            mk.bn(sd, p + "bn2", planes)
            conv(p + "conv3", planes, planes * 4, 1)
            mk.bn(sd, p + "bn3", planes * 4)
            if stride > 1 or inplanes != planes * 4:
                conv(p + "downsample.0", inplanes, planes * 4, 1)
                mk.bn(sd, p + "downsample.1", planes * 4)
            inplanes = planes * 4
    embed = width * 32
    grid = arch.image_size // 32
    sd["attnpool.positional_embedding"] = mk.normal((grid * grid + 1, embed),
                                                    embed ** -0.5)
    for n in ("q_proj", "k_proj", "v_proj"):
        mk.linear(sd, f"attnpool.{n}", embed, embed)
    mk.linear(sd, "attnpool.c_proj", embed, arch.embed_dim)
    return sd


def hf_bert_state_dict(gen: torch.Generator, vocab_size: int, hidden: int,
                       layers: int, intermediate: int, max_positions: int,
                       type_vocab_size: int = 2, pooler: bool = True,
                       prefix: str = "",
                       dtype: torch.dtype = torch.float32) -> StateDict:
    """transformers BertModel / RobertaModel keys (``embeddings.*``,
    ``encoder.layer.{i}.*``, ``pooler.dense`` with ``pooler``) under
    ``prefix`` (e.g. ``"text.transformer."`` in an open_clip file)."""
    mk = _Maker(gen, dtype)
    sd: StateDict = {}
    e = prefix + "embeddings."
    sd[e + "word_embeddings.weight"] = mk.normal((vocab_size, hidden), 0.02)
    sd[e + "position_embeddings.weight"] = mk.normal((max_positions, hidden), 0.02)
    sd[e + "token_type_embeddings.weight"] = mk.normal((type_vocab_size, hidden), 0.02)
    mk.ln(sd, e + "LayerNorm", hidden)
    for i in range(layers):
        p = f"{prefix}encoder.layer.{i}."
        for n in ("query", "key", "value"):
            mk.linear(sd, p + f"attention.self.{n}", hidden, hidden)
        mk.linear(sd, p + "attention.output.dense", hidden, hidden)
        mk.ln(sd, p + "attention.output.LayerNorm", hidden)
        mk.linear(sd, p + "intermediate.dense", hidden, intermediate)
        mk.linear(sd, p + "output.dense", intermediate, hidden)
        mk.ln(sd, p + "output.LayerNorm", hidden)
    if pooler:
        mk.linear(sd, prefix + "pooler.dense", hidden, hidden)
    return sd


# ---------------------------------------------------------------------------
# Audio files
# ---------------------------------------------------------------------------


def write_wav(path: str, pcm: np.ndarray, rate: int, width: int = 2) -> None:
    """pcm: integer samples [channels, T] (8-bit as unsigned 0..255)."""
    pcm = np.atleast_2d(pcm)
    dt = {1: np.uint8, 2: "<i2", 4: "<i4"}[width]
    with wave.open(path, "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(np.ascontiguousarray(pcm.T).astype(dt).tobytes())


def pcm_from_float(x: np.ndarray, bps: int) -> np.ndarray:
    """float samples in [-1, 1) -> signed integers of ``bps`` bits."""
    scale = float(1 << (bps - 1))
    return np.clip(np.round(x * scale), -scale, scale - 1).astype(np.int64)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


class _Bits:
    def __init__(self):
        self.parts = []

    def uint(self, v: int, n: int) -> None:
        if n:
            self.parts.append(format(v, f"0{n}b"))

    def sint(self, v: int, n: int) -> None:
        self.uint(v & ((1 << n) - 1), n)

    def rice(self, v: int, k: int) -> None:
        u = (v << 1) ^ (v >> 63) if v < 0 else v << 1  # zigzag
        self.parts.append("0" * (u >> k) + "1")
        self.uint(u & ((1 << k) - 1), k)

    def to_bytes(self) -> bytes:
        s = "".join(self.parts)
        s += "0" * (-len(s) % 8)
        return int(s, 2).to_bytes(len(s) // 8, "big") if s else b""


def _utf8_number(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    nbytes = 2
    while n >= 1 << (5 * nbytes + 1):
        nbytes += 1
    out = []
    for _ in range(nbytes - 1):
        out.append(0x80 | (n & 0x3F))
        n >>= 6
    lead = ((0xFF << (8 - nbytes)) & 0xFF) | n
    return bytes([lead] + out[::-1])


_FIXED = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _subframe(bits: _Bits, x: np.ndarray, bps: int, kind: str,
              order: int) -> None:
    bits.uint(0, 1)
    if kind == "verbatim":
        bits.uint(1, 6)
        bits.uint(0, 1)
        for v in x.tolist():
            bits.sint(v, bps)
        return
    bits.uint(8 + order, 6)
    bits.uint(0, 1)
    for v in x[:order].tolist():
        bits.sint(v, bps)
    pred = np.zeros(len(x) - order, np.int64)
    for j, c in enumerate(_FIXED[order]):
        pred += c * x[order - 1 - j:len(x) - 1 - j]
    resid = x[order:] - pred
    mean = float(np.abs(resid).mean()) if len(resid) else 0.0
    k = max(0, int(np.log2(mean + 1.0)))
    method = 0 if k <= 14 else 1  # 4-bit or 5-bit Rice parameters
    bits.uint(method, 2)
    bits.uint(0, 4)  # one partition
    bits.uint(k, 4 + method)
    for r in resid.tolist():
        bits.rice(r, k)


def write_flac(path: str, pcm: np.ndarray, rate: int, bps: int = 16,
               subframe: str = "fixed", order: int = 2,
               stereo: str = "independent", block_size: int = 4096) -> None:
    """Write integer samples ``pcm`` [channels, T] (or [T]) as a FLAC file.

    ``subframe`` is "verbatim" or "fixed" (predictor ``order`` 0..4);
    ``stereo`` is "independent", "left_side" or "mid_side" (two channels)."""
    pcm = np.atleast_2d(np.asarray(pcm, np.int64))
    ch, total = pcm.shape
    if stereo != "independent" and ch != 2:
        raise ValueError(f"{stereo} needs two channels, got {ch}")
    bps_code = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6}[bps]
    # STREAMINFO's MD5: the interleaved samples, little-endian, in the
    # fewest whole bytes that hold bps bits
    nbytes = (bps + 7) // 8
    md5 = hashlib.md5(np.ascontiguousarray(pcm.T).astype("<i4").view(np.uint8)
                      .reshape(-1, 4)[:, :nbytes].tobytes()).digest()
    info = ((block_size << 64) | (block_size << 48)).to_bytes(10, "big")
    info += ((rate << 44) | ((ch - 1) << 41) | ((bps - 1) << 36)
             | total).to_bytes(8, "big") + md5
    out = bytearray(b"fLaC" + bytes([0x80]) + len(info).to_bytes(3, "big") + info)
    ch_code = {"independent": ch - 1, "left_side": 8, "mid_side": 10}[stereo]
    for n, start in enumerate(range(0, total, block_size)):
        blk = pcm[:, start:start + block_size]
        bs = blk.shape[1]
        head = bytearray([0xFF, 0xF8, (7 << 4) | 0, (ch_code << 4) | (bps_code << 1)])
        head += _utf8_number(n) + (bs - 1).to_bytes(2, "big")
        head.append(_crc8(bytes(head)))
        kind_order = (subframe, min(order, bs))
        if stereo == "independent":
            chans = [(blk[c], bps) for c in range(ch)]
        elif stereo == "left_side":
            chans = [(blk[0], bps), (blk[0] - blk[1], bps + 1)]
        else:
            chans = [((blk[0] + blk[1]) >> 1, bps), (blk[0] - blk[1], bps + 1)]
        bits = _Bits()
        for x, b in chans:
            _subframe(bits, x, b, *kind_order)
        frame = bytes(head) + bits.to_bytes()
        out += frame + _crc16(frame).to_bytes(2, "big")
    with open(path, "wb") as f:
        f.write(bytes(out))
