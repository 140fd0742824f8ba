"""Reference PyTorch checkpoints -> the port's modules (port of
vitlens_tpu/weights/torch_convert.py).

The converters turn a reference state dict (open_clip CLIP / TriCLIP keys,
the released vitlensL per-modality and merged files) into numpy trees in the
JAX package's layout, which ``weights/from_jax.py`` (``load_params``,
``load_state``) copies into the port's modules: one layout map, held against
the JAX package's trees by the tests.

  * "module." (DDP) prefixes are stripped; "visual.*" keys serve the image
    tower of a two-tower CLIP file;
  * Linear weight [out, in] -> w [in, out]; MHA in_proj_weight [3D, D] ->
    qkv_w [D, 3D]; the patch conv [W, C, p, p] -> [C*p*p, W]; Conv1d kernel 1
    [out, in, 1] -> [in, out];
  * per-layer block tensors stacked along a leading [layers] axis;
  * the CLIP positional-embedding grid resized to the Lens latents by
    :func:`resize_pos_embed`.

``_convert_adapter`` takes the image/tactile/video patch embedding (and the
video tower's ``ltpos``), the depth patch embedding, the EEG Conv1d, the AST
audio adapter, the PointBERT tokenizer and the PNSA tokenizer (OpenShape's
``sa.mlp_convs.{i}`` Conv2d [out, in, 1, 1], ``sa.mlp_bns.{i}``, ``lift.0``
Conv1d and ``lift.2`` LayerNorm). The identity Lens has no keys; the
transformer Lens is a plain ``perceiver.resblocks.*`` stack.

The OpenShape baselines' files (``convert_ppat_state_dict``,
``convert_dgcnn_state_dict``, ``convert_pointnet2_state_dict``) and the
PointBERT classifier's (``convert_point_transformer``) give the trees of
``models/pc_baselines.py`` and ``models/point_transformer.py``, PPAT's and
the classifier's blocks stacked as JAX keeps them.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np

from vitlens_tpu_torch.config import (ModelConfig, PerceiverConfig, TowerConfig,
                                      image_tower_config)

Params = Dict[str, Any]
State = Dict[str, Any]


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    if hasattr(t, "detach"):
        return t.detach().cpu().float().numpy()
    return np.asarray(t)


def _j(t) -> np.ndarray:
    return np.asarray(_np(t), dtype=np.float32)


def _jt(t) -> np.ndarray:
    """``np.ascontiguousarray(_j(t).T)`` of a 2-D weight. A torch tensor is
    transposed and cast by torch's blocked, threaded copy, about twice as
    fast as numpy's strided one: the transposes are most of a full-width
    load's host time."""
    if hasattr(t, "detach"):
        return t.detach().cpu().t().float().contiguous().numpy()
    return np.ascontiguousarray(_j(t).T)


def strip_prefixes(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Strip the DDP 'module.' prefix."""
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = v
    return out


def sub(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    pl = len(prefix)
    return {k[pl:]: v for k, v in sd.items() if k.startswith(prefix)}


def _ln(sd: Mapping[str, Any], name: str) -> Params:
    return {"scale": _j(sd[f"{name}.weight"]), "bias": _j(sd[f"{name}.bias"])}


def _linear(sd: Mapping[str, Any], name: str) -> Params:
    p = {"w": _jt(sd[f"{name}.weight"])}
    if f"{name}.bias" in sd:
        p["b"] = _j(sd[f"{name}.bias"])
    return p


def _conv1x1(sd: Mapping[str, Any], name: str) -> Params:
    """Conv1d kernel 1 -> matmul params."""
    w = _j(sd[f"{name}.weight"])  # [out, in, 1]
    p = {"w": np.ascontiguousarray(w[..., 0].T)}
    if f"{name}.bias" in sd:
        p["b"] = _j(sd[f"{name}.bias"])
    return p


def _bn(sd: Mapping[str, Any], name: str) -> Tuple[Params, State]:
    return (
        {"scale": _j(sd[f"{name}.weight"]), "bias": _j(sd[f"{name}.bias"])},
        {"mean": _j(sd[f"{name}.running_mean"]),
         "var": _j(sd[f"{name}.running_var"])},
    )


def _stack(layers):
    """Stack a list of equal trees leaf by leaf on a new leading axis."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([layer[k] for layer in layers]) for k in first}
    return np.stack(layers, axis=0)


def _patch_conv(sd: Mapping[str, Any], name: str) -> np.ndarray:
    """A conv weight [W, C, *kernel] -> [C * prod(kernel), W], flattened in
    (c, kernel) order: the 2-D patch convs and the EEG Conv1d."""
    w = _j(sd[name])
    return np.ascontiguousarray(w.reshape(w.shape[0], -1).T)


def convert_transformer_blocks(sd: Mapping[str, Any], n_layers: int) -> Params:
    """resblocks.* -> stacked trunk params."""
    per_layer = []
    for i in range(n_layers):
        pre = f"resblocks.{i}."
        blk = {
            "ln_1": _ln(sd, f"{pre}ln_1"),
            "attn": {
                "qkv_w": _jt(sd[f"{pre}attn.in_proj_weight"]),
                "qkv_b": _j(sd[f"{pre}attn.in_proj_bias"]),
                "out_w": _jt(sd[f"{pre}attn.out_proj.weight"]),
                "out_b": _j(sd[f"{pre}attn.out_proj.bias"]),
            },
            "ln_2": _ln(sd, f"{pre}ln_2"),
            "mlp": {
                "fc": _linear(sd, f"{pre}mlp.c_fc"),
                "proj": _linear(sd, f"{pre}mlp.c_proj"),
            },
        }
        if f"{pre}ls_1.gamma" in sd:
            blk["ls_1"] = {"gamma": _j(sd[f"{pre}ls_1.gamma"])}
            blk["ls_2"] = {"gamma": _j(sd[f"{pre}ls_2.gamma"])}
        per_layer.append(blk)
    return {"blocks": _stack(per_layer)}


def convert_perceiver(sd: Mapping[str, Any], cfg: PerceiverConfig) -> Params:
    p: Params = {"latents": _j(sd["latents"])}
    layers = []
    n_unique = 1 if cfg.weight_tie_layers else cfg.depth
    for i in range(n_unique):
        layer: Params = {
            "cross_attn": {
                "ln_q": _ln(sd, f"layers.{i}.0.norm"),
                "ln_kv": _ln(sd, f"layers.{i}.0.norm_context"),
                "attn": {
                    "to_q": _linear(sd, f"layers.{i}.0.fn.to_q"),
                    "to_kv": _linear(sd, f"layers.{i}.0.fn.to_kv"),
                    "to_out": _linear(sd, f"layers.{i}.0.fn.to_out"),
                },
            },
            "cross_ff": {
                "ln": _ln(sd, f"layers.{i}.1.norm"),
                "ff": {
                    "fc": _linear(sd, f"layers.{i}.1.fn.net.0"),
                    "proj": _linear(sd, f"layers.{i}.1.fn.net.2"),
                },
            },
            "self_blocks": [],
        }
        for j in range(cfg.self_per_cross_attn):
            layer["self_blocks"].append({
                "attn_ln": _ln(sd, f"layers.{i}.2.{j}.0.norm"),
                "attn": {
                    "to_q": _linear(sd, f"layers.{i}.2.{j}.0.fn.to_q"),
                    "to_kv": _linear(sd, f"layers.{i}.2.{j}.0.fn.to_kv"),
                    "to_out": _linear(sd, f"layers.{i}.2.{j}.0.fn.to_out"),
                },
                "ff_ln": _ln(sd, f"layers.{i}.2.{j}.1.norm"),
                "ff": {
                    "fc": _linear(sd, f"layers.{i}.2.{j}.1.fn.net.0"),
                    "proj": _linear(sd, f"layers.{i}.2.{j}.1.fn.net.2"),
                },
            })
        layers.append(layer)
    p["layers"] = layers
    return p


def _convert_adapter(sd: Mapping[str, Any], cfg: TowerConfig) -> Tuple[Params, State]:
    m = cfg.modality
    if m in ("image", "tactile", "video"):
        p: Params = {"conv1": {"w": _patch_conv(sd, "conv1.weight")}}
        if "ltpos.weight" in sd:  # the video tower's learned temporal pos
            p["ltpos"] = _j(sd["ltpos.weight"])
        return p, {}
    if m == "depth":
        a = sub(sd, "visual_adapter.")
        return {"conv1": {"w": _patch_conv(a, "conv1.weight")},
                "pos_emb": _j(a["pos_emb"])}, {}
    if m == "eeg":
        a = sub(sd, "visual_adapter.")
        # Conv1d [W, chans, window] -> [chans * window, W], chans-major
        return {"proj": {"w": _patch_conv(a, "proj.weight"),
                         "b": _j(a["proj.bias"])},
                "pos_emb": _j(a["pos_emb"])}, {}
    if m == "audio":
        a = sub(sd, "visual_adapter.")
        return {"conv1": {"w": _j(a["conv1.weight"])},
                "pos_emb": _j(a["pos_emb"])}, {}
    if m == "pc" and cfg.point.tokenizer == "pointbert":
        a = sub(sd, "visual_adapter.")
        bn1_p, bn1_s = _bn(a, "encoder.first_conv.1")
        bn2_p, bn2_s = _bn(a, "encoder.second_conv.1")
        p = {
            "encoder": {
                "conv1": _conv1x1(a, "encoder.first_conv.0"),
                "bn1": bn1_p,
                "conv2": _conv1x1(a, "encoder.first_conv.3"),
                "conv3": _conv1x1(a, "encoder.second_conv.0"),
                "bn2": bn2_p,
                "conv4": _conv1x1(a, "encoder.second_conv.3"),
            },
            "reduce_dim": _linear(a, "reduce_dim"),
            "pos_embed": {
                "fc1": _linear(a, "pos_embed.0"),
                "fc2": _linear(a, "pos_embed.2"),
            },
        }
        return p, {"encoder": {"bn1": bn1_s, "bn2": bn2_s}}
    if m == "pc" and cfg.point.tokenizer == "pnsa":
        a = sub(sd, "visual_adapter.")
        convs, states = [], []
        for i in range(3):
            bn_p, bn_s = _bn(a, f"sa.mlp_bns.{i}")
            w = _j(a[f"sa.mlp_convs.{i}.weight"])  # Conv2d [out, in, 1, 1]
            convs.append({"conv": {"w": np.ascontiguousarray(w[..., 0, 0].T),
                                   "b": _j(a[f"sa.mlp_convs.{i}.bias"])},
                          "bn": bn_p})
            states.append({"bn": bn_s})
        return ({"sa": convs, "lift": {"conv": _conv1x1(a, "lift.0"),
                                       "ln": _ln(a, "lift.2")}},
                {"sa": states})
    what = (f"the {cfg.point.tokenizer!r} point tokenizer" if m == "pc"
            else f"the {m!r} adapter")
    raise NotImplementedError(f"converting {what} is not yet ported")


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel with a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] weights of jax.image.resize(method="bicubic") along one
    axis: half-pixel centres, the kernel widened by n_in / n_out when
    shrinking (antialiasing), weights renormalised over the taps that fall
    inside, and zero for a sample outside the input."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None])
    w = _keys_cubic(x / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def resize_pos_embed(pos: np.ndarray, target_len: int) -> np.ndarray:
    """Bicubic-resize a [1 + g*g, D] CLIP positional embedding to [1 +
    target_len, D]: the CLS row is kept, the grid rows are resized as a
    square grid. Separable weight matrices built here, equal to
    ``jax.image.resize(..., "bicubic")`` (``F.interpolate``'s bicubic uses
    a = -0.75 and clamps at the edges, which gives other numbers)."""
    n = pos.shape[0] - 1
    if n == target_len:
        return pos
    g_old = int(round(n ** 0.5))
    g_new = int(round(target_len ** 0.5))
    assert g_old * g_old == n and g_new * g_new == target_len, (n, target_len)
    grid = np.asarray(pos[1:], np.float64).reshape(g_old, g_old, -1)
    w = _cubic_weights(g_old, g_new)
    resized = np.einsum("hwd,hi,wj->ijd", grid, w, w)
    return np.concatenate(
        [np.asarray(pos[:1], np.float32),
         resized.reshape(g_new * g_new, -1).astype(np.float32)], 0)


def convert_vision_tower(sd: Mapping[str, Any],
                         cfg: TowerConfig) -> Tuple[Params, State]:
    """One VisionTransformer subtree (keys relative to the tower, e.g. after
    ``sub(sd, 'visual.')``) -> (params, state)."""
    adapter_p, adapter_s = _convert_adapter(sd, cfg)
    pos = resize_pos_embed(_j(sd["positional_embedding"]), cfg.num_tokens)
    p: Params = {
        "adapter": adapter_p,
        "class_embedding": _j(sd["class_embedding"]),
        "positional_embedding": np.asarray(pos, np.float32),
        "ln_pre": _ln(sd, "ln_pre"),
        "trunk": convert_transformer_blocks(sub(sd, "transformer."),
                                            cfg.arch.layers),
        "ln_post": _ln(sd, "ln_post"),
        "proj": _j(sd["proj"]),
    }
    perc = cfg.perceiver
    if perc is not None and perc.as_transformer:
        # a plain Transformer stored under the Lens's name
        p["perceiver_transformer"] = convert_transformer_blocks(
            sub(sd, "perceiver."), perc.depth)
    elif perc is not None and not perc.as_identity:
        p["perceiver"] = convert_perceiver(sub(sd, "perceiver."), perc)
    return p, {"adapter": adapter_s}


def convert_shared_vision_subset(sd: Mapping[str, Any],
                                 cfg: TowerConfig) -> Params:
    """Plain-CLIP visual keys -> the subset a Lens tower shares with an image
    tower: trunk blocks, ln_pre/ln_post, proj, class_embedding and the
    (latent-resized) positional embedding, plus the patch conv for the
    image-patch modalities. Adapter and perceiver parameters are not produced
    and keep their initial values after the non-strict merge."""
    pos = resize_pos_embed(_j(sd["positional_embedding"]), cfg.num_tokens)
    p: Params = {
        "class_embedding": _j(sd["class_embedding"]),
        "positional_embedding": np.asarray(pos, np.float32),
        "ln_pre": _ln(sd, "ln_pre"),
        "trunk": convert_transformer_blocks(sub(sd, "transformer."),
                                            cfg.arch.layers),
        "ln_post": _ln(sd, "ln_post"),
        "proj": _j(sd["proj"]),
    }
    if cfg.modality in ("image", "tactile", "video") and "conv1.weight" in sd:
        p["adapter"] = {"conv1": {"w": _patch_conv(sd, "conv1.weight")}}
    return p


def convert_hf_text_tower(sd: Mapping[str, Any]) -> Params:
    """An open_clip HFTextEncoder subtree (keys under ``text.``:
    ``transformer.*`` the HF module, ``proj`` a Linear or Sequential(Linear,
    GELU, Linear)) -> the tree of ``models/bert_text.py``'s HFTextTower; a
    tree whose ``encoder.pooler`` is None loads through
    ``bert_text.load_hf_text_tower``."""
    from vitlens_tpu_torch.models.bert_text import convert_hf_bert_state_dict

    out: Params = {"encoder": convert_hf_bert_state_dict(sub(sd, "transformer."))}
    if "proj.0.weight" in sd:  # mlp
        out["proj"] = {"fc1": _linear(sd, "proj.0"), "fc2": _linear(sd, "proj.2")}
    elif "proj.weight" in sd:  # linear
        out["proj"] = {"fc": _linear(sd, "proj")}
    return out


def convert_text_tower(sd: Mapping[str, Any], n_layers: int) -> Params:
    """Text keys (TriCLIP inline, token_embedding.* at the top level, or a
    TextTransformer subtree) -> params."""
    return {
        "token_embedding": _j(sd["token_embedding.weight"]),
        "positional_embedding": _j(sd["positional_embedding"]),
        "trunk": convert_transformer_blocks(sub(sd, "transformer."), n_layers),
        "ln_final": _ln(sd, "ln_final"),
        "text_projection": _j(sd["text_projection"]),
    }


def convert_tri_state_dict(sd: Mapping[str, Any],
                           cfg: ModelConfig) -> Tuple[Params, State]:
    """A whole TriCLIP state dict -> (params, state). A plain two-tower CLIP
    file (no 'image.' subtree) serves its 'visual.' keys to both towers."""
    sd = strip_prefixes(sd)
    has_image = any(k.startswith("image.") for k in sd)
    has_visual = any(k.startswith("visual.") for k in sd)
    img_cfg = image_tower_config(cfg)

    params: Params = {}
    state: State = {"image": {"adapter": {}}, "visual": {"adapter": {}}}

    if has_image:
        params["image"], state["image"] = convert_vision_tower(sub(sd, "image."), img_cfg)
    elif has_visual:
        params["image"], state["image"] = convert_vision_tower(sub(sd, "visual."), img_cfg)

    if has_visual:
        vis_sd = sub(sd, "visual.")
        need_adapter = cfg.tower.modality not in ("image", "tactile", "video")
        has_adapter = any(k.startswith("visual_adapter.") for k in vis_sd)
        perc = cfg.tower.perceiver
        need_perc = perc is not None and not perc.as_identity
        has_perc = any(k.startswith("perceiver.") for k in vis_sd)
        if (need_adapter and not has_adapter) or (need_perc and not has_perc):
            # a plain CLIP file into a Lens tower: the shared trunk subset
            # still loads, so train-from-CLIP recipes start from it
            params["visual"] = convert_shared_vision_subset(vis_sd, cfg.tower)
        else:
            params["visual"], state["visual"] = convert_vision_tower(vis_sd, cfg.tower)

    if cfg.text.hf_style and any(k.startswith("text.transformer.") for k in sd):
        # open_clip CustomTextCLIP with HFTextEncoder: the HF module under
        # text.transformer.*, the mlp proj as text.proj.{0,2}.weight
        params["text"] = convert_hf_text_tower(sub(sd, "text."))
    elif "token_embedding.weight" in sd:
        params["text"] = convert_text_tower(sd, cfg.text.layers)
    elif any(k.startswith("text.") for k in sd):
        params["text"] = convert_text_tower(sub(sd, "text."), cfg.text.layers)

    if "logit_scale" in sd:
        params["logit_scale"] = _j(sd["logit_scale"]).reshape(())
    return params, state


def load_torch_checkpoint(path: str):
    """Load a .pt checkpoint on the CPU and return its (possibly nested)
    state dict; OpenAI's TorchScript archives go through ``torch.jit.load``."""
    import torch

    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    except RuntimeError:
        ckpt = torch.jit.load(path, map_location="cpu").state_dict()
    if hasattr(ckpt, "state_dict") and not isinstance(ckpt, dict):
        ckpt = ckpt.state_dict()
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        return ckpt["state_dict"]
    if isinstance(ckpt, dict) and "model" in ckpt and isinstance(ckpt["model"], dict):
        return ckpt["model"]
    return ckpt


# ---------------------------------------------------------------------------
# OpenShape pc baselines (VitLens-OpenShape/src/models/{ppat, dgcnn,
# pointnet2}.py) and the PointBERT classifier -> the trees of
# models/pc_baselines.py and models/point_transformer.py
# ---------------------------------------------------------------------------


def _conv1x1_2d(sd: Mapping[str, Any], name: str) -> Params:
    """Conv2d kernel 1x1 [out, in, 1, 1] -> matmul params."""
    w = _j(sd[f"{name}.weight"])
    p = {"w": np.ascontiguousarray(w[..., 0, 0].T)}
    if f"{name}.bias" in sd:
        p["b"] = _j(sd[f"{name}.bias"])
    return p


def _convert_sa(sd: Mapping[str, Any], n_layers: int) -> Tuple[Params, State]:
    """PointNetSetAbstraction mlp_convs/mlp_bns (pointnet_util.py:171-184)."""
    ps, ss = [], []
    for i in range(n_layers):
        bn_p, bn_s = _bn(sd, f"mlp_bns.{i}")
        ps.append({"conv": _conv1x1_2d(sd, f"mlp_convs.{i}"), "bn": bn_p})
        ss.append({"bn": bn_s})
    return {"mlp": ps}, {"mlp": ss}


def _convert_sa_msg(sd: Mapping[str, Any], mlp_list) -> Tuple[Params, State]:
    """PointNetSetAbstractionMsg conv_blocks/bn_blocks
    (pointnet_util.py:216-231)."""
    branches, states = [], []
    for i, mlp in enumerate(mlp_list):
        ps, ss = [], []
        for j in range(len(mlp)):
            bn_p, bn_s = _bn(sd, f"bn_blocks.{i}.{j}")
            ps.append({"conv": _conv1x1_2d(sd, f"conv_blocks.{i}.{j}"),
                       "bn": bn_p})
            ss.append({"bn": bn_s})
        branches.append(ps)
        states.append(ss)
    return {"branches": branches}, {"branches": states}


def convert_ppat_state_dict(sd: Mapping[str, Any],
                            depth: int) -> Tuple[Params, State]:
    """Projected(PointPatchTransformer, Linear) weights (ppat.py:86-124);
    the blocks stacked on a leading [depth] axis, as JAX keeps them."""
    sd = strip_prefixes(sd)
    sa_p, sa_s = _convert_sa(sub(sd, "ppat.sa."), 3)
    layers = []
    for layer in range(depth):
        pre = f"ppat.transformer.layers.{layer}"
        layers.append({
            "attn": {"ln": _ln(sd, f"{pre}.0.norm"),
                     "qkv": _linear(sd, f"{pre}.0.fn.to_qkv"),
                     "out": _linear(sd, f"{pre}.0.fn.to_out.0")},
            "ff": {"ln": _ln(sd, f"{pre}.1.norm"),
                   "fc": _linear(sd, f"{pre}.1.fn.net.0"),
                   "proj": _linear(sd, f"{pre}.1.fn.net.3")},
        })
    params: Params = {
        "sa": sa_p,
        "lift": {"conv": _conv1x1(sd, "ppat.lift.0"),
                 "ln": _ln(sd, "ppat.lift.2")},
        "cls_token": _j(sd["ppat.cls_token"]),
        "blocks": _stack(layers),
        "proj": _linear(sd, "proj"),
    }
    return params, {"sa": sa_s}


def convert_dgcnn_state_dict(sd: Mapping[str, Any]) -> Tuple[Params, State]:
    """DGCNN weights (dgcnn.py:67-101): BatchNorms under ``bn{i}.bn`` (the
    NoCuDNN wrappers), convs at Sequential index 0 (conv5 a Conv1d)."""
    sd = strip_prefixes(sd)
    params: Params = {}
    state: State = {}
    for i in range(1, 6):
        bn_p, bn_s = _bn(sd, f"bn{i}.bn")
        conv = (_conv1x1_2d(sd, f"conv{i}.0") if i < 5
                else _conv1x1(sd, f"conv{i}.0"))
        params[f"conv{i}"] = {"conv": conv, "bn": bn_p}
        state[f"conv{i}"] = {"bn": bn_s}
    params["linear1"] = _linear(sd, "linear1")
    params["bn6"], state["bn6"] = _bn(sd, "bn6")
    params["linear2"] = _linear(sd, "linear2")
    return params, state


POINTNET2_MSG = ([[32, 32, 64], [64, 64, 128], [64, 96, 128]],
                 [[64, 64, 128], [128, 128, 256], [128, 128, 256]])


def convert_pointnet2_state_dict(
        sd: Mapping[str, Any]) -> Tuple[Params, State]:
    """pointnet2.get_model weights (pointnet2.py:6-20)."""
    sd = strip_prefixes(sd)
    params: Params = {}
    state: State = {}
    for name, mlps in zip(("sa1", "sa2"), POINTNET2_MSG):
        params[name], state[name] = _convert_sa_msg(sub(sd, f"{name}."), mlps)
    params["sa3"], state["sa3"] = _convert_sa(sub(sd, "sa3."), 3)
    for i in (1, 2):
        params[f"fc{i}"] = _linear(sd, f"fc{i}")
        params[f"bn{i}"], state[f"bn{i}"] = _bn(sd, f"bn{i}")
    params["fc3"] = _linear(sd, "fc3")
    return params, state


def convert_point_transformer(sd: Mapping[str, Any], cfg) -> Tuple[Params, State]:
    """A reference PointTransformer state dict (point_encoder.py:170-295)
    -> the tree of ``models.point_transformer.PointTransformer`` (``cfg`` a
    ``PointTransformerConfig``); a qkv without bias gets zeros."""
    bn1_p, bn1_s = _bn(sd, "encoder.first_conv.1")
    bn2_p, bn2_s = _bn(sd, "encoder.second_conv.1")
    tok_p = {
        "encoder": {
            "conv1": _conv1x1(sd, "encoder.first_conv.0"), "bn1": bn1_p,
            "conv2": _conv1x1(sd, "encoder.first_conv.3"),
            "conv3": _conv1x1(sd, "encoder.second_conv.0"), "bn2": bn2_p,
            "conv4": _conv1x1(sd, "encoder.second_conv.3"),
        },
        "reduce_dim": _linear(sd, "reduce_dim"),
        "pos_embed": {"fc1": _linear(sd, "pos_embed.0"),
                      "fc2": _linear(sd, "pos_embed.2")},
    }
    blocks = []
    for i in range(cfg.depth):
        pre = f"blocks.blocks.{i}."
        qkv_w = _jt(sd[f"{pre}attn.qkv.weight"])
        qkv_b = (_j(sd[f"{pre}attn.qkv.bias"]) if f"{pre}attn.qkv.bias" in sd
                 else np.zeros((qkv_w.shape[1],), np.float32))
        blocks.append({
            "ln_1": _ln(sd, f"{pre}norm1"),
            "attn": {"qkv_w": qkv_w, "qkv_b": qkv_b,
                     "out_w": _jt(sd[f"{pre}attn.proj.weight"]),
                     "out_b": _j(sd[f"{pre}attn.proj.bias"])},
            "ln_2": _ln(sd, f"{pre}norm2"),
            "mlp": {"fc": _linear(sd, f"{pre}mlp.fc1"),
                    "proj": _linear(sd, f"{pre}mlp.fc2")},
        })
    params: Params = {
        "tokenizer": tok_p,
        "cls_token": _j(sd["cls_token"]).reshape(-1),
        "cls_pos": _j(sd["cls_pos"]).reshape(-1),
        "blocks": {"blocks": _stack(blocks)},
        "norm": _ln(sd, "norm"),
    }
    if "proj" in sd:
        params["proj"] = _j(sd["proj"])
    return params, {"tokenizer": {"encoder": {"bn1": bn1_s, "bn2": bn2_s}}}
