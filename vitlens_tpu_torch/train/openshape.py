"""OpenShape-triplet trainer for vitlensG, the ViT-bigG Lens (port of
vitlens_tpu/train/openshape.py).

  * ``CLIPBind``: the PNSA point tokenizer -> perceiver Lens -> bigG ViT
    with the first 16 trunk blocks skipped (reference clip_bind.py:13-54,
    configs/train.yaml), with a fresh ``proj_layer`` in place of the CLIP
    projection when the CLIP projection width is not ``out_channel``; its
    own logit scale and image/text projections (main.py:154-196).
  * ``BaselineBind``: the same surface over a comparison baseline
    (``models/pc_baselines.py``: PointBERT, DGCNN, PointNet), in fp32.
  * the contrastive loss against PRECOMPUTED OpenCLIP text and image
    embeddings stored with each object (train.py:175-191), the kNN-group
    and sim-margin negative masks (train.py:241-284), all in fp32.
  * ``trunk_lr_scale``: 0.1x updates on the ViT trunk (main.py:240-246),
    and ``ndim_wd_mask``: JAX's weight-decay mask, ``ndim >= 2`` on JAX's
    parameter shapes.
  * ``OpenShapeTripletDataset`` and ``precomputed_text_eval`` (cosine
    retrieval against per-class text embeddings, train.py:608-715): copies
    of the JAX module's numpy code.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from vitlens_tpu_torch.adapters.tokenizers import batch_norm_synced
from vitlens_tpu_torch.config import (PerceiverConfig, PointAdapterConfig,
                                      TowerConfig, get_arch)
from vitlens_tpu_torch.models.layers import Linear, _param
from vitlens_tpu_torch.models.pc_baselines import make_pc_baseline
from vitlens_tpu_torch.models.vit import VisionTower
from vitlens_tpu_torch.parallel.mesh import data_axis
from vitlens_tpu_torch.train.losses import cross_entropy, gather_features

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def vitlensG_tower_config(out_channel: int = 1280,
                          skip_first_n_layers: int = 16) -> TowerConfig:
    """bigG Lens with the PNSA tokenizer, from the published vitlensG recipe
    (TRAIN_INFERENCE.md "Train vitlensG on OpenShape-Triplets"): pc
    in_channel 6, radius 0.2, npoints 10000, num_group 512, group_size 64,
    trans_dim 256; perceiver depth 4, latents 256, latent_dim 1664,
    cross/latent_dim_head 104, latent_heads 16; the first
    ``skip_first_n_layers`` of the 48 trunk blocks skipped. ``out_channel``
    is the trainer's (``CLIPBind``'s) and shapes nothing here, as in JAX."""
    del out_channel
    arch_entry = get_arch("ViT-bigG-14")
    arch = arch_entry["vision"]
    pt = PointAdapterConfig(tokenizer="pnsa", trans_dim=256, encoder_dims=256,
                            group_size=64, num_group=512, in_channel=6,
                            npoints=10000, radius=0.2)
    perc = PerceiverConfig(
        depth=4, num_latents=256, latent_dim=arch.width,
        input_dim=256, cross_heads=1, cross_dim_head=104,
        latent_heads=16, latent_dim_head=104,
        self_per_cross_attn=1,
    )
    return TowerConfig(
        arch=arch, embed_dim=arch_entry["embed_dim"], modality="pc",
        point=pt, perceiver=perc, skip_first_n_layers=skip_first_n_layers,
    )


class _Bind(nn.Module):
    """The parts both binds share: ``logit_scale`` (log(1/0.07)) and the
    ``image_proj``/``text_proj`` linears (out_channel x out_channel, zero
    bias), which train only with --use-image-proj / --use-text-proj."""

    def __init__(self, out_channel: int, device=None):
        super().__init__()
        self.logit_scale = _param(device=device)
        self.image_proj = Linear(out_channel, out_channel, device=device)
        self.text_proj = Linear(out_channel, out_channel, device=device)

    def _init_heads(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.logit_scale.fill_(math.log(1 / 0.07))
        for lin in (self.image_proj, self.text_proj):
            lin.init_(g)
            with torch.no_grad():
                lin.b.zero_()


class CLIPBind(_Bind):
    """``clip_bind_init`` / ``clip_bind_apply``: ``backbone`` (the Lens
    tower), then ``proj_layer`` (width -> out_channel) when the tower's
    CLIP projection width is not ``out_channel``. JAX then drops the
    backbone's ``proj`` and multiplies by an identity in its place; here
    the backbone has no ``proj`` and no product runs, which gives the same
    features."""

    def __init__(self, tower_cfg: TowerConfig, out_channel: int, device=None):
        super().__init__(out_channel, device=device)
        replace = tower_cfg.embed_dim != out_channel
        self.backbone = VisionTower(tower_cfg, device=device, proj=not replace)
        self.proj_layer = (Linear(tower_cfg.arch.width, out_channel,
                                  device=device) if replace else None)

    def init_(self, g: torch.Generator) -> None:
        self.backbone.init_(g)
        if self.proj_layer is not None:
            self.proj_layer.init_(g)
        self._init_heads(g)

    def forward(self, xyz_features: Tensor, compute_dtype=torch.float32, *,
                train: bool = False, fps_start: Optional[Tensor] = None,
                fps_generator: Optional[torch.Generator] = None) -> Tensor:
        """xyz_features [B, N, 3 (+D)] -> [B, out_channel] in
        ``compute_dtype``. ``train`` normalises the tokenizer with batch
        statistics; FPS starts at ``fps_start``, draws from
        ``fps_generator``, or starts at point 0."""
        feats = self.backbone(xyz_features, compute_dtype, train=train,
                              fps_start=fps_start, fps_generator=fps_generator)
        return feats if self.proj_layer is None else self.proj_layer(feats)


class BaselineBind(_Bind):
    """``baseline_bind_init`` / ``baseline_bind_apply``: a pc baseline
    (``models/pc_baselines.py``) as ``encoder`` behind the bind surface.
    The baselines run in fp32 whatever the compute dtype (JAX drops it);
    only PointBERT samples with FPS."""

    def __init__(self, name: str, *, in_channel: int = 6,
                 out_channel: int = 1280, scaling: int = 3, device=None):
        super().__init__(out_channel, device=device)
        self.name = name
        self.encoder = make_pc_baseline(name, in_channel=in_channel,
                                        out_channel=out_channel,
                                        scaling=scaling, device=device)

    def init_(self, g: torch.Generator) -> None:
        self.encoder.init_(g)
        self._init_heads(g)

    def forward(self, xyz_features: Tensor, compute_dtype=None, *,
                train: bool = False, fps_start: Optional[Tensor] = None,
                fps_generator: Optional[torch.Generator] = None) -> Tensor:
        del compute_dtype  # baselines are small; they run fp32
        xyz = xyz_features[..., :3].float()
        feats = xyz_features.float()
        kw = {}
        if self.name == "PointBERT":
            kw = dict(fps_start=fps_start, fps_generator=fps_generator)
        return self.encoder(xyz, feats, train=train, **kw)


# ---------------------------------------------------------------------------
# losses + masks
# ---------------------------------------------------------------------------


def _normalize(x: Tensor) -> Tensor:
    x = x.float()
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def contras_loss(feat1: Tensor, feat2: Tensor, logit_scale: Tensor,
                 mask: Optional[Tensor] = None,
                 axis_name=None) -> Tuple[Tensor, Tensor]:
    """Reference Trainer.contras_loss (train.py:175-191): normalise both,
    all-gather both over the data axis (``axis_name``; with their gradient),
    full-matrix logits (optionally times ``mask``), symmetric CE. Returns
    (loss, top-1 accuracy), fp32."""
    f1 = gather_features(_normalize(feat1), axis_name)
    f2 = gather_features(_normalize(feat2), axis_name)
    logits = logit_scale.float() * f1 @ f2.t()
    if mask is not None:
        logits = logits * mask
    labels = torch.arange(logits.shape[0], device=logits.device)
    acc = (logits.argmax(dim=1) == labels).float().mean()
    loss = 0.5 * (cross_entropy(logits, labels) + cross_entropy(logits.t(), labels))
    return loss, acc


def knn_negative_mask(batch_size: int, k: int) -> np.ndarray:
    """(k*s) x (k*s) mask keeping the diagonal and zeroing other members of
    the same kNN group (train.py:241-250): eye(ks) | ~kron(eye(s), 1_kxk)."""
    ks = batch_size * k
    m1 = np.eye(ks, dtype=bool)
    m2 = np.kron(np.eye(batch_size, dtype=bool), np.ones((k, k), dtype=bool))
    return np.logical_or(m1, ~m2).astype(np.float32)


def sim_margin_mask(img_feat: Tensor, text_feat: Tensor, threshold: float,
                    base_mask: Optional[Tensor] = None) -> Tensor:
    """Zero negatives whose image-text teacher similarity is within
    ``threshold`` of the diagonal (train.py:275-284); no gradient."""
    sim = _normalize(img_feat) @ _normalize(text_feat).t()
    mask = (sim.diagonal()[:, None] - sim) > threshold
    if base_mask is not None:
        mask = mask | base_mask.bool()
    return mask.float().detach()


# ---------------------------------------------------------------------------
# optimizer masks: lr scale (0.1x on the ViT trunk, main.py:240-246) and
# JAX's weight-decay mask
# ---------------------------------------------------------------------------


def trunk_lr_scale(model: nn.Module, scale: float = 0.1) -> Dict[str, float]:
    """{parameter name: scale} with ``scale`` for every parameter under a
    ``trunk`` (CLIPBind's ``backbone.trunk``, the skipped blocks included)
    and 1.0 elsewhere, as JAX's tree of scales."""
    return {n: scale if "trunk" in n.split(".") else 1.0
            for n, _ in model.named_parameters()}


# A per-block parameter of a module list that JAX stacks on a leading
# [layers] axis: the trunks' and PPAT's ``blocks.<i>.`` (weights/from_jax.py
# un-stacks exactly these).
_STACKED = re.compile(r"(^|\.)blocks\.\d+\.")


def jax_ndim(name: str, p: Tensor) -> int:
    """The rank of the parameter ``name`` in the JAX tree: one more than
    here for a block of a stacked transformer."""
    return p.dim() + (1 if _STACKED.search(name) else 0)


def ndim_wd_mask(model: nn.Module) -> Dict[str, bool]:
    """JAX's OpenShape weight-decay mask, ``np.ndim(leaf) >= 2`` on JAX's
    shapes (vitlens_tpu/cli/train_openshape.py): every tensor of a stacked
    trunk decays, its LayerNorm scales and biases included, while the
    perceiver's, the tokenizer's and the heads' 1-D tensors do not."""
    return {n: jax_ndim(n, p) >= 2 for n, p in model.named_parameters()}


def openshape_loss(model: nn.Module, batch: Dict[str, Tensor], *,
                   text_weight: float = 1.0, image_weight: float = 1.0,
                   use_text_proj: bool = False, use_image_proj: bool = False,
                   mask: Optional[Tensor] = None,
                   compute_dtype=torch.float32, train: bool = True,
                   fps_start: Optional[Tensor] = None,
                   fps_generator: Optional[torch.Generator] = None,
                   axis_name=None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The OpenShape step loss (train.py:255-330): the bind's prediction
    from ``batch["xyz_features"]`` against the precomputed
    ``batch["text_feat"]`` and ``batch["img_feat"]`` (each through its
    projection when asked), in fp32. Returns (loss, {text_loss, img_loss,
    text_acc, img_acc}). With ``axis_name`` (a ``parallel.mesh.Mesh`` or
    ``"data"``) the features gather over the ranks and the BatchNorms of
    the bind sync their moments in train mode, as JAX's ``bn_axis_name``."""
    mesh = data_axis(axis_name)
    with batch_norm_synced(model, mesh if train else None):
        pred = model(batch["xyz_features"], compute_dtype, train=train,
                     fps_start=fps_start, fps_generator=fps_generator)
    scale = model.logit_scale.exp()
    text_feat = batch["text_feat"].float()
    img_feat = batch["img_feat"].float()
    if use_text_proj:
        text_feat = model.text_proj(text_feat)
    if use_image_proj:
        img_feat = model.image_proj(img_feat)
    t_loss, t_acc = contras_loss(pred, text_feat, scale, mask, mesh)
    i_loss, i_acc = contras_loss(pred, img_feat, scale, mask, mesh)
    loss = text_weight * t_loss + image_weight * i_loss
    metrics = {"text_loss": t_loss.detach(), "img_loss": i_loss.detach(),
               "text_acc": t_acc, "img_acc": i_acc}
    return loss, metrics


def make_openshape_step(tx, *, text_weight: float = 1.0,
                        image_weight: float = 1.0, use_text_proj: bool = False,
                        use_image_proj: bool = False,
                        compute_dtype=torch.float32, mesh=None):
    """The trainer's step: ``step(model, opt_state, batch, fps_generator=None,
    fps_start=None) -> metrics``. The gradient of :func:`openshape_loss` in
    train mode for every parameter (zeros where none flows: the skipped
    trunk blocks, the unused projections), then ``tx`` (an ``AdamW`` from
    ``train.step.make_openshape_optimizer``) updates the model in place.
    ``logit_scale`` is not clamped, as in JAX. With ``mesh`` (one process a
    rank, each with its rows of the global batch) the loss gathers over the
    ranks and the gradients are averaged before the update, as JAX's
    ``shard_map`` step."""
    from vitlens_tpu_torch.parallel.mesh import average_gradients_
    from vitlens_tpu_torch.train.step import _grads, _step_mesh

    mesh = _step_mesh(mesh, "ddp")

    def step(model: nn.Module, opt_state, batch,
             fps_generator: Optional[torch.Generator] = None,
             fps_start: Optional[Tensor] = None) -> Dict[str, Tensor]:
        dev = model.logit_scale.device
        batch = {k: torch.as_tensor(batch[k]).to(dev)
                 for k in ("xyz_features", "text_feat", "img_feat")}
        params = dict(model.named_parameters())
        loss, metrics = openshape_loss(
            model, batch, text_weight=text_weight, image_weight=image_weight,
            use_text_proj=use_text_proj, use_image_proj=use_image_proj,
            compute_dtype=compute_dtype, train=True, fps_start=fps_start,
            fps_generator=fps_generator, axis_name=mesh)
        grads = _grads(loss, params)
        if mesh is not None:
            average_gradients_(grads, mesh)
        tx.update_(params, grads, opt_state)
        return dict(metrics, loss=loss.detach())

    return step


# ---------------------------------------------------------------------------
# dataset ("Four" triplets, data.py:19-296) and eval
# ---------------------------------------------------------------------------


class OpenShapeTripletDataset:
    """Per-object npy blobs with xyz/rgb + precomputed CLIP text/img feats.
    y-up swap, a 10k-point sample, unit-ball normalisation, z-rotation and
    rgb-drop augmentations."""

    def __init__(self, file_list, npoints: int = 10000, y_up: bool = True,
                 augment: bool = True, rgb_drop_prob: float = 0.5,
                 use_color: bool = True, seed: int = 0):
        from vitlens_tpu_torch.data.rng import ThreadLocalRNG

        self.files = list(file_list)
        self.npoints = npoints
        self.y_up = y_up
        self.augment = augment
        self.rgb_drop_prob = rgb_drop_prob
        self.use_color = use_color
        self.rng = ThreadLocalRNG(seed)  # loader threads share this dataset

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        blob = np.load(self.files[idx], allow_pickle=True).item()
        xyz = np.asarray(blob["xyz"], np.float32)
        rgb = np.asarray(blob.get("rgb", np.full_like(xyz, 0.4)), np.float32)
        n = xyz.shape[0]
        sel = self.rng.permutation(n)[: self.npoints]
        if len(sel) < self.npoints:
            sel = np.concatenate(
                [sel, self.rng.randint(0, n, self.npoints - len(sel))])
        xyz, rgb = xyz[sel], rgb[sel]
        if self.y_up:  # swap y/z (reference data.py get_others)
            xyz = xyz[:, [0, 2, 1]]
        xyz = xyz - xyz.mean(0)
        xyz = xyz / np.maximum(np.linalg.norm(xyz, axis=1).max(), 1e-6)
        if self.augment:
            theta = self.rng.uniform(0, 2 * np.pi)
            c, s = np.cos(theta), np.sin(theta)
            rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
            xyz = xyz @ rot.T
            if self.rng.random_sample() < self.rgb_drop_prob:
                rgb = np.full_like(rgb, 0.4)
        feats = np.concatenate([xyz, rgb], axis=1) if self.use_color else xyz
        return {
            "id": idx,
            "xyz_features": feats,  # [:, :3] = xyz; all 6 = SA features
            "text_feat": np.asarray(blob["text_feat"], np.float32).reshape(-1),
            "img_feat": np.asarray(blob["img_feat"], np.float32).reshape(-1),
        }


def precomputed_text_eval(pred_feats: np.ndarray, labels: np.ndarray,
                          class_text_feats: np.ndarray,
                          topk=(1, 3, 5)) -> Dict[str, float]:
    """ModelNet40/LVIS/ScanObjectNN eval against precomputed per-class text
    embeddings (train.py:608-715): top-k and macro top-1 accuracy."""

    def n(x):
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)

    logits = n(pred_feats) @ n(class_text_feats).T
    order = np.argsort(-logits, axis=1)
    out = {}
    for k in topk:
        out[f"top{k}"] = float(
            np.mean(np.any(order[:, :k] == labels[:, None], axis=1)))
    cls_accs = []
    for c in np.unique(labels):
        m = labels == c
        cls_accs.append(np.mean(order[m, 0] == c))
    out["class_top1"] = float(np.mean(cls_accs))
    return out
