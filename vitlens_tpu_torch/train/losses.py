"""Contrastive losses (port of vitlens_tpu/train/losses.py).

The reference loss zoo (ClipLoss/ClipLossGeneral, TriClipLoss, the label and
similarity masks, TriClipDistillTokenLoss, DistillClipLoss, CoCaLoss). With
``axis_name`` (a ``parallel.mesh.Mesh`` that spans processes, or ``"data"``
for the process group) the embeddings are all-gathered over the ranks with
their gradient (the reference's ``--gather-with-grad``), and ``local_loss``
computes only this rank's ``[B_local, B_global]`` logit block with
rank-offset labels, as JAX's ``shard_map`` branch does. All loss math runs
in fp32 whatever the feature dtype.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from vitlens_tpu_torch.parallel.mesh import all_gather, data_axis

Tensor = torch.Tensor


def cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean softmax cross-entropy with integer labels (F.cross_entropy)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels[:, None])[:, 0]
    return (lse - picked).mean()


def gather_features(x: Tensor, axis_name=None) -> Tensor:
    """All-gather embeddings over the data axis, rank-major, with their
    gradient. The identity without an axis."""
    mesh = data_axis(axis_name)
    return x if mesh is None else all_gather(x, mesh)


def _pair_logits(x: Tensor, y: Tensor, logit_scale: Tensor, axis_name=None,
                 local_loss: bool = False, mask: Optional[Tensor] = None
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """(logits_per_x, logits_per_y, labels). ``mask``: optional [B_global,
    B_global] multiplicative 0/1 mask built from gathered quantities,
    applied as the reference does (logits * mask)."""
    x, y = x.float(), y.float()
    scale = logit_scale.float()
    mesh = data_axis(axis_name)
    if mesh is None:
        lx = scale * x @ y.t()
        ly = scale * y @ x.t()
        if mask is not None:
            lx = lx * mask
            ly = ly * mask.t()
        return lx, ly, torch.arange(x.shape[0], device=x.device)
    all_x, all_y = all_gather(x, mesh), all_gather(y, mesh)
    if local_loss:
        b = x.shape[0]
        lx = scale * x @ all_y.t()
        ly = scale * y @ all_x.t()
        row0 = mesh.rank * b
        if mask is not None:
            lx = lx * mask[row0:row0 + b]
            ly = ly * mask.t()[row0:row0 + b]
        return lx, ly, torch.arange(b, device=x.device) + row0
    lx = scale * all_x @ all_y.t()
    if mask is not None:
        lx = lx * mask
    return lx, lx.t(), torch.arange(all_x.shape[0], device=x.device)


def clip_loss(x_features: Tensor, y_features: Tensor, logit_scale: Tensor, *,
              axis_name=None, local_loss: bool = False,
              mask: Optional[Tensor] = None) -> Tensor:
    """Symmetric InfoNCE between two feature sets (reference
    ClipLoss/ClipLossGeneral, loss.py:234-385)."""
    lx, ly, labels = _pair_logits(x_features, y_features, logit_scale,
                                  axis_name, local_loss, mask)
    return 0.5 * (cross_entropy(lx, labels) + cross_entropy(ly, labels))


def tri_clip_loss(image_features: Tensor, text_features: Tensor,
                  visual_features: Tensor, logit_scale: Tensor, *,
                  axis_name=None, local_loss: bool = False,
                  mask: Optional[Tensor] = None) -> Tensor:
    """CE(I<->V) + CE(T<->V), each a full symmetric CE (reference TriClipLoss,
    loss.py:140-165)."""
    kw = dict(axis_name=axis_name, local_loss=local_loss, mask=mask)
    return (clip_loss(image_features, visual_features, logit_scale, **kw)
            + clip_loss(text_features, visual_features, logit_scale, **kw))


def label_mask(x_labels: Tensor, y_labels: Tensor, axis_name=None) -> Tensor:
    """0/1 mask zeroing same-label negatives, keeping the diagonal
    (reference ClipLossLabelMask, loss.py:601-746), over the gathered
    labels."""
    ax = gather_features(x_labels, axis_name)
    ay = gather_features(y_labels, axis_name)
    same = ax[:, None] == ay[None, :]
    eye = torch.eye(ax.shape[0], dtype=torch.bool, device=ax.device)
    return ((~same) | eye).float()


def sim_mask(teacher_features: Tensor, sim_thres: float = 0.9,
             axis_name=None) -> Tensor:
    """0/1 mask zeroing negatives whose teacher-feature similarity reaches
    ``sim_thres`` (reference ClipLossSimMask, loss.py:485-598), over the
    gathered features."""
    t = gather_features(teacher_features, axis_name).float()
    sim = t @ t.t()
    eye = torch.eye(t.shape[0], dtype=torch.bool, device=t.device)
    return ((~(sim >= sim_thres)) | eye).float()


def distill_token_loss(visual_tokens: Tensor, image_tokens: Tensor,
                       loss_type: str = "mse") -> Tensor:
    """Token-level distillation (reference TriClipDistillTokenLoss,
    loss.py:192-231): the mean squared error, or the negative mean cosine,
    of the Lens tower's tokens against the image tower's."""
    v, t = visual_tokens.float(), image_tokens.float()
    if loss_type == "mse":
        return (v - t).square().mean()
    if loss_type == "cos":
        vn = v / v.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        tn = t / t.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return -(vn * tn).sum(-1).mean()
    raise ValueError(loss_type)


def distill_clip_loss(image_features: Tensor, text_features: Tensor,
                      logit_scale: Tensor, dist_image_features: Tensor,
                      dist_text_features: Tensor, dist_logit_scale: Tensor, *,
                      axis_name=None, local_loss: bool = False
                      ) -> Tuple[Tensor, Tensor]:
    """Contrastive + teacher-logit distillation (reference DistillClipLoss,
    loss.py:388-482): (contrastive, distill)."""
    lx, ly, labels = _pair_logits(image_features, text_features, logit_scale,
                                  axis_name, local_loss)
    tx, ty, _ = _pair_logits(dist_image_features, dist_text_features,
                             dist_logit_scale, axis_name, local_loss)
    contrastive = 0.5 * (cross_entropy(lx, labels) + cross_entropy(ly, labels))

    def ce_soft(teacher_logits, student_logits):
        t = torch.softmax(teacher_logits.float(), dim=1)
        return (-(t * torch.log_softmax(student_logits.float(), dim=1)).sum(1)).mean()

    return contrastive, 0.5 * (ce_soft(tx, lx) + ce_soft(ty, ly))


def caption_loss(logits: Tensor, labels: Tensor, pad_id: int = 0,
                 weight: float = 2.0) -> Tensor:
    """Autoregressive caption CE with pad masking (reference CoCaLoss,
    loss.py:168-231)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels[..., None])[..., 0]
    valid = (labels != pad_id).float()
    return weight * ((lse - picked) * valid).sum() / valid.sum().clamp_min(1.0)


def coca_loss(out: Dict[str, Tensor], cfg, axis_name=None) -> Tuple[Tensor, Tensor]:
    """CoCaLoss (loss.py:168-231): (contrastive, caption) of a
    ``models.coca.CoCa`` forward's output, weighted by ``cfg``'s
    ``contrastive_loss_weight`` and ``caption_loss_weight``. With
    ``axis_name`` the contrastive term gathers the features over the ranks
    (the full matrix, as JAX's); the caption term is this rank's."""
    contrastive = cfg.contrastive_loss_weight * clip_loss(
        out["image_features"], out["text_features"], out["logit_scale"],
        axis_name=axis_name)
    caption = caption_loss(out["logits"], out["labels"], pad_id=cfg.pad_id,
                           weight=cfg.caption_loss_weight)
    return contrastive, caption


def make_loss_fn(n_tower: int = 3, contra_loss_type: str = "general", *,
                 axis_name=None, local_loss: bool = False,
                 sim_thres: float = 0.9) -> Callable[..., Tensor]:
    """The training loss keyed as the reference CLI (--n_tower,
    --contra_loss_type {general, label_mask, sim_mask, distill_token}).
    The distill-token objective is the tri loss plus the token distillation
    (both weights 1), whatever ``n_tower``: only the video-distill forward
    feeds it, and that forward gives every tri key."""
    known = ("general", "label_mask", "sim_mask", "distill_token")
    if contra_loss_type not in known:
        raise ValueError(f"unknown contra_loss_type {contra_loss_type!r}; "
                         f"expected one of {known}")

    def mask_for(anchor: Tensor, labels) -> Optional[Tensor]:
        if contra_loss_type == "label_mask" and labels is not None:
            return label_mask(labels, labels, axis_name)
        if contra_loss_type == "sim_mask":
            return sim_mask(anchor, sim_thres, axis_name)
        return None

    kw = dict(axis_name=axis_name, local_loss=local_loss)

    if n_tower == 3 or contra_loss_type == "distill_token":
        def tri_fn(out: Dict[str, Tensor], labels=None) -> Tensor:
            loss = tri_clip_loss(out["image_features"], out["text_features"],
                                 out["visual_features"], out["logit_scale"],
                                 mask=mask_for(out["image_features"], labels),
                                 **kw)
            if contra_loss_type == "distill_token":
                loss = loss + distill_token_loss(out["visual_tokens"],
                                                 out["image_tokens"])
            return loss

        return tri_fn

    def dual_fn(out: Dict[str, Tensor], labels=None) -> Tensor:
        anchor = out["anchor_features"]
        return clip_loss(anchor, out["visual_features"], out["logit_scale"],
                         mask=mask_for(anchor, labels), **kw)

    return dual_fn
