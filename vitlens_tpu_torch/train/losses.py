"""Contrastive losses, single device (port of vitlens_tpu/train/losses.py with
no mesh axis).

The reference loss zoo (ClipLoss/ClipLossGeneral, TriClipLoss, the label and
similarity masks, TriClipDistillTokenLoss, DistillClipLoss, CoCaLoss) on one device: the JAX
package's ``axis_name=None`` branch. All loss math runs in fp32 whatever the
feature dtype. The embedding all-gather over a data mesh waits for the
parallelism work (ROADMAP Queue 1, item 12).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

Tensor = torch.Tensor


def cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean softmax cross-entropy with integer labels (F.cross_entropy)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels[:, None])[:, 0]
    return (lse - picked).mean()


def _pair_logits(x: Tensor, y: Tensor, logit_scale: Tensor,
                 mask: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """(logits_per_x, logits_per_y, labels). ``mask``: optional [B, B]
    multiplicative 0/1 mask applied as the reference does (logits * mask)."""
    x, y = x.float(), y.float()
    scale = logit_scale.float()
    lx = scale * x @ y.t()
    ly = scale * y @ x.t()
    if mask is not None:
        lx = lx * mask
        ly = ly * mask.t()
    return lx, ly, torch.arange(x.shape[0], device=x.device)


def clip_loss(x_features: Tensor, y_features: Tensor, logit_scale: Tensor, *,
              mask: Optional[Tensor] = None) -> Tensor:
    """Symmetric InfoNCE between two feature sets (reference
    ClipLoss/ClipLossGeneral, loss.py:234-385)."""
    lx, ly, labels = _pair_logits(x_features, y_features, logit_scale, mask)
    return 0.5 * (cross_entropy(lx, labels) + cross_entropy(ly, labels))


def tri_clip_loss(image_features: Tensor, text_features: Tensor,
                  visual_features: Tensor, logit_scale: Tensor, *,
                  mask: Optional[Tensor] = None) -> Tensor:
    """CE(I<->V) + CE(T<->V), each a full symmetric CE (reference TriClipLoss,
    loss.py:140-165)."""
    return (clip_loss(image_features, visual_features, logit_scale, mask=mask)
            + clip_loss(text_features, visual_features, logit_scale, mask=mask))


def label_mask(x_labels: Tensor, y_labels: Tensor) -> Tensor:
    """0/1 mask zeroing same-label negatives, keeping the diagonal
    (reference ClipLossLabelMask, loss.py:601-746)."""
    same = x_labels[:, None] == y_labels[None, :]
    eye = torch.eye(x_labels.shape[0], dtype=torch.bool, device=x_labels.device)
    return ((~same) | eye).float()


def sim_mask(teacher_features: Tensor, sim_thres: float = 0.9) -> Tensor:
    """0/1 mask zeroing negatives whose teacher-feature similarity reaches
    ``sim_thres`` (reference ClipLossSimMask, loss.py:485-598)."""
    t = teacher_features.float()
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
                      dist_text_features: Tensor, dist_logit_scale: Tensor
                      ) -> Tuple[Tensor, Tensor]:
    """Contrastive + teacher-logit distillation (reference DistillClipLoss,
    loss.py:388-482): (contrastive, distill)."""
    lx, ly, labels = _pair_logits(image_features, text_features, logit_scale)
    tx, ty, _ = _pair_logits(dist_image_features, dist_text_features,
                             dist_logit_scale)
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
    ``contrastive_loss_weight`` and ``caption_loss_weight``."""
    if axis_name is not None:
        raise NotImplementedError(
            "the CoCa loss over a data mesh (axis_name) is not yet ported: "
            "ROADMAP Queue 1, item 12a (data parallelism)")
    contrastive = cfg.contrastive_loss_weight * clip_loss(
        out["image_features"], out["text_features"], out["logit_scale"])
    caption = caption_loss(out["logits"], out["labels"], pad_id=cfg.pad_id,
                           weight=cfg.caption_loss_weight)
    return contrastive, caption


def make_loss_fn(n_tower: int = 3, contra_loss_type: str = "general", *,
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
            return label_mask(labels, labels)
        if contra_loss_type == "sim_mask":
            return sim_mask(anchor, sim_thres)
        return None

    if n_tower == 3 or contra_loss_type == "distill_token":
        def tri_fn(out: Dict[str, Tensor], labels=None) -> Tensor:
            loss = tri_clip_loss(out["image_features"], out["text_features"],
                                 out["visual_features"], out["logit_scale"],
                                 mask=mask_for(out["image_features"], labels))
            if contra_loss_type == "distill_token":
                loss = loss + distill_token_loss(out["visual_tokens"],
                                                 out["image_tokens"])
            return loss

        return tri_fn

    def dual_fn(out: Dict[str, Tensor], labels=None) -> Tensor:
        anchor = out["anchor_features"]
        return clip_loss(anchor, out["visual_features"], out["logit_scale"],
                         mask=mask_for(anchor, labels))

    return dual_fn
