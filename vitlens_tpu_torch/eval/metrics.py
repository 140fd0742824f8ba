"""Evaluation metrics: Accuracy, mAP, Recall@K (port of
vitlens_tpu/eval/metrics.py, numpy on the host as there).

Re-design of the reference metric accumulators
(open_clip/metrics/{accuracy,map,recall}.py): pure numpy accumulators on the
host (the eval loops move features device->host once per batch). The merge
across processes is the identity in one process, and an all-gather of the
numpy results over the ``torch.distributed`` group with more (each process
having seen its own samples). sklearn is not required — AP is computed from
the precision-recall definition it implements.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from vitlens_tpu_torch.parallel.mesh import all_gather_object as _all_gather_object
from vitlens_tpu_torch.parallel.mesh import process_count


def average_precision(targets: np.ndarray, scores: np.ndarray) -> float:
    """Binary AP == sklearn.average_precision_score: sum over descending
    score THRESHOLDS of (R_n - R_{n-1}) * P_n. Tied scores form ONE
    threshold (sklearn semantics) — a per-sample cumsum would make the
    result depend on input order whenever scores collide."""
    order = np.argsort(-scores, kind="stable")
    t = targets[order]
    s = scores[order]
    n_pos = t.sum()
    if n_pos == 0:
        return 0.0
    tp = np.cumsum(t)
    fp = np.cumsum(1 - t)
    # keep only the LAST sample of each tied-score run: P/R are evaluated
    # once per distinct threshold, with all tied samples included
    last = np.ones(len(s), bool)
    last[:-1] = s[:-1] != s[1:]
    tp, fp = tp[last], fp[last]
    precision = tp / (tp + fp)
    recall = tp / n_pos
    prev_r = np.concatenate([[0.0], recall[:-1]])
    return float(np.sum((recall - prev_r) * precision))


def mean_average_precision(targets: np.ndarray, scores: np.ndarray) -> float:
    """targets [N, C] multi-hot, scores [N, C] (pre- or post-sigmoid; AP is
    rank-based so either works). Mean over classes (average=None then mean,
    matching metrics/map.py:50)."""
    aps = [average_precision(targets[:, c], scores[:, c])
           for c in range(targets.shape[1])]
    return float(np.mean(aps))


def cond_topk_correct(logits: np.ndarray, targets: np.ndarray,
                      merge_indices, merge_to: int = 100,
                      topk=(1, 5)):
    """Top-k correctness where a set of equivalent class indices is merged
    (reference cond_acc, zero_shot.py:62-81 — NYU duplicate scene classes):
    both predictions and targets in `merge_indices` are mapped to `merge_to`
    before comparison. Returns {k: n_correct}."""
    logits = np.asarray(logits)
    targets = np.asarray(targets).copy()
    kmax = max(topk)
    pred = np.argsort(-logits, axis=1, kind="stable")[:, :kmax].copy()
    for idx in merge_indices:
        targets[targets == idx] = merge_to
        pred[pred == idx] = merge_to
    out = {}
    for k in topk:
        out[k] = float(np.any(pred[:, :k] == targets[:, None], axis=1).sum())
    return out


class Accuracy:
    """Streaming top-1 accuracy (metrics/accuracy.py:8-56). `targets` may be
    class ids [N] or multi-hot [N, C] (correct if predicted class is hot).

    distributed=False skips the cross-process merge: the CLI's mesh eval
    gathers every rank's features of the FULL val set before the metrics,
    so merging would count each sample process_count times."""

    def __init__(self, distributed: bool = True):
        self.distributed = distributed
        self.score_sum = 0.0
        self.score_cnt = 0
        self.ids: List[np.ndarray] = []
        self.hyps: List[np.ndarray] = []

    def compute(self, ids, logits, targets):
        logits = np.asarray(logits)
        targets = np.asarray(targets)
        pred = logits.argmax(axis=1)
        if targets.ndim == 2:
            n_correct = targets[np.arange(len(pred)), pred].sum()
        else:
            n_correct = (pred == targets).sum()
        self.score_sum += float(n_correct)
        self.score_cnt += logits.shape[0]
        self.ids.append(np.asarray(ids))
        self.hyps.append(pred)

    def merge_results(self, output_predict: bool = False) -> Dict:
        merge = _dist_merge if self.distributed else (lambda *a: a)
        score_sum, score_cnt, ids, hyps = merge(
            self.score_sum, self.score_cnt,
            np.concatenate(self.ids) if self.ids else np.zeros(0, np.int64),
            np.concatenate(self.hyps) if self.hyps else np.zeros(0, np.int64),
        )
        out = {
            "accuracy": score_sum / max(score_cnt, 1),
            "score_sum": score_sum,
            "score_cnt": score_cnt,
            "predict_results": (
                dict(zip(ids.tolist(), hyps.tolist())) if output_predict else {}
            ),
        }
        return out


class MAP:
    """Streaming mean average precision over sigmoid scores
    (metrics/map.py:12-55)."""

    def __init__(self, distributed: bool = True):
        self.distributed = distributed  # see Accuracy docstring
        self.logits: List[np.ndarray] = []
        self.targets: List[np.ndarray] = []

    def compute(self, ids, logits, targets):
        del ids
        self.logits.append(np.asarray(logits, np.float64))
        self.targets.append(np.asarray(targets))

    def merge_results(self, output_predict: bool = False) -> Dict:
        if not self.logits:  # empty val split / empty shard
            return {"map": 0.0, "map_cnt": 0, "predict_results": {}}
        logits = np.concatenate(self.logits)
        targets = np.concatenate(self.targets)
        if self.distributed:
            logits, targets = _dist_concat(logits), _dist_concat(targets)
        scores = 1.0 / (1.0 + np.exp(-logits))
        return {
            "map": mean_average_precision(targets, scores),
            "map_cnt": len(targets),
            "predict_results": {},
        }


class Recall:
    """Bidirectional retrieval R@{1,5,10} (metrics/recall.py:8-80). ids map
    items to their ground-truth group (multiple captions per item share an
    id)."""

    def __init__(self, text_ids, text_feats, distributed: bool = True):
        self.distributed = distributed  # see Accuracy docstring
        self.text_ids = np.asarray(text_ids)
        self.text_feats = np.asarray(text_feats, np.float32)
        self.image_ids: List[np.ndarray] = []
        self.image_feats: List[np.ndarray] = []

    def compute(self, image_ids, image_feats):
        self.image_ids.append(np.asarray(image_ids))
        self.image_feats.append(np.asarray(image_feats, np.float32))

    def merge_results(self, output_predict: bool = False) -> Dict:
        image_ids = np.concatenate(self.image_ids)
        image_feats = np.concatenate(self.image_feats)
        if self.distributed:
            image_ids = _dist_concat(image_ids)
            image_feats = _dist_concat(image_feats)
        sim_i2t = image_feats @ self.text_feats.T
        return self.retrieval_eval(image_ids, self.text_ids, sim_i2t)

    @staticmethod
    def retrieval_eval(image_ids, text_ids, sim_i2t) -> Dict:
        def ranks(scores, row_ids, col_ids):
            k = min(10, scores.shape[1])
            top = np.argsort(-scores, axis=1, kind="stable")[:, :k]
            hit_ids = col_ids[top]  # [N, 10]
            out = []
            for r in (1, 5, 10):
                rr = min(r, k)
                out.append(
                    float(np.any(hit_ids[:, :rr] == row_ids[:, None], axis=1).sum())
                )
            return out

        i2t = ranks(sim_i2t, image_ids, text_ids)
        t2i = ranks(sim_i2t.T, text_ids, image_ids)
        n_img, n_txt = sim_i2t.shape
        tr = [100.0 * c / n_img for c in i2t]
        ir = [100.0 * c / n_txt for c in t2i]
        return {
            "txt_r1": tr[0], "txt_r5": tr[1], "txt_r10": tr[2],
            "txt_r_mean": sum(tr) / 3,
            "img_r1": ir[0], "img_r5": ir[1], "img_r10": ir[2],
            "img_r_mean": sum(ir) / 3,
            "r_mean": (sum(tr) / 3 + sum(ir) / 3) / 2,
            "img_count": n_img, "txt_count": n_txt,
        }


def clip_val_metrics(image_features: np.ndarray, text_features: np.ndarray,
                     logit_scale: float = 100.0) -> Dict[str, float]:
    """In-training validation metrics (reference get_clip_metrics,
    train.py:997-1014): paired-rank mean/median + R@{1,5,10} both
    directions, plus the symmetric contrastive val loss
    (reference evaluate, train.py:766-874)."""
    img = np.asarray(image_features, np.float64)
    txt = np.asarray(text_features, np.float64)
    lpi = logit_scale * img @ txt.T
    out: Dict[str, float] = {}
    gt = np.arange(len(txt))[:, None]
    for name, logits in (("image_to_text", lpi), ("text_to_image", lpi.T)):
        ranking = np.argsort(-logits, axis=1, kind="stable")
        preds = np.where(ranking == gt)[1]
        out[f"{name}_mean_rank"] = float(preds.mean() + 1)
        out[f"{name}_median_rank"] = float(np.floor(np.median(preds)) + 1)
        for k in (1, 5, 10):
            out[f"{name}_R@{k}"] = float(np.mean(preds < k))
    # symmetric CE val loss
    def ce(l):
        lse = l.max(axis=1) + np.log(
            np.exp(l - l.max(axis=1, keepdims=True)).sum(axis=1))
        return float(np.mean(lse - np.diagonal(l)))

    out["clip_val_loss"] = 0.5 * (ce(lpi) + ce(lpi.T))
    return out


# ---------------------------------------------------------------------------
# multi-host merging (single-host: identity)
# ---------------------------------------------------------------------------


def _n_processes() -> int:
    return process_count()


def _dist_concat(arr: np.ndarray) -> np.ndarray:
    if _n_processes() == 1:
        return arr
    return np.concatenate(_all_gather_object(np.asarray(arr)), axis=0)


def _dist_merge(score_sum, score_cnt, ids, hyps):
    if _n_processes() == 1:
        return score_sum, score_cnt, ids, hyps
    parts = _all_gather_object((float(score_sum), int(score_cnt),
                                np.asarray(ids), np.asarray(hyps)))
    return (float(sum(p[0] for p in parts)), int(sum(p[1] for p in parts)),
            np.concatenate([p[2] for p in parts]),
            np.concatenate([p[3] for p in parts]))
