"""Zero-shot evaluation harness (port of vitlens_tpu/eval/zero_shot.py: numpy
on the host; the encode callables run the towers, e.g. the port's
``models.tri.encode_visual`` / ``encode_text`` on the card).

Re-design of the reference per-benchmark eval loops
(training/zero_shot.py and
open_clip/zero_shot_classifier.py:27-88): a template-averaged classifier
constructor plus generic runners dispatched by `eval_metric` in
{"acc", "map", "recall"} — the same dispatch key the reference datasets carry
(modal_audio/datasets.py `.eval_metric`).

Runners take callables + batch iterables, so they work with any tower and
any data pipeline. Classifier logits intentionally use the plain feature
inner product (reference uses `feat @ text.T`, scale-free for argmax).
``distributed=True`` (the default) merges the metrics over the process
group, each process having seen its own samples; the trainer's eval over a
mesh gathers every rank's features of the whole val set first and passes
False, as JAX's does, so that no sample counts once a rank.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from vitlens_tpu_torch.eval.metadata import expand_templates
from vitlens_tpu_torch.eval.metrics import MAP, Accuracy, Recall


def _l2n(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def _encode_feats(encode_visual, x: np.ndarray, clip_mean: bool) -> np.ndarray:
    """Shared by every runner. clip_mean: inputs are [B, n_clip, ...];
    unnormalized clip features -> mean -> normalize ONCE (reference
    zero_shot.py:684-695)."""
    if clip_mean:
        B, S = x.shape[:2]
        feats = np.asarray(
            encode_visual(x.reshape((B * S,) + x.shape[2:])), np.float32
        )
        return _l2n(feats.reshape(B, S, -1).mean(axis=1))
    return _l2n(np.asarray(encode_visual(x), np.float32))


def build_zero_shot_classifier(
    encode_text: Callable[[np.ndarray], np.ndarray],
    tokenizer: Callable[[Sequence[str]], np.ndarray],
    classnames: Sequence[str],
    templates: Sequence,
) -> np.ndarray:
    """[num_classes, D]: per class, encode all template prompts, normalize,
    mean, normalize again (reference zero_shot.py:174-190)."""
    feats = []
    for name in classnames:
        texts = expand_templates(templates, name)
        emb = np.asarray(encode_text(tokenizer(texts)), np.float32)
        emb = _l2n(emb).mean(axis=0)
        feats.append(_l2n(emb[None])[0])
    return np.stack(feats)


def classification_eval(
    encode_visual: Callable[[np.ndarray], np.ndarray],
    batches: Iterable[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    classifier: np.ndarray,
    *,
    topk: Sequence[int] = (1, 5),
    classnames: Optional[Sequence[str]] = None,
    clip_mean: bool = False,
    distributed: bool = True,
) -> Dict:
    """batches yield (ids, inputs, targets). Returns accuracy + top-k and
    per-class stats (reference test_zeroshot_3d_core :193-253).
    clip_mean: inputs are [B, n_clip, ...]; clip embeddings mean-pooled
    (reference zero_shot.py:615-624)."""
    acc = Accuracy(distributed=distributed)
    per_class_cnt: Dict[int, int] = defaultdict(int)
    per_class_topk = {k: defaultdict(int) for k in topk}
    total = {k: 0 for k in topk}
    n = 0
    for ids, x, targets in batches:
        x = np.asarray(x)
        feats = _encode_feats(encode_visual, x, clip_mean)
        logits = feats @ classifier.T
        acc.compute(ids, logits, targets)
        targets = np.asarray(targets)
        kmax = max(topk)
        top = np.argsort(-logits, axis=1, kind="stable")[:, :kmax]
        for k in topk:
            hit = np.any(top[:, :k] == targets[:, None], axis=1)
            total[k] += int(hit.sum())
            for t, h in zip(targets.tolist(), hit.tolist()):
                per_class_topk[k][t] += int(h)
        for t in targets.tolist():
            per_class_cnt[t] += 1
        n += len(targets)

    out = acc.merge_results()
    for k in topk:
        out[f"top{k}"] = total[k] / max(n, 1)
    if classnames is not None:
        out["per_class_top1"] = {
            classnames[c]: per_class_topk[1][c] / max(cnt, 1)
            for c, cnt in per_class_cnt.items()
        }
    return out


def map_eval(
    encode_visual: Callable[[np.ndarray], np.ndarray],
    batches: Iterable[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    classifier: np.ndarray,
    *,
    logit_scale: float = 1.0,
    clip_mean: bool = False,
    distributed: bool = True,
) -> Dict:
    """AudioSet-style multi-label mAP (reference zero_shot.py:572-639)."""
    m = MAP(distributed=distributed)
    for ids, x, targets in batches:
        x = np.asarray(x)
        feats = _encode_feats(encode_visual, x, clip_mean)
        logits = logit_scale * feats @ classifier.T
        m.compute(ids, logits, targets)
    return m.merge_results()


def retrieval_eval(
    encode_visual: Callable[[np.ndarray], np.ndarray],
    encode_text: Callable[[np.ndarray], np.ndarray],
    tokenizer: Callable[[Sequence[str]], np.ndarray],
    batches: Iterable[Tuple[np.ndarray, np.ndarray]],
    texts: Sequence[str],
    text_ids: Sequence[int],
    *,
    text_batch: int = 256,
    clip_mean: bool = False,
    distributed: bool = True,
) -> Dict:
    """Cross-modal retrieval R@K (reference zero_shot.py:641-788): encode the
    text corpus, stream visual batches, rank both directions."""
    tfeats = []
    for i in range(0, len(texts), text_batch):
        ids = tokenizer(list(texts[i:i + text_batch]))
        tfeats.append(np.asarray(encode_text(ids), np.float32))
    tfeats = _l2n(np.concatenate(tfeats))
    rec = Recall(np.asarray(text_ids), tfeats, distributed=distributed)
    for ids, x in batches:
        x = np.asarray(x)
        feats = _encode_feats(encode_visual, x, clip_mean)
        rec.compute(ids, feats)
    return rec.merge_results()


def video_retrieval_eval(
    encode_visual: Callable[[np.ndarray], np.ndarray],
    encode_text: Callable[[np.ndarray], np.ndarray],
    tokenizer: Callable[[Sequence[str]], np.ndarray],
    batches: Iterable[Tuple[np.ndarray, np.ndarray, Sequence[str]]],
    *,
    frame_mean_pool: bool = False,
    n_frames: int = 8,
) -> Dict:
    """Video<->text retrieval (reference test_vidret_single,
    zero_shot.py:460-569): batches yield (video_ids, video_inputs,
    captions); duplicate video ids (multi-caption) are deduped on the video
    side; with frame_mean_pool the encoder sees per-frame inputs [(B T), ...]
    and frame embeddings are mean-pooled before normalisation."""
    vid_feats: Dict[int, np.ndarray] = {}
    text_feats = []
    text_ids = []
    for ids, x, captions in batches:
        x = np.asarray(x)
        feats = np.asarray(encode_visual(x), np.float32)
        if frame_mean_pool:
            feats = feats.reshape(-1, n_frames, feats.shape[-1]).mean(axis=1)
        feats = _l2n(feats)
        tf = _l2n(np.asarray(encode_text(tokenizer(list(captions))), np.float32))
        for i, vid in enumerate(np.asarray(ids).tolist()):
            if vid not in vid_feats:
                vid_feats[vid] = feats[i]
            text_feats.append(tf[i])
            text_ids.append(vid)
    keys = sorted(vid_feats)
    video = np.stack([vid_feats[k] for k in keys])
    video_ids = np.asarray(keys)
    sim_i2t = video @ np.stack(text_feats).T
    return Recall.retrieval_eval(video_ids, np.asarray(text_ids), sim_i2t)


def run_eval(
    eval_metric: str,
    **kwargs,
) -> Dict:
    """Dispatch like the reference test_audiotasks_core (zero_shot.py:791-810)."""
    if eval_metric in ("acc", "accuracy"):
        return classification_eval(**kwargs)
    if eval_metric == "map":
        return map_eval(**kwargs)
    if eval_metric in ("recall", "ret"):
        return retrieval_eval(**kwargs)
    raise ValueError(eval_metric)
