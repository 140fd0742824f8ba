"""The port's eval package (vitlens_tpu_torch/eval: metrics.py, zero_shot.py,
metadata.py) against the JAX package's, on the same numpy features and the
same encode callables: every metric and every zero-shot runner within 1e-6,
the template sets and the metadata loaders equal."""

import json

import numpy as np
import pytest

from vitlens_tpu.eval import metadata as JMD
from vitlens_tpu.eval import metrics as JM
from vitlens_tpu.eval import zero_shot as JZ
from vitlens_tpu_torch.eval import metadata as PMD
from vitlens_tpu_torch.eval import metrics as PM
from vitlens_tpu_torch.eval import zero_shot as PZ


def _close(a, b, key=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), key
        for k in a:
            _close(a[k], b[k], k)
    elif isinstance(a, (float, np.floating, np.ndarray)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=key)
    else:
        assert a == b, key


def test_average_precision_and_map():
    rng = np.random.RandomState(0)
    for ties in (False, True):
        scores = rng.randn(50, 6)
        if ties:
            scores = np.round(scores, 1)
        targets = (rng.rand(50, 6) < 0.3).astype(np.float32)
        targets[:, 5] = 0  # a class without positives
        for c in range(6):
            _close(PM.average_precision(targets[:, c], scores[:, c]),
                   JM.average_precision(targets[:, c], scores[:, c]))
        _close(PM.mean_average_precision(targets, scores),
               JM.mean_average_precision(targets, scores))


def test_cond_topk_and_clip_val_metrics():
    rng = np.random.RandomState(1)
    logits, targets = rng.randn(20, 8), rng.randint(0, 8, 20)
    _close(PM.cond_topk_correct(logits, targets, [2, 5], merge_to=100),
           JM.cond_topk_correct(logits, targets, [2, 5], merge_to=100))
    img, txt = rng.randn(12, 16), rng.randn(12, 16)
    _close(PM.clip_val_metrics(img, txt, 33.0), JM.clip_val_metrics(img, txt, 33.0))


def test_accumulators():
    rng = np.random.RandomState(2)
    acc_p, acc_j = PM.Accuracy(), JM.Accuracy()
    map_p, map_j = PM.MAP(), JM.MAP()
    for b in range(3):
        ids, logits = np.arange(b * 5, b * 5 + 5), rng.randn(5, 4)
        tgt = rng.randint(0, 4, 5) if b else np.eye(4)[rng.randint(0, 4, 5)]
        acc_p.compute(ids, logits, tgt)
        acc_j.compute(ids, logits, tgt)
        mh = (rng.rand(5, 4) < 0.4).astype(np.float32)
        map_p.compute(ids, logits, mh)
        map_j.compute(ids, logits, mh)
    _close(acc_p.merge_results(True), acc_j.merge_results(True))
    _close(map_p.merge_results(), map_j.merge_results())
    _close(PM.MAP().merge_results(), JM.MAP().merge_results())
    text_ids = np.repeat(np.arange(6), 2)
    tf = rng.randn(12, 8).astype(np.float32)
    rec_p, rec_j = PM.Recall(text_ids, tf), JM.Recall(text_ids, tf)
    for b in range(2):
        ids, f = np.arange(b * 3, b * 3 + 3), rng.randn(3, 8).astype(np.float32)
        rec_p.compute(ids, f)
        rec_j.compute(ids, f)
    _close(rec_p.merge_results(), rec_j.merge_results())


class _Towers:
    """Seeded linear 'towers': the same numpy features on both sides."""

    def __init__(self, seed=0, dim=12):
        rng = np.random.RandomState(seed)
        self.wv = rng.randn(10, dim).astype(np.float32)
        self.emb = rng.randn(1000, dim).astype(np.float32)

    def visual(self, x):
        return np.asarray(x, np.float32).reshape(len(x), -1)[:, :10] @ self.wv

    def text(self, toks):
        return self.emb[np.asarray(toks) % 1000].sum(axis=1)


def _tok(texts):
    out = np.zeros((len(texts), 6), np.int64)
    for i, t in enumerate(texts):
        codes = [sum(map(ord, w)) for w in t.split()][:6]
        out[i, :len(codes)] = codes
    return out


def _batches(rng, n_batches, clip=False, multi=False, c=5):
    out = []
    for b in range(n_batches):
        shape = (4, 3, 2, 5) if clip else (4, 2, 5)
        x = rng.randn(*shape).astype(np.float32)
        tgt = ((rng.rand(4, c) < 0.4).astype(np.float32) if multi
               else rng.randint(0, c, 4))
        out.append((np.arange(b * 4, b * 4 + 4), x, tgt))
    return out


@pytest.mark.parametrize("clip_mean", [False, True])
def test_zero_shot_runners(clip_mean):
    t = _Towers()
    names = ["dog", "cat", "car horn", "rain", "sea waves"]
    tmpl = JMD.SOUND_AS_IMAGE_TEMPLATE
    clf_p = PZ.build_zero_shot_classifier(t.text, _tok, names, PMD.SOUND_AS_IMAGE_TEMPLATE)
    clf_j = JZ.build_zero_shot_classifier(t.text, _tok, names, tmpl)
    _close(clf_p, clf_j)
    rng = np.random.RandomState(3)
    bs = _batches(rng, 3, clip_mean)
    _close(PZ.classification_eval(t.visual, iter(bs), clf_p, classnames=names,
                                  clip_mean=clip_mean, distributed=False),
           JZ.classification_eval(t.visual, iter(bs), clf_j, classnames=names,
                                  clip_mean=clip_mean, distributed=False))
    mb = _batches(rng, 2, clip_mean, multi=True)
    _close(PZ.map_eval(t.visual, iter(mb), clf_p, logit_scale=7.0,
                       clip_mean=clip_mean),
           JZ.map_eval(t.visual, iter(mb), clf_j, logit_scale=7.0,
                       clip_mean=clip_mean))
    texts = [f"caption {i} of {names[i % 5]}" for i in range(12)]
    text_ids = [i // 2 for i in range(12)]
    rb = [(i, x) for i, x, _ in _batches(rng, 2, clip_mean)]
    kw = dict(texts=texts, text_ids=text_ids, text_batch=5, clip_mean=clip_mean)
    _close(PZ.retrieval_eval(t.visual, t.text, _tok, iter(rb), **kw),
           JZ.retrieval_eval(t.visual, t.text, _tok, iter(rb), **kw))
    _close(PZ.run_eval("recall", encode_visual=t.visual, encode_text=t.text,
                       tokenizer=_tok, batches=iter(rb), **kw),
           JZ.run_eval("recall", encode_visual=t.visual, encode_text=t.text,
                       tokenizer=_tok, batches=iter(rb), **kw))
    with pytest.raises(ValueError):
        PZ.run_eval("nosuch")


@pytest.mark.parametrize("pool", [False, True])
def test_video_retrieval_eval(pool):
    t = _Towers()
    rng = np.random.RandomState(4)
    bs = []
    for b in range(2):
        n = 4 * (3 if pool else 1)
        bs.append((np.array([b * 2, b * 2, b * 2 + 1, b * 2 + 1]),
                   rng.randn(n, 10).astype(np.float32),
                   [f"clip {b} caption {k}" for k in range(4)]))
    _close(PZ.video_retrieval_eval(t.visual, t.text, _tok, iter(bs),
                                   frame_mean_pool=pool, n_frames=3),
           JZ.video_retrieval_eval(t.visual, t.text, _tok, iter(bs),
                                   frame_mean_pool=pool, n_frames=3))


def test_templates_and_metadata(tmp_path, monkeypatch):
    for name in ("SOUND_CLS_TEMPLATE", "SOUND_AS_IMAGE_TEMPLATE",
                 "SCENE_CLS_TEMPLATE", "TACTILE_MATERIAL_TEMPLATE",
                 "TACTILE_PROPERTY_TEMPLATE", "EEG_TEMPLATE"):
        for c in ("Dog", "a kitchen"):
            assert PMD.expand_templates(getattr(PMD, name), c) == \
                JMD.expand_templates(getattr(JMD, name), c)
    assert PMD.expand_templates(["x {}.", "{} y"], "z") == ["x z.", "z y"]
    for sub in ("modal_3d", "modal_audio", "modal_depth", "modal_eeg"):
        (tmp_path / sub / "data").mkdir(parents=True)
    d = tmp_path
    (d / "modal_3d/data/templates.json").write_text(json.dumps({"modelnet40_64": ["a {}."]}))
    (d / "modal_3d/data/labels.json").write_text(json.dumps({"modelnet40": ["chair"]}))
    (d / "modal_audio/data/esc50_label.json").write_text(json.dumps({"0": ["dog"]}))
    (d / "modal_audio/data/audioset_class_labels_indices.csv").write_text(
        "index,mid,display_name\n0,/m/0,Speech\n1,/m/1,\"Music, loud\"\n")
    (d / "modal_audio/data/vggsound_stat.csv").write_text("a,1\n\nb c,2\n")
    (d / "modal_depth/data/nyu-depth-v2_scene_name.json").write_text(json.dumps(["office"]))
    (d / "modal_eeg/data/imagenet_cls_mapping.json").write_text(json.dumps({"n1": ["fish"]}))
    im = d / "imagenet.json"
    im.write_text(json.dumps({"templates": ["a photo of {}."], "classnames": ["ant"]}))
    monkeypatch.setenv("VITLENS_METADATA_DIR", str(d))
    monkeypatch.setenv("VITLENS_IMAGENET_METADATA", str(im))
    for fn in ("load_pc_templates", "load_pc_labels", "load_esc50_labels",
               "load_audioset_classes", "load_vggsound_classes",
               "load_scene_names", "load_imagenet_cls_mapping",
               "load_openai_imagenet_metadata"):
        assert getattr(PMD, fn)() == getattr(JMD, fn)(), fn
    py = d / "zs.py"
    py.write_text("OPENAI_IMAGENET_TEMPLATES = ['{}!']\nIMAGENET_CLASSNAMES = ['bee']\n")
    monkeypatch.setenv("VITLENS_IMAGENET_METADATA", str(py))
    assert PMD.load_openai_imagenet_metadata() == (["{}!"], ["bee"])
    monkeypatch.delenv("VITLENS_METADATA_DIR")
    monkeypatch.delenv("VITLENS_IMAGENET_METADATA")
    with pytest.raises(FileNotFoundError, match="VITLENS_METADATA_DIR"):
        PMD.metadata_dir("audio")
    with pytest.raises(FileNotFoundError, match="VITLENS_IMAGENET_METADATA"):
        PMD.load_openai_imagenet_metadata()


def test_merge_across_processes_raises(monkeypatch):
    """One process: the merge is the identity; more than one: not yet
    ported (ROADMAP Queue 1, item 12)."""
    a = np.arange(3)
    assert PM._dist_concat(a) is a
    monkeypatch.setattr(PM, "_n_processes", lambda: 2)
    with pytest.raises(NotImplementedError, match="item 12"):
        PM._dist_concat(a)
    acc = PM.Accuracy()
    acc.compute([0], np.ones((1, 2)), [0])
    with pytest.raises(NotImplementedError, match="item 12"):
        acc.merge_results()
    assert PM.Accuracy(distributed=False).merge_results()["score_cnt"] == 0
