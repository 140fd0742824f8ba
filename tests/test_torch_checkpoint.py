"""The port's checkpoints (vitlens_tpu_torch/train/checkpoint.py, the
ViTLens export) against the JAX package's train/checkpoint.py: the same
directory policy step by step on the same sequence of saves (names,
meta.json, best.json, the latest.json pointer against epoch_latest by
mtime); a TrainState round trip bit for bit, with and without ckpt_only;
AsyncSaver's ordering and its re-raise of a failed save; and
ViTLens.export_checkpoint / load_checkpoint."""

import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitlens_tpu.train import checkpoint as JC
from vitlens_tpu_torch import api
from vitlens_tpu_torch.train import checkpoint as PC


def _jstate(v):
    return {"params": {"w": jnp.full((4, 4), float(v)), "b": jnp.zeros(4)},
            "step": jnp.asarray(v, jnp.int32)}


def _pstate(v):
    return {"params": {"w": torch.full((4, 4), float(v)), "b": torch.zeros(4)},
            "step": torch.tensor(v, dtype=torch.int32)}


def _tree(root):
    """{name: (meta.json, has content)} of a checkpoint root, and best.json."""
    out = {}
    for name in sorted(os.listdir(root)):
        p = os.path.join(root, name)
        if os.path.isdir(p):
            meta = os.path.join(p, "meta.json")
            out[name] = json.load(open(meta)) if os.path.exists(meta) else None
        else:
            out[name] = json.load(open(p))
    return out


def _both(j_root, p_root, op, *args, **kw):
    """Run one op of the policy on both roots; the same names and json."""
    j = getattr(JC, op)(j_root, *[_jstate(a) if i == 0 and isinstance(a, int)
                                  else a for i, a in enumerate(args)], **kw)
    p = getattr(PC, op)(p_root, *[_pstate(a) if i == 0 and isinstance(a, int)
                                  else a for i, a in enumerate(args)], **kw)
    assert (j is None) == (p is None)
    if j is not None:
        assert os.path.relpath(j, j_root) == os.path.relpath(p, p_root)
    assert _tree(p_root) == _tree(j_root)


def test_directory_policy_matches_jax(tmp_path):
    j, p = str(tmp_path / "j"), str(tmp_path / "p")
    _both(j, p, "save_checkpoint", 1, 1)
    _both(j, p, "save_best", 1, 1, 0.5)
    _both(j, p, "save_checkpoint", 2, 2, extra={"note": "x"})
    _both(j, p, "save_best", 2, 2, 0.4)   # no improvement
    _both(j, p, "save_best", 3, 3, 0.9)
    _both(j, p, "save_checkpoint", 3, 3, is_latest=False, best_metric=0.9)
    _both(j, p, "save_checkpoint", 4, 3, tag="preempt_step_40",
          extra={"preempt_step": 40})
    for root, C in ((j, JC), (p, PC)):
        latest = C.get_latest_checkpoint(root)
        assert os.path.basename(latest) == "epoch_latest"
        assert C.load_meta(latest) == {"epoch": 3, "extra": {"preempt_step": 40}}
        assert C.load_meta(os.path.join(root, "nosuch")) == {}
    restored = PC.load_checkpoint(os.path.join(p, "checkpoint_best"), _pstate(0))
    assert float(restored["params"]["w"][0, 0]) == 3.0
    assert int(restored["step"]) == 3 and restored["step"].dtype == torch.int32


def test_latest_pointer_against_epoch_latest_by_mtime(tmp_path):
    """A latest.json pointer (written by the collective savers) and an
    epoch_latest copy: the one written last wins; with neither, the highest
    epoch_N."""
    picks = {}
    for name, C, st in (("j", JC, _jstate), ("p", PC, _pstate)):
        root = str(tmp_path / name)
        C.save_checkpoint(root, st(3), 3, is_latest=False)
        C.save_checkpoint(root, st(12), 12, is_latest=False)
        got = [os.path.basename(C.get_latest_checkpoint(root))]
        C.save_checkpoint(root, st(5), 5)
        with open(os.path.join(root, "latest.json"), "w") as f:
            json.dump({"tag": "epoch_3"}, f)
        now = time.time()
        os.utime(os.path.join(root, "epoch_latest"), (now - 100, now - 100))
        os.utime(os.path.join(root, "latest.json"), (now, now))
        got.append(os.path.basename(C.get_latest_checkpoint(root)))
        os.utime(os.path.join(root, "latest.json"), (now - 200, now - 200))
        got.append(os.path.basename(C.get_latest_checkpoint(root)))
        assert C.get_latest_checkpoint(str(tmp_path / "empty")) is None
        picks[name] = got
    assert picks["p"] == picks["j"] == ["epoch_12", "epoch_3", "epoch_latest"]


def _train_state(seed, steps):
    """A tiny audio TriModel (the test_torch_train.py config) trained
    ``steps`` steps with the published audio recipe's lock flags."""
    from test_torch_train import _batch, _tiny

    from vitlens_tpu_torch import config as PCfg
    from vitlens_tpu_torch.factory import make_generator, make_trainable_
    from vitlens_tpu_torch.models.tri import TriModel
    from vitlens_tpu_torch.train import step as PStep
    from vitlens_tpu_torch.train.freeze import tri_model_mask

    cfg = _tiny(PCfg)
    model = TriModel(cfg, device="cpu")
    model.init_(make_generator(seed, "cpu"))
    mask = tri_model_mask(model, cfg, lock_visual=True, lock_text=True,
                          unlock_cls=True)
    tx, mask = PStep.make_optimizer(model, PStep.OptimizerConfig(
        lr=1e-2, warmup=1, total_steps=10), mask)
    make_trainable_(model, mask, torch.bfloat16)
    ts = PStep.init_train_state(model, tx)
    step = PStep.make_train_step(cfg, tx, mask, PStep.StepConfig(
        n_tower=2, align_to="text", compute_dtype=torch.float32))
    for i in range(steps):
        ts, _ = step(ts, _batch(4, i))
    return ts


def _equal_states(a, b, opt=True):
    for (n, x), (_, y) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert x.dtype == y.dtype and torch.equal(x, y), n
    if opt:
        assert a.step == b.step and a.opt_state["count"] == b.opt_state["count"]
        for m in ("mu", "nu"):
            for n, x in a.opt_state[m].items():
                assert torch.equal(x, b.opt_state[m][n]), (m, n)


def test_train_state_round_trip(tmp_path):
    ts = _train_state(0, 2)
    root = str(tmp_path / "ck")
    PC.save_checkpoint(root, ts, 1)
    fresh = _train_state(1, 0)
    assert PC.load_checkpoint(PC.get_latest_checkpoint(root), fresh) is fresh
    _equal_states(fresh, ts)
    assert fresh.step == 2 and fresh.opt_state["count"] == 2
    # ckpt_only: the weights, not the optimizer state or the step
    only = _train_state(2, 0)
    PC.load_checkpoint(os.path.join(root, "epoch_1"), only, ckpt_only=True)
    _equal_states(only, ts, opt=False)
    assert only.step == 0 and only.opt_state["count"] == 0
    assert all(float(v.abs().sum()) == 0 for v in only.opt_state["mu"].values())
    # a snapshot is decoupled from the live state, which the next step moves
    snap = PC.snapshot(ts)
    w = next(n for n, p in ts.model.named_parameters() if p.requires_grad)
    with torch.no_grad():
        dict(ts.model.named_parameters())[w].add_(1.0)
    assert not torch.equal(snap["params"][w], dict(ts.model.named_parameters())[w])
    PC.save_checkpoint(root, snap, 2)
    again = _train_state(3, 0)
    PC.load_checkpoint(os.path.join(root, "epoch_2"), again)
    assert torch.equal(dict(again.model.named_parameters())[w], snap["params"][w])


def test_load_reports_a_missing_leaf(tmp_path):
    root = str(tmp_path / "ck")
    PC.save_checkpoint(root, {"a": torch.ones(2)}, 1)
    with pytest.raises(KeyError, match="missing leaf"):
        PC.load_checkpoint(os.path.join(root, "epoch_1"),
                           {"a": torch.ones(2), "b": torch.ones(2)})


def test_async_saver_orders_and_reraises(tmp_path):
    saver = PC.AsyncSaver()
    order = []
    for i in range(5):
        saver.submit(lambda i=i: (time.sleep(0.01 * (5 - i)), order.append(i)))
    saver.wait()
    assert order == list(range(5))

    def boom():
        raise OSError("disk full")

    saver.submit(boom)
    with pytest.raises(OSError, match="disk full"):
        saver.close()
    saver2 = PC.AsyncSaver()
    saver2.submit(boom)
    saver2._q.join()
    with pytest.raises(OSError, match="disk full"):
        saver2.submit(lambda: None)
    saver2.close()


def test_sharded_savers_raise():
    for fn in (PC.save_checkpoint_sharded, PC.save_best_sharded,
               PC.load_checkpoint_sharded):
        with pytest.raises(NotImplementedError, match="item 12"):
            fn("x", None, 1)


def test_remote_sync_mirrors(tmp_path):
    pytest.importorskip("fsspec")
    local, remote = tmp_path / "l", tmp_path / "r"
    PC.save_checkpoint(str(local), {"a": torch.ones(2)}, 1)
    stop = PC.start_remote_sync(str(local), str(remote), frequency_s=0.05)
    time.sleep(0.3)
    stop.set()
    time.sleep(0.3)
    assert (remote / "epoch_1" / "meta.json").exists()
    assert not (remote / "epoch_latest").exists()


def test_vitlens_export_and_load_round_trip(tmp_path, monkeypatch):
    """A ViTLens (tiny trunk; the pc tower brings BatchNorm buffers) exports
    its towers and vitlens_meta.json; a ViTLens of another seed loads it and
    encodes the same."""
    monkeypatch.setitem(api._TRUNKS, "vitlensL", "ViT-Tiny-Test")
    a = api.ViTLens("vitlensL", ("pc", "audio", "text"), device="cpu", seed=0)
    with torch.no_grad():
        for bn in a.towers["pc"].modules():
            if hasattr(bn, "mean") and isinstance(bn.mean, torch.Tensor):
                bn.mean.add_(0.5)
    path = a.export_checkpoint(str(tmp_path / "export"))
    meta = json.load(open(os.path.join(path, "vitlens_meta.json")))
    assert meta == {"model_var": "vitlensL", "modalities": ["pc", "audio", "text"]}
    b = api.ViTLens("vitlensL", ("pc", "audio", "text"), device="cpu", seed=1)
    rng = np.random.RandomState(0)
    x = {"pc": rng.randn(2, 8192, 3).astype(np.float32),
         "audio": rng.randn(2, 512, 128).astype(np.float32),
         "text": np.tile(np.array([[49406, 320, 49407] + [0] * 74]), (2, 1))}
    before = b.encode(x, preprocessed=True)
    b.load_checkpoint(path)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    for (n, p), (_, q) in zip(a.named_buffers(), b.named_buffers()):
        assert torch.equal(p, q), n
    want, got = a.encode(x, preprocessed=True), b.encode(x, preprocessed=True)
    for m in x:
        assert torch.equal(got[m], want[m]), m
        assert not torch.equal(before[m], want[m]), m
