"""``python -m vitlens_tpu_torch.cli.train_openshape`` on the CPU at the
``--tiny`` tower: one epoch from fixture triplet files with eval, a resumed
second epoch (the checkpoint's weights and epoch, a fresh optimizer whose
schedule count restarts at 0), an eval-only run from the last checkpoint,
a baseline run (``--pc-model PointNet``), and the flags that raise:
``--use-mask`` with ``--negative-sample-num 2``, a missing ``--resume``
path, and no ``--device`` on a machine without a card (more than one
device trains over ranks: test_torch_parallel_cli.py). The modules the CLI drives are held against the JAX package in
test_torch_openshape.py and test_torch_pc_baselines.py."""

import json
import os

import numpy as np
import pytest
import torch

from vitlens_tpu_torch.cli import train_openshape as PCLI
from vitlens_tpu_torch.train import checkpoint as C
from tests.test_torch_threads import share_cores

share_cores()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """8 train and 6 eval triplet blobs (some without rgb), per-class text
    embeddings for 3 classes and the eval labels."""
    root = tmp_path_factory.mktemp("openshape")
    rng = np.random.RandomState(0)
    for split, n in (("train", 8), ("eval", 6)):
        os.makedirs(root / split)
        for i in range(n):
            blob = {"xyz": rng.randn(80, 3).astype(np.float32),
                    "text_feat": rng.randn(1, 1280).astype(np.float32),
                    "img_feat": rng.randn(1280).astype(np.float32)}
            if i % 2:
                blob["rgb"] = rng.rand(80, 3).astype(np.float32)
            np.save(root / split / f"o{i}.npy", blob)
    np.save(root / "feats.npy", rng.randn(3, 1280).astype(np.float32))
    np.save(root / "labels.npy", np.arange(6) % 3)
    return root


def _argv(files, logs, *more):
    return ["--tiny", "--device", "cpu", "--npoints", "64", "--batch-size",
            "4", "--warmup", "1", "--log-every-n-steps", "1", "--logs",
            str(logs), "--name", "run", "--precision", "fp32", *more]


def _eval(files):
    return ["--eval-feats", str(files / "feats.npy"), "--eval-labels",
            str(files / "labels.npy"), "--eval-files", str(files / "eval/*.npy")]


def _records(logs):
    with open(logs / "run" / "results.jsonl") as f:
        return [json.loads(line) for line in f]


def test_train_resume_and_eval_only(files, tmp_path, monkeypatch):
    logs = tmp_path / "logs"
    train = ["--train-files", str(files / "train/*.npy")]
    assert PCLI.main(_argv(files, logs, *train, "--epochs", "1",
                           *_eval(files))) == 0
    ckpt = logs / "run" / "checkpoints"
    assert sorted(os.listdir(ckpt)) == ["epoch_1", "epoch_latest"]
    assert C.load_meta(str(ckpt / "epoch_1"))["epoch"] == 1
    saved = torch.load(ckpt / "epoch_1" / C.TREE_FILE, weights_only=True)
    assert sorted(saved) == ["params", "state"]  # no optimizer state
    recs = _records(logs)
    assert [r["step"] for r in recs if "train/loss" in r] == [1, 2]
    val = [r for r in recs if "val/top1" in r]
    assert len(val) == 1 and {"val/top3", "val/top5", "val/class_top1"} <= set(val[0])
    assert all(np.isfinite(r["train/loss"]) for r in recs if "train/loss" in r)

    # the resumed run: the file's weights, epoch 1 on, a fresh optimizer
    seen = {}
    build = PCLI.build_optimizer

    def spy(args, model, total_steps, mesh=None):
        seen["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
        seen["buffers"] = {n: b.clone() for n, b in model.named_buffers()}
        tx, state, step = build(args, model, total_steps, mesh)
        seen["state"], seen["tx"] = state, tx
        return tx, state, step

    monkeypatch.setattr(PCLI, "build_optimizer", spy)
    assert PCLI.main(_argv(files, logs, *train, "--epochs", "2", "--resume",
                           "latest")) == 0
    for n, p in seen["params"].items():
        assert torch.equal(p, saved["params"][n]), n
    for n, b in seen["buffers"].items():
        assert torch.equal(b, saved["state"][n]), n
    assert seen["state"]["count"] == 2  # two steps since the restart
    assert seen["tx"].cfg.total_steps == 4
    assert [r["step"] for r in _records(logs) if "train/loss" in r] == [1, 2, 3, 4]
    assert sorted(os.listdir(ckpt)) == ["epoch_1", "epoch_2", "epoch_latest"]
    assert C.load_meta(str(ckpt / "epoch_latest"))["epoch"] == 2

    # eval-only from the last checkpoint
    out = tmp_path / "eval_logs"
    assert PCLI.main(_argv(files, out, "--resume", str(ckpt / "epoch_latest"),
                           *_eval(files))) == 0
    val = [r for r in _records(out) if "val/top1" in r]
    assert len(val) == 1 and 0.0 <= val[0]["val/class_top1"] <= 1.0


def test_baseline_trains_through_the_cli(files, tmp_path):
    logs = tmp_path / "logs"
    assert PCLI.main(_argv(files, logs, "--train-files",
                           str(files / "train/*.npy"), "--epochs", "1",
                           "--pc-model", "PointNet", "--pc-scaling", "1")) == 0
    saved = torch.load(logs / "run" / "checkpoints" / "epoch_1" / C.TREE_FILE,
                       weights_only=True)
    assert "encoder.head.w" in saved["params"]
    assert "encoder.lift1.0.bn.mean" in saved["state"]


def test_flags_that_raise(files, tmp_path, monkeypatch):
    train = ["--train-files", str(files / "train/*.npy"), "--epochs", "1"]
    with pytest.raises(NotImplementedError, match="negative-sample-num"):
        PCLI.main(_argv(files, tmp_path, *train, "--use-mask",
                        "--negative-sample-num", "2"))
    # several devices no longer raise: one process a card trains over
    # them (tests/test_torch_parallel_cli.py runs two ranks)
    PCLI.check_supported(PCLI.build_args([]))
    PCLI.check_supported(PCLI.build_args(["--use-mask"]))
    with pytest.raises(FileNotFoundError):
        PCLI.main(_argv(files, tmp_path, *train, "--resume",
                        str(tmp_path / "missing")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PCLI.main(["--tiny", *train])
