"""The port's trainer, ``python -m vitlens_tpu_torch.cli.train``, on the CPU
at ``--model ViT-Tiny-Test --device cpu``: --resume latest and a SIGTERM
preemption continue the run (and main() restores the SIGTERM handler); the
"dots" remat trains as without remat and --force-patch-dropout drops
patches; the CSV CLIP and pc tri recipes; --profile-steps writes a trace;
eval-only mode writes its val metrics. The runs held against JAX's CLI are
in test_torch_cli_train.py, whose helpers and --pretrained file these use."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

from test_torch_cli_train import (SYNTH, _audio_files, _common, _port,
                                  _records)
from test_torch_cli_train import pretrained  # noqa: F401 - the fixture
from tests.test_torch_threads import child_env, share_cores

share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _losses(run_dir):
    return [r["train/loss"] for r in _records(run_dir)]


def test_resume_latest_continues(tmp_path, pretrained):
    argv = _common(pretrained, tmp_path, "--dataset-type", "synthetic",
                   "--train-data", "synthetic", "--train-num-samples", "4",
                   "--name", "r", "--device", "cpu")
    handler = signal.getsignal(signal.SIGTERM)
    assert _port(argv + ["--epochs", "1"]) == 0
    assert signal.getsignal(signal.SIGTERM) is handler  # main() restores it
    assert _port(argv + ["--epochs", "2", "--resume", "latest"]) == 0
    assert [r["step"] for r in _records(tmp_path / "r")] == [1, 2, 3, 4]
    assert [r["train/epoch"] for r in _records(tmp_path / "r")] == [0, 0, 1, 1]
    log = open(tmp_path / "r" / "out.log").read()
    assert "resumed from" in log and "(epoch 1)" in log
    meta = json.load(open(tmp_path / "r" / "checkpoints" / "epoch_latest" / "meta.json"))
    assert meta["epoch"] == 2


def test_sigterm_preemption_and_resume(tmp_path, pretrained):
    """SIGTERM mid-train: a preempt_step_N checkpoint mirrored to
    epoch_latest, exit 0, and --resume latest continues the epoch."""
    env = child_env(1, {"PYTHONPATH": REPO})
    cmd = [sys.executable, "-m", "vitlens_tpu_torch.cli.train",
           *_common(pretrained, tmp_path, "--dataset-type", "synthetic",
                    "--train-data", "synthetic", "--train-num-samples", "8",
                    "--name", "pre", "--device", "cpu")]
    run = tmp_path / "pre"
    with open(tmp_path / "err.txt", "w") as err:
        p = subprocess.Popen(cmd + ["--epochs", "500"], env=env, cwd=REPO,
                             stdout=subprocess.DEVNULL, stderr=err)
        try:
            deadline = time.time() + 120
            while time.time() < deadline and p.poll() is None:
                if (run / "results.jsonl").exists():
                    break
                time.sleep(0.2)
            assert p.poll() is None, (tmp_path / "err.txt").read_text()[-2000:]
            p.send_signal(signal.SIGTERM)
            p.wait(timeout=120)
        finally:
            if p.poll() is None:
                p.kill()
    assert p.returncode == 0, (tmp_path / "err.txt").read_text()[-2000:]
    assert "SIGTERM: checkpointing at step" in (run / "out.log").read_text()
    ckpts = run / "checkpoints"
    pre = [d for d in os.listdir(ckpts) if d.startswith("preempt_step_")]
    assert len(pre) == 1
    from vitlens_tpu_torch.train import checkpoint as C

    meta = C.load_meta(C.get_latest_checkpoint(str(ckpts)))
    step = meta["extra"]["preempt_step"]
    assert pre == [f"preempt_step_{step}"] and step >= 1
    r = subprocess.run(cmd + ["--epochs", str(meta["epoch"] + 1),
                              "--resume", "latest"],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "resumed from" in (run / "out.log").read_text()
    assert _records(run)[-1]["step"] > step


def test_remat_and_patch_dropout_flags(tmp_path, pretrained):
    base = _common(pretrained, tmp_path, *SYNTH, "--device", "cpu")
    assert _port(base + ["--name", "plain"]) == 0
    for policy in ("dots",):
        assert _port(base + ["--name", policy, "--grad-checkpointing",
                             "--remat-policy", policy]) == 0
        np.testing.assert_allclose(_losses(tmp_path / policy),
                                   _losses(tmp_path / "plain"), rtol=1e-6)
    assert _port(base + ["--name", "pd", "--force-patch-dropout", "0.5"]) == 0
    assert _losses(tmp_path / "pd") != _losses(tmp_path / "plain")
    assert "force_patch_dropout: 0.5" in open(tmp_path / "pd" / "params.txt").read()


def test_csv_clip_recipe(tmp_path):
    """Classic two-tower CLIP training from a tsv of (filepath, caption)
    pairs, with the in-training retrieval-rank validation (JAX's keys)."""
    from PIL import Image

    rows = ["filepath\ttitle"]
    for i in range(8):
        p = tmp_path / f"{i}.jpg"
        Image.fromarray((np.random.RandomState(i).rand(40, 40, 3) * 255
                         ).astype(np.uint8)).save(p)
        rows.append(f"{p}\ta photo number {i}")
    data = tmp_path / "data.tsv"
    data.write_text("\n".join(rows) + "\n")
    assert _port(["--modality", "image", "--model", "ViT-Tiny-Test",
                  "--force-image-size", "28", "--dataset-type", "csv",
                  "--train-data", str(data), "--val-data", str(data),
                  "--batch-size", "4", "--epochs", "1", "--warmup", "1",
                  "--precision", "fp32", "--n-tower", "2", "--align-to", "clip",
                  "--no-lock-image", "--no-lock-text", "--log-every-n-steps",
                  "1", "--logs", str(tmp_path / "logs"), "--name", "csv",
                  "--device", "cpu"]) == 0
    rec = _records(tmp_path / "logs" / "csv")[-1]
    assert np.isfinite(rec["val/data.tsv/clip_val_loss"])
    assert rec["val/primary"] == rec["val/data.tsv/image_to_text_R@1"]


def test_pc_tri_recipe_draws_fps_starts(tmp_path):
    """The pc tri recipe from the synthetic set: the step draws its FPS
    starts from the trainer's generator, seeded with --seed, so the same
    seed gives the same losses (and another seed, other weights and data,
    other ones)."""
    def run(name, seed):
        assert _port(["--modality", "pc", "--model", "ViT-Tiny-Test",
                      "--dataset-type", "synthetic", "--train-data",
                      "synthetic", "--train-num-samples", "4", "--batch-size",
                      "2", "--epochs", "1", "--warmup", "1", "--precision",
                      "fp32", "--n-tower", "3", "--log-every-n-steps", "1",
                      "--pc-npoints", "512", "--pc-num-group", "16",
                      "--pc-group-size", "8",
                      "--seed", str(seed), "--logs", str(tmp_path), "--name",
                      name, "--device", "cpu"]) == 0
        return _losses(tmp_path / name)

    a, b = run("a", 0), run("b", 0)
    assert a == b and all(np.isfinite(a))
    assert run("c", 1) != a


def test_profile_steps_writes_a_trace(tmp_path, pretrained):
    """--profile-steps N traces N steady-state steps (from the third) into
    <log_dir>/trace/trace.json, a Chrome trace."""
    argv = _common(pretrained, tmp_path, "--dataset-type", "synthetic",
                   "--train-data", "synthetic", "--train-num-samples", "8",
                   "--epochs", "1", "--device", "cpu", "--name", "prof")
    assert _port(argv + ["--profile-steps", "1"]) == 0
    trace = json.load(open(tmp_path / "prof" / "trace" / "trace.json"))
    assert trace["traceEvents"]
    assert "profiler trace written to" in open(tmp_path / "prof" / "out.log").read()


def test_eval_only_writes_val_metrics(tmp_path, pretrained, monkeypatch):
    _audio_files(tmp_path)
    monkeypatch.setenv("VITLENS_AUDIO_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("VITLENS_METADATA_DIR", str(tmp_path / "meta"))
    argv = ["--modality", "audio", "--model", "ViT-Tiny-Test", "--pretrained",
            pretrained, "--val-data", "esc50@fold-1", "--batch-size", "2",
            "--precision", "fp32", "--logs", str(tmp_path / "logs"),
            "--workers", "1"]
    assert _port(argv + ["--name", "p", "--device", "cpu"]) == 0
    rec = _records(tmp_path / "logs" / "p")
    assert len(rec) == 1 and rec[0]["step"] == 0
    assert 0.0 <= rec[0]["val/esc50@fold-1"] <= 1.0
    assert rec[0]["val/esc50@fold-1/score_cnt"] == 4
