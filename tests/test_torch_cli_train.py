"""The port's trainer, ``python -m vitlens_tpu_torch.cli.train``, end to end
on the CPU at ``--model ViT-Tiny-Test --precision fp32 --device cpu``,
against the JAX package's ``vitlens_tpu.cli.train.main`` on the same
reference-layout --pretrained file (tools/reference_layout.py) and data:

  * the synthetic audio recipe: per-step loss and grad_norm within 1e-4
    relative, the trainable tensors after 2 steps within 2 * lr absolute
    (Adam turns gradient differences far below eps into lr-sized moves);
  * an audio run from WAV and FLAC files with ESC50 val: the same
    checkpoint names, meta.json and best.json, and results.jsonl keys;
  * --visual-stat-flops: JAX's params_M, and FLOPs within the recorded
    gap (the port counts products only, XLA the elementwise work too);
  * the same flags and validation (TrainArgs), plus --device;
  * the CLI raises without a CUDA device unless --device cpu, and on the
    flags whose work is not yet ported, naming their ROADMAP item.

The port's own runs (resume, preemption, remat, patch dropout, the CSV and
pc recipes, traces, eval-only) are in test_torch_cli_runs.py."""

import json
import os

import numpy as np
import pytest
import torch

import jax

from tools import reference_layout as RL
from vitlens_tpu_torch import config as PC
from tests.test_torch_threads import share_cores

share_cores()

LR = 5e-4


@pytest.fixture(autouse=True)
def _one_cpu_device(monkeypatch):
    monkeypatch.setattr(jax, "devices",
                        lambda *a, **k: jax.local_devices(backend="cpu")[:1])


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """A TriCLIP file of the tiny trunk with the audio Lens: every
    parameter of the tri model, so both sides start from the same weights."""
    pcfg = PC.make_model_config("ViT-Tiny-Test", "audio")
    g = torch.Generator().manual_seed(5)
    sd = {"visual." + k: v for k, v in RL.vision_tower_state_dict(pcfg.tower, g).items()}
    sd.update({"image." + k: v for k, v in RL.vision_tower_state_dict(
        PC.image_tower_config(pcfg), g).items()})
    sd.update(RL.text_tower_state_dict(pcfg.text, pcfg.embed_dim, g))
    sd["logit_scale"] = torch.tensor(2.5)
    path = str(tmp_path_factory.mktemp("pre") / "tri.pt")
    torch.save(sd, path)
    return path


def _common(pretrained, logs, *extra):
    return ["--modality", "audio", "--model", "ViT-Tiny-Test",
            "--pretrained", pretrained, "--precision", "fp32",
            "--n-tower", "2", "--align-to", "text", "--unlock-cls",
            "--batch-size", "2", "--warmup", "1", "--lr", str(LR),
            "--log-every-n-steps", "1", "--workers", "1",
            "--logs", str(logs), *extra]


SYNTH = ("--dataset-type", "synthetic", "--train-data", "synthetic",
         "--train-num-samples", "4", "--epochs", "1")


def _records(run_dir):
    return [json.loads(l) for l in open(os.path.join(run_dir, "results.jsonl"))]


def _port(argv):
    from vitlens_tpu_torch.cli.train import main

    return main(argv)


def _jax(argv):
    from vitlens_tpu.cli.train import main

    return main(argv)


def _trainable_after(run_dir, jax_side):
    """{name: tensor} of the epoch_1 checkpoint's trainable parameters
    (the Lens and adapter, CLS and the logit scale), in the port's names."""
    from vitlens_tpu_torch.models.tri import TriModel
    from vitlens_tpu_torch.weights.from_jax import load_tri_params

    path = os.path.join(run_dir, "checkpoints", "epoch_1")
    if jax_side:
        import orbax.checkpoint as ocp

        raw = ocp.PyTreeCheckpointer().restore(os.path.abspath(path))
        model = load_tri_params(TriModel(PC.make_model_config(
            "ViT-Tiny-Test", "audio"), device="cpu"), raw["params"])
        params = dict(model.named_parameters())
    else:
        params = torch.load(os.path.join(path, "tree.pt"),
                            weights_only=True)["params"]
    return {n: t for n, t in params.items()
            if n.startswith(("visual.perceiver", "visual.adapter"))
            or n in ("visual.class_embedding", "logit_scale")}


def test_synthetic_steps_match_jax(tmp_path, pretrained):
    assert _jax(_common(pretrained, tmp_path, *SYNTH, "--name", "j")) == 0
    assert _port(_common(pretrained, tmp_path, *SYNTH, "--name", "p",
                         "--device", "cpu")) == 0
    jr, pr = _records(tmp_path / "j"), _records(tmp_path / "p")
    assert [r["step"] for r in pr] == [r["step"] for r in jr] == [1, 2]
    for a, b in zip(pr, jr):
        for k in ("train/loss", "train/grad_norm", "train/logit_scale"):
            assert abs(a[k] / b[k] - 1) <= 1e-4, (k, a[k], b[k])
    want = _trainable_after(tmp_path / "j", True)
    got = _trainable_after(tmp_path / "p", False)
    assert want.keys() == got.keys() and len(got) > 4
    for n, w in want.items():
        assert float((got[n].float() - w.float()).abs().max()) <= 2 * LR, n


def _audio_files(root, n=4):
    """AudioSet-style train clips (every other one FLAC) and an ESC50 fold."""
    from tools.reference_layout import pcm_from_float, write_flac, write_wav

    meta = root / "meta" / "modal_audio" / "data"
    meta.mkdir(parents=True)
    (root / "audio").mkdir()
    paths = []
    for i in range(n):
        t = np.arange(16000 * (5 + i)) / 16000.0
        pcm = pcm_from_float(0.3 * np.sin(2 * np.pi * (250 + 120 * i) * t), 16)
        name = f"audio/c{i}.flac" if i % 2 else f"audio/c{i}.wav"
        (write_flac(str(root / name), pcm, 16000) if i % 2
         else write_wav(str(root / name), pcm[None], 16000))
        paths.append(name)
    (meta / "audioset_train.json").write_text(json.dumps(
        [{"uniq_id": i, "audio_path": p, "labels": [i % 3]}
         for i, p in enumerate(paths)]))
    (meta / "audioset_class_labels_indices.csv").write_text(
        "index,mid,display_name\n0,/m/0,Dog\n1,/m/1,Rain\n2,/m/2,Car horn\n")
    (meta / "esc50_fold-1.json").write_text(json.dumps(
        [{"uniq_id": i, "audio_path": p, "text": "x", "class_label": i % 2}
         for i, p in enumerate(paths)]))
    (meta / "esc50_label.json").write_text(json.dumps(
        {"0": ["dog"], "1": ["rain"]}))


def _tree(ckpt_dir):
    out = {}
    for name in sorted(os.listdir(ckpt_dir)):
        p = os.path.join(ckpt_dir, name)
        meta = os.path.join(p, "meta.json")
        out[name] = (json.load(open(meta)) if os.path.exists(meta) else
                     sorted(json.load(open(p))) if name.endswith(".json") else None)
    return out


def test_audio_files_run_writes_jax_tree(tmp_path, pretrained, monkeypatch):
    _audio_files(tmp_path)
    monkeypatch.setenv("VITLENS_AUDIO_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("VITLENS_METADATA_DIR", str(tmp_path / "meta"))
    run = ("--train-data", "audioset@train", "--val-data", "esc50@fold-1",
           "--epochs", "1")
    assert _jax(_common(pretrained, tmp_path / "logs", *run, "--name", "j")) == 0
    assert _port(_common(pretrained, tmp_path / "logs", *run, "--name", "p",
                         "--device", "cpu")) == 0
    j, p = tmp_path / "logs" / "j", tmp_path / "logs" / "p"
    assert _tree(p / "checkpoints") == _tree(j / "checkpoints")
    assert set(_tree(p / "checkpoints")) == {"best.json", "checkpoint_best",
                                             "epoch_1", "epoch_latest"}
    assert [sorted(r) for r in _records(p)] == [sorted(r) for r in _records(j)]
    val = _records(p)[-1]
    assert "val/esc50@fold-1/accuracy" in val and "val/primary" in val
    assert all(np.isfinite(r["train/loss"]) for r in _records(p)[:-1])
    assert sorted(os.listdir(p)) == sorted(os.listdir(j))


# --visual-stat-flops at ViT-Tiny-Test: JAX's count (XLA cost analysis, the
# elementwise work included) over the port's (FlopCounterMode, products
# only), recorded on the CPU: 46943024 / 45638144 for the audio tower,
# 19961616 / 19288576 for EEG (the rest of the gap: 1.0106 for pc, 1.1679 for
# depth, whose tiny tower has the fewest products per element).
FLOPS_RATIO = {"audio": 46943024 / 45638144, "eeg": 19961616 / 19288576}


@pytest.mark.parametrize("modality", ["audio", "eeg"])
def test_visual_stat_flops(tmp_path, modality, capsys):
    from vitlens_tpu.config import make_model_config as jcfg_of
    from vitlens_tpu.models import tri as JT
    from vitlens_tpu.utils.flops import model_flops_report as jflops
    from vitlens_tpu_torch.factory import create_model
    from vitlens_tpu_torch.utils.flops import model_flops_report as pflops

    assert _port(["--modality", modality, "--model", "ViT-Tiny-Test",
                  "--visual-stat-flops", "--precision", "fp32", "--logs",
                  str(tmp_path), "--name", "p", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # JAX's CLI prints round(params_total / 1e6, 2) of the same report
    jc = jcfg_of("ViT-Tiny-Test", modality)
    params, state = JT.tri_model_init(jax.random.PRNGKey(0), jc)
    from vitlens_tpu_torch.cli.args import TrainArgs
    from vitlens_tpu_torch.cli.train import _synthetic_spec

    shape = _synthetic_spec(TrainArgs(modality=modality), jc)["visual"][0]
    jr = jflops(jc, jax.numpy.zeros((1,) + shape), params, state)
    pr = pflops(create_model("ViT-Tiny-Test", modality, device="cpu"),
                torch.zeros((1,) + shape))
    assert pr["params_total"] == jr["params_total"]
    assert got["params_M"] == round(jr["params_total"] / 1e6, 2) > 0
    assert got["gflops_per_sample"] == round(pr["gflops_per_sample"], 2) > 0
    assert jr["flops"] / pr["flops"] == pytest.approx(FLOPS_RATIO[modality],
                                                      abs=1e-6)


def test_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _port(["--modality", "audio", "--model", "ViT-Tiny-Test",
               "--visual-stat-flops", "--logs", str(tmp_path)])


@pytest.mark.parametrize("flags,item", [
    # FSDP is ported: one process runs the one-device step and eval, as in
    # JAX (two ranks: tests/test_torch_fsdp.py)
    pytest.param(["--fsdp"], None, id="flags0-item 12"),
    # tensor parallelism is ported: --tp must divide the ranks (JAX's
    # SystemExit; four ranks: tests/test_torch_tp.py)
    pytest.param(["--tp", "2"], r"--tp 2 does not divide 1 rank",
                 id="flags1-item 12"),
    # data parallelism is ported: --n-devices must be the number of ranks,
    # and one process is one rank
    pytest.param(["--n-devices", "2"], r"--n-devices 2 but the run has 1 rank",
                 id="flags2-item 12"),
    # item 11's flags are ported: LoRA builds, and a pretrained tag resolves
    # through the hub's cache (an unknown one raises the hub's KeyError)
    pytest.param(["--lora-rank", "4", "--visual-stat-flops"], None,
                 id="flags3-item 11"),
    pytest.param(["--pretrained", "openai"], "unknown pretrained tag",
                 id="flags4-item 11")])
def test_unported_flags_raise(tmp_path, flags, item):
    argv = ["--modality", "audio", "--model", "ViT-Tiny-Test", "--device",
            "cpu", "--logs", str(tmp_path), *flags]
    if item is None:
        assert _port(argv) == 0
        return
    with pytest.raises((NotImplementedError, KeyError, ValueError, SystemExit),
                       match=item):
        _port(argv)


def test_args_match_jax():
    """The same TrainArgs fields and defaults as JAX's, plus --device, and
    the same validation of --remat-policy."""
    import dataclasses

    from vitlens_tpu.cli import args as JA
    from vitlens_tpu_torch.cli import args as PA

    jf = {f.name: f.default for f in dataclasses.fields(JA.TrainArgs)
          if f.name != "aug_cfg"}
    pf = {f.name: f.default for f in dataclasses.fields(PA.TrainArgs)
          if f.name != "aug_cfg"}
    assert set(pf) - set(jf) == {"device"}
    assert {k: v for k, v in pf.items() if k != "device"} == jf
    argv = ["--modality", "pc", "--no-lock-text", "--aug-cfg", "re_prob=0.25",
            "use_timm=True", "--pc-npoints", "1024", "--audio-noise-aug", "false"]
    assert dataclasses.asdict(PA.parse_args(argv + ["--device", "cpu"])) == dict(
        dataclasses.asdict(JA.parse_args(argv)), device="cpu")
    with pytest.raises(SystemExit):
        PA.parse_args(["--remat-policy", "everything"])
