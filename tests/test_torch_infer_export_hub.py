"""The infer CLI, the export round trip and the hub of the port on the CPU:
cli.infer's printed matrices (rows summing to 1, equal to the API's encode
put through the JAX CLI's formula); torch.export of bf16 towers (audio and
pc, cut to 2 blocks) whose graphs hold the kernels as the custom ops of
ops/custom.py, one a launch site, and whose loaded programs encode as the
eager towers do (exactly: the same plain versions run); hub resolution from
a cache dir against the JAX registry, and the trainer's --pretrained tag."""

import os
import re
import sys

import numpy as np
import pytest
import torch

from tools.reference_layout import (text_tower_state_dict,
                                    vision_tower_state_dict, write_wav)
from vitlens_tpu_torch import config as PC
from vitlens_tpu_torch.api import ViTLens
from vitlens_tpu_torch.cli import infer as CLI
from vitlens_tpu_torch.utils import export as PX
from vitlens_tpu_torch.utils import hub as PH
from tests.test_torch_threads import share_cores

share_cores()


def _jax_matrices(out, scale):
    """The JAX CLI's loop (vitlens_tpu/cli/infer.py), on the same features."""
    mods, res = list(out), {}
    for i in range(len(mods)):
        for j in range(i + 1, len(mods)):
            a, b = mods[i], mods[j]
            sim = np.asarray(out[a] @ out[b].T, np.float64) * scale
            sm = np.exp(sim - sim.max(axis=-1, keepdims=True))
            res[(a, b)] = sm / sm.sum(axis=-1, keepdims=True)
    return res


def _parse(stdout):
    blocks = re.split(r"\n(\w+) x (\w+) softmax\([^)]*\):\n", "\n" + stdout)
    out = {}
    for a, b, body in zip(blocks[1::3], blocks[2::3], blocks[3::3]):
        nums = [float(v) for v in re.findall(r"[-+]?\d*\.\d+(?:e[-+]?\d+)?|\d+", body)]
        out[(a, b)] = np.asarray(nums)
    return out


def test_infer_cli_prints_the_api_matrices(tmp_path, capsys):
    rng = np.random.RandomState(0)
    wavs = []
    for i in range(2):
        path = str(tmp_path / f"a{i}.wav")
        write_wav(path, (rng.randn(16000 * 2) * 3000).astype(np.int16), 16000)
        wavs.append(path)
    captions = ["a dog barking", "rain on a roof", "a car engine"]
    argv = ["--model-var", "vitlensB", "--device", "cpu", "--audio", *wavs,
            "--text", *captions, "--logit-scale", "50"]
    assert CLI.main(argv) == 0
    got = _parse(capsys.readouterr().out)
    vl = ViTLens("vitlensB", ["audio", "text"], device="cpu", seed=0)
    out = {m: v.numpy() for m, v in vl.encode({"audio": wavs, "text": captions}).items()}
    want = _jax_matrices(out, 50.0)
    assert list(got) == [("audio", "text")]
    sm = want[("audio", "text")]
    assert sm.shape == (2, 3)
    np.testing.assert_allclose(sm.sum(-1), 1.0, atol=1e-12)
    np.testing.assert_allclose(got[("audio", "text")], sm.ravel(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(CLI.similarity_matrices(out, 50.0)[("audio", "text")], sm,
                               atol=1e-12)
    # --data-parallel is ported (its matrices: test_torch_parallel_cli.py)
    assert CLI.main(["--model-var", "vitlensB", "--text", "a",
                     "--data-parallel", "2", "--device", "cpu"]) == 0
    with pytest.raises(SystemExit):
        CLI.main(["--device", "cpu"])


def _tower(m):
    vl = ViTLens("vitlensB", (m,), device="cpu", seed=0,
                 compute_dtype=torch.bfloat16)
    t = vl.towers[m]
    t.trunk.blocks = t.trunk.blocks[:2]
    return vl, t


@pytest.mark.parametrize("m", ["audio", "pc"])
def test_export_round_trip(m):
    """A bf16 tower exported, serialised, loaded and run: the program's
    graph calls the kernels' ops (fused MLP once a block, attention once a
    block and a Lens attention, FPS and the point encoder once for pc) and
    no plain composition in their place; its output equals the eager
    encode's."""
    vl, tower = _tower(m)
    shape = vl._warmup_sample(m, 1).shape[1:]
    shape = shape[1:] if m == "audio" else shape  # one clip
    x = torch.from_numpy(np.random.RandomState(1).randn(2, *shape)
                         .astype(np.float32) * 0.3)
    blob = PX.export_encoder(tower, x, torch.bfloat16)
    prog = PX.load_exported(blob)
    ops = [str(n.target) for n in prog.program.graph.nodes
           if str(n.target).startswith("vitlens.")]
    cfg = tower.cfg
    lens = cfg.perceiver.depth * (1 + cfg.perceiver.self_per_cross_attn)
    want_ops = {"vitlens.fused_mlp.default": 2,
                "vitlens.flash_attention.default": 2 + lens}
    if m == "pc":
        want_ops.update({"vitlens.fps_indices.default": 1,
                         "vitlens.fused_point_encoder.default": 1})
    assert {o: ops.count(o) for o in set(ops)} == want_ops
    got = prog.call(x)
    want = vl.encode({m: x}, preprocessed=True)[m]
    assert got.shape == want.shape
    assert torch.equal(got.float(), want.float())
    # the same function exported through the JAX package's entry name
    blob2 = PX.export_stablehlo(lambda t: tower(t, torch.bfloat16), x)
    assert torch.equal(PX.load_exported(blob2).call(x), tower(x, torch.bfloat16))
    # JAX's platform list has no meaning here and is refused, not ignored
    with pytest.raises(TypeError, match="platforms"):
        PX.export_encoder(tower, x, torch.bfloat16, platforms=("tpu",))
    with pytest.raises(TypeError, match="platforms"):
        PX.export_stablehlo(tower, x, platforms=("tpu",))


def test_export_needs_no_grad_and_keeps_eager_paths():
    """Outside an export the wrappers dispatch as before (autograd records
    the kernels' Functions); inside, they record the ops."""
    from vitlens_tpu_torch.ops import custom
    from vitlens_tpu_torch.ops.flash_attention import flash_attention

    q = torch.randn(1, 2, 5, 16, dtype=torch.bfloat16, requires_grad=True)
    out = flash_attention(q, q.detach(), q.detach())
    assert "FlashAttentionFunction" in type(out.grad_fn).__name__
    assert not custom.through_ops()
    with custom.tracing():
        assert custom.through_ops()
    assert not custom.through_ops()


def test_hub_resolution_from_cache(tmp_path, monkeypatch):
    from vitlens_tpu.utils import hub as JH

    assert PH.PRETRAINED_REGISTRY == JH.PRETRAINED_REGISTRY
    monkeypatch.setenv("VITLENS_CKPT_CACHE_DIR", str(tmp_path))
    for model, tag in (("ViT-L-14", "openai"), ("ViT-L-14", "datacomp_xl_s13b_b90k"),
                       ("ViT-L-14", "vitlensL_audio")):
        want = os.path.join(str(tmp_path), model, os.path.basename(
            PH.cached_path(model, tag)))
        assert PH.cached_path(model, tag) == want
        with pytest.raises(RuntimeError, match="not cached at"):
            PH.resolve_pretrained(model, tag)
        os.makedirs(os.path.dirname(want), exist_ok=True)
        open(want, "wb").close()
        assert PH.resolve_pretrained(model, tag) == want
        # the JAX package finds the same file in the same cache
        assert JH.resolve_pretrained(model, tag) == want
    assert PH.get_pretrained_cfg("ViT-L-14", "openai")["quick_gelu"] is True
    assert os.path.basename(PH.cached_path("ViT-L-14", "datacomp_xl_s13b_b90k")) \
        == "open_clip_pytorch_model.bin"
    with pytest.raises(KeyError, match="unknown pretrained tag"):
        PH.resolve_pretrained("ViT-L-14", "nope")
    f = tmp_path / "direct.pt"
    f.write_bytes(b"")
    assert PH.resolve_pretrained("ViT-L-14", str(f)) == str(f)
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(ImportError, match="huggingface_hub"):
        PH.push_to_hf_hub(torch.nn.Linear(2, 2), {}, "org/repo")


def test_trainer_pretrained_tag_resolves_through_the_cache(tmp_path, monkeypatch):
    """--pretrained vitlensL_audio (a tag, no file) loads the cached file."""
    from vitlens_tpu_torch.cli import train as CT
    from vitlens_tpu_torch.cli.args import parse_args

    monkeypatch.setenv("VITLENS_CKPT_CACHE_DIR", str(tmp_path))
    cfg = PC.make_model_config("ViT-Tiny-Test", "audio")
    g = torch.Generator().manual_seed(7)
    sd = {"visual." + k: v for k, v in vision_tower_state_dict(cfg.tower, g).items()}
    sd.update({"image." + k: v for k, v in vision_tower_state_dict(
        PC.image_tower_config(cfg), g).items()})
    sd.update(text_tower_state_dict(cfg.text, cfg.embed_dim, g))
    path = PH.cached_path("ViT-Tiny-Test", "vitlensL_audio")
    os.makedirs(os.path.dirname(path))
    torch.save(sd, path)
    args = parse_args(["--modality", "audio", "--model", "ViT-Tiny-Test",
                       "--pretrained", "vitlensL_audio"])
    _, _, model, _ = CT.build_model(args, torch.device("cpu"))
    np.testing.assert_array_equal(model.visual.ln_post.scale.detach().numpy(),
                                  sd["visual.ln_post.weight"].numpy())
