"""LoRA (vitlens_tpu_torch/train/lora.py) against the JAX package's
train/lora.py on the CPU, on a tiny audio tri config: the adapted tower at
init is the base tower; a JAX tree carrying a "lora" subtree (nonzero b)
loads whole and encodes as JAX's merge-at-apply does, for the Lens and the
text towers; merge_lora and the mask; three train steps that move the
factors alone, against JAX's step (remat on and off: the merge runs inside
each block's checkpoint); the trainer's --lora-* flags; the export's merged
weights and the reload that zeroes the factors; quant rejecting an unmerged
tower. fp32: 1e-5 of each output's largest magnitude (steps: 1e-5 relative,
1e-6 absolute, as tests/test_torch_train.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitlens_tpu import config as JC
from vitlens_tpu.models import tri as JT
from vitlens_tpu.train import freeze as JF
from vitlens_tpu.train import lora as JL
from vitlens_tpu.train import step as JStep
from vitlens_tpu_torch import config as PC
from vitlens_tpu_torch import quant as PQ
from vitlens_tpu_torch.factory import make_trainable_
from vitlens_tpu_torch.models import tri as PT
from vitlens_tpu_torch.models.tri import TriModel
from vitlens_tpu_torch.train import freeze as PF
from vitlens_tpu_torch.train import lora as PL
from vitlens_tpu_torch.train import step as PStep
from vitlens_tpu_torch.weights.from_jax import flatten, load_tri_params

from test_torch_train import _batch, _per_param, _rel, _tiny
from tests.test_torch_threads import share_cores

share_cores()


def _jax_with_lora(towers=("visual",), rank=4, alpha=8.0, targets=PL.DEFAULT_TARGETS,
                   nonzero_b=True):
    jcfg = _tiny(JC)
    params, state = JT.tri_model_init(jax.random.PRNGKey(0), jcfg)
    params = dict(params)
    for i, t in enumerate(towers):
        params[t] = dict(params[t])
        lora = JL.lora_init(jax.random.PRNGKey(17 + i), params[t], rank,
                            alpha=alpha, targets=targets)
        if nonzero_b:  # a trained adapter: b away from its zero init
            lora = jax.tree_util.tree_map_with_path(
                lambda p, x: (0.05 * jax.random.normal(
                    jax.random.PRNGKey(len(str(p))), x.shape)
                    if str(p[-1]) == "['b']" else x), lora)
        params[t]["lora"] = lora
    return jcfg, params, state


def _port(params, towers=("visual",), rank=4, alpha=8.0, targets=PL.DEFAULT_TARGETS):
    model = TriModel(_tiny(PC), device="cpu")
    for t in towers:
        PL.lora_init(getattr(model, t), rank, torch.Generator().manual_seed(5),
                     alpha=alpha, targets=targets)
    return load_tri_params(model, params)


def test_lora_init_is_the_base_tower():
    jcfg, params, state = _jax_with_lora(towers=())
    model = load_tri_params(TriModel(_tiny(PC), device="cpu"), params)
    x = torch.from_numpy(_batch(3, 0)["visual"])
    base = PT.encode_visual(model, x)
    lora = PL.lora_init(model.visual, 4, torch.Generator().manual_seed(0))
    assert float(lora.scale) == 1.0 and lora.trunk.blocks[0].attn.qkv_w.b.abs().max() == 0
    assert lora.trunk.blocks[1].mlp.fc.w.a.std().item() == pytest.approx(0.5, rel=0.2)
    assert torch.equal(PT.encode_visual(model, x), base)


@pytest.mark.parametrize("towers", [("visual",), ("visual", "text")])
def test_adapted_towers_match_jax(towers):
    jcfg, params, state = _jax_with_lora(towers)
    model = _port(params, towers)
    batch = _batch(3, 1)
    want = JT.encode_visual(params, state, jnp.asarray(batch["visual"]), jcfg)[0]
    got = PT.encode_visual(model, torch.from_numpy(batch["visual"]))
    assert _rel(got.detach().numpy(), want) < 1e-5
    want = JT.encode_text(params, jnp.asarray(batch["text"]), jcfg)
    got = PT.encode_text(model, torch.from_numpy(batch["text"]).long())
    assert _rel(got.detach().numpy(), want) < 1e-5
    for t in towers:
        merged = PL.merge_lora(getattr(model, t))
        want = flatten(JL.merge_lora(params[t]))
        assert not any(k.startswith("lora.") for k in merged)
        assert sorted(merged) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(merged[k].numpy(), v, rtol=1e-6,
                                       atol=1e-7, err_msg=k)


def test_mask_and_targets_match_jax(caplog):
    targets = ("attn.qkv_w", "mlp.proj.w", "mlp.nope.w")
    jcfg, params, _ = _jax_with_lora(targets=targets)
    model = _port(params, targets=targets)
    want = _per_param({k: (JL.lora_mask(params[k]) if k == "visual" else
                           jax.tree.map(lambda _: 0.0, params[k]))
                       for k in params}, params)
    got = PL.lora_mask(model.visual)
    assert got == {k[len("visual."):]: v for k, v in want.items()
                   if k.startswith("visual.")}
    assert sum(got.values()) == 2 * 2 * 2 and not got["lora.scale"]
    assert "mlp.nope.w" in caplog.text
    with pytest.raises(ValueError, match="no lora target"):
        PL.lora_init(model.text, 2, torch.Generator(), targets=("attn.zz",))
    with pytest.raises(ValueError, match="rank must be positive"):
        PL.lora_init(model.text, 0, torch.Generator())


@pytest.mark.parametrize("remat", [False, True])
def test_lora_train_step_matches_jax(remat):
    """The trainer's LoRA recipe on both towers: only the factors train
    (the mask overrides the lock flags); three steps against JAX's."""
    towers = ("visual", "text")
    jcfg, params, state = _jax_with_lora(towers, nonzero_b=False)
    ocfg = dict(lr=1e-3, eps=1e-4, warmup=2, total_steps=10)
    jmask = dict(JF.tri_model_mask(params, jcfg, lock_image=True, lock_text=True,
                                   lock_visual=True))
    for t in towers:
        jmask[t] = JL.lora_mask(params[t])
    jtx, jmask = JStep.make_optimizer(params, JStep.OptimizerConfig(**ocfg), jmask)
    jstep = JStep.make_train_step(jcfg, jtx, jmask, JStep.StepConfig(
        n_tower=2, align_to="text", local_loss=False, sync_bn=False, remat=remat,
        compute_dtype=jnp.float32), mesh=None)
    ts = JStep.init_train_state(params, state, jtx)

    model = _port(params, towers)
    pcfg = _tiny(PC)
    mask = PF.tri_model_mask(model, pcfg)
    for t in towers:
        mask.update({f"{t}.{k}": v for k, v in PL.lora_mask(getattr(model, t)).items()})
    tx, mask = PStep.make_optimizer(model, PStep.OptimizerConfig(**ocfg), mask)
    make_trainable_(model, mask, torch.float32)
    frozen0 = {n: p.detach().clone() for n, p in model.named_parameters()
               if not mask[n]}
    pstate = PStep.init_train_state(model, tx)
    pstep = PStep.make_train_step(pcfg, tx, mask, PStep.StepConfig(
        n_tower=2, align_to="text", remat=remat, compute_dtype=torch.float32))
    for i in range(3):
        batch = _batch(4, seed=20 + i)
        ts, jm = jstep(ts, {k: jnp.asarray(v) for k, v in batch.items()}, None)
        pstate, pm = pstep(pstate, batch)
        for k in ("loss", "grad_norm"):
            assert _rel(pm[k].numpy(), jm[k]) < 1e-5, (i, k)
    want = flatten(ts.params)
    trained = [n for n in mask if mask[n] and n != "logit_scale"]
    assert trained and all(".lora." in n for n in trained)
    assert {n.rsplit(".", 1)[-1] for n in trained} == {"a", "b"}
    for name, p in model.named_parameters():
        if mask[name]:
            np.testing.assert_allclose(p.detach().numpy(), want[name],
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        else:
            assert torch.equal(p, frozen0[name]), name
    assert model.visual.lora.trunk.blocks[0].mlp.fc.w.b.abs().max() > 0


def test_trainer_lora_flags():
    """cli.train's --lora-rank/--lora-alpha/--lora-targets/--lora-towers:
    the factors of the named towers train alone, drawn from --seed + 17 + i;
    an unknown tower exits."""
    from vitlens_tpu_torch.cli.args import parse_args
    from vitlens_tpu_torch.cli.train import build_model

    args = parse_args(["--modality", "audio", "--model", "ViT-Tiny-Test",
                       "--lora-rank", "2", "--lora-alpha", "4",
                       "--lora-towers", "visual, text,visual",
                       "--lora-targets", "attn.qkv_w, mlp.fc.w", "--unlock-cls"])
    cfg, _, model, mask = build_model(args, torch.device("cpu"))
    assert list(mask) == [n for n, _ in model.named_parameters()]
    trained = sorted(n for n, v in mask.items() if v)
    assert trained and all(n.split(".")[0] in ("visual", "text", "logit_scale")
                           for n in trained)
    assert not mask["visual.class_embedding"]  # the LoRA mask overrides
    assert {n for n in trained if n != "logit_scale"} == {
        f"{t}.lora.trunk.blocks.{i}.{w}.{f}" for t in ("visual", "text")
        for i in range(2) for w in ("attn.qkv_w", "mlp.fc.w") for f in "ab"}
    assert float(model.visual.lora.scale) == 2.0
    a = model.text.lora.trunk.blocks[0].attn.qkv_w.a
    g = torch.Generator().manual_seed(args.seed + 18)
    assert torch.equal(a, torch.randn(a.shape, generator=g) * 2 ** -0.5)
    bad = parse_args(["--modality", "audio", "--model", "ViT-Tiny-Test",
                      "--lora-rank", "2", "--lora-towers", "image"])
    with pytest.raises(SystemExit):
        build_model(bad, torch.device("cpu"))


def _small_vitlens(seed):
    from vitlens_tpu_torch.api import ViTLens

    vl = ViTLens("vitlensB", ("audio",), device="cpu", seed=seed)
    vl.towers["audio"].trunk.blocks = vl.towers["audio"].trunk.blocks[:2]
    return vl


def test_export_carries_merged_weights_and_reloads(tmp_path):
    """export_params merges (no lora.* names); export_checkpoint writes the
    merged weights; a model whose live tower has other factors loads them
    into its base weights, zeroes its b's and encodes as the exporter did;
    quant refuses an unmerged tower and takes the merged reload."""
    vl = _small_vitlens(1)
    tower = vl.towers["audio"]
    PL.lora_init(tower, 2, torch.Generator().manual_seed(2), alpha=4.0)
    with torch.no_grad():
        for n, p in tower.lora.named_parameters():
            if n.endswith(".b"):
                p.normal_(0, 0.05, generator=torch.Generator().manual_seed(len(n)))
    a = tower.cfg.audio
    fb = torch.from_numpy(np.random.RandomState(0).randn(
        2, a.target_length, a.mel_bins).astype(np.float32)) * 0.5
    want = vl.encode({"audio": fb}, preprocessed=True)["audio"]
    merged = vl.export_params()["audio"]
    assert not any(n.startswith("lora.") for n in merged)
    w0 = tower.trunk.blocks[0].attn.qkv_w
    assert not torch.equal(merged["trunk.blocks.0.attn.qkv_w"], w0)
    assert any(n.startswith("lora.") for n in vl.export_params(merge_lora=False)["audio"])
    with pytest.raises(ValueError, match="LoRA"):
        PQ.quantize_model(vl, towers=("towers.audio",))
    path = vl.export_checkpoint(str(tmp_path / "export"))

    other = _small_vitlens(3)
    PL.lora_init(other.towers["audio"], 2, torch.Generator().manual_seed(4), alpha=4.0)
    other.load_checkpoint(path)
    for n, p in other.towers["audio"].lora.named_parameters():
        if n.endswith(".b"):
            assert p.abs().max() == 0, n
    got = other.encode({"audio": fb}, preprocessed=True)["audio"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    plain = _small_vitlens(5)
    plain.load_checkpoint(path)
    np.testing.assert_allclose(plain.encode({"audio": fb}, preprocessed=True)["audio"].numpy(),
                               want.numpy(), atol=1e-6)
    PQ.quantize_model(plain, towers=("towers.audio",))
