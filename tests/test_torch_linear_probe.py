"""The linear probe (vitlens_tpu_torch/models/linear_probe.py) and its
trainer (cli/train_linprobe.py) against the JAX package on the CPU, on a
tiny tactile tower: the logits in eval and train mode with and without the
projection, the head BatchNorm's running statistics (momentum 0.1, unbiased
var), LARS against optax.lars over several steps, head-only training (three
steps of both packages' steps from the same weights, the backbone unchanged),
dropout's rate (statistically), and the CLI end to end on written tactile
files. fp32: 1e-5 of each output's largest magnitude (LARS: 1e-6 of the
parameters, 1e-4 of their moves)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from vitlens_tpu.config import make_model_config as jax_model_config
from vitlens_tpu.models import linear_probe as JLP
from vitlens_tpu.train.freeze import apply_mask as jax_apply_mask
from vitlens_tpu.train.schedules import get_schedule as jax_schedule
from vitlens_tpu_torch.config import make_model_config
from vitlens_tpu_torch.models import linear_probe as PLP
from vitlens_tpu_torch.train.schedules import get_schedule
from vitlens_tpu_torch.weights.from_jax import load_params, load_state, read_state
from tests.test_torch_threads import share_cores

share_cores()

N_CLASSES = 3


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1e-12, np.abs(want).max())


def _probe(proj, seed=0):
    jcfg = jax_model_config("ViT-Tiny-Test", "tactile").tower
    pcfg = make_model_config("ViT-Tiny-Test", "tactile").tower
    params, state = JLP.linear_probe_init(jax.random.PRNGKey(seed), jcfg, N_CLASSES,
                                          enable_vit_proj=proj)
    m = PLP.LinearProbe(pcfg, N_CLASSES, enable_vit_proj=proj)
    tree = params if proj else {**params, "backbone": {
        k: v for k, v in params["backbone"].items() if k != "proj"}}
    load_params(m, tree)
    load_state(m, state)
    return jcfg, params, state, m


def _x(b=4, seed=0):
    return np.random.RandomState(seed).randn(b, 3, 28, 28).astype(np.float32)


@pytest.mark.parametrize("proj", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_logits_and_bn_stats_match_jax(proj, train):
    jcfg, params, state, m = _probe(proj)
    state = {**state, "head_bn": {"mean": jnp.full_like(state["head_bn"]["mean"], 0.3),
                                  "var": jnp.full_like(state["head_bn"]["var"], 2.0)}}
    load_state(m, state)
    x = _x()
    want, new_state = JLP.linear_probe_apply(params, state, jnp.asarray(x), jcfg,
                                             enable_vit_proj=proj, train=train)
    got = m(torch.from_numpy(x), train=train)
    assert got.shape == (4, N_CLASSES)
    assert _rel(got.detach().numpy(), want) < 1e-5
    got_bn = read_state(m, new_state)["head_bn"]
    for k in ("mean", "var"):
        assert _rel(got_bn[k], new_state["head_bn"][k]) < 1e-5, k


@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_lars_matches_optax(wd):
    """Five steps on a matrix and a bias, trust ratio and decay on the
    matrix only (the trainer's masks), a warmup-cosine schedule."""
    rng = np.random.RandomState(1)
    p0 = {"w": rng.randn(6, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(5)]
    nd = {"w": True, "b": False}
    tx = optax.lars(jax_schedule("cosine", 0.1, 2, 5), weight_decay=wd,
                    weight_decay_mask=nd, trust_coefficient=0.001,
                    trust_ratio_mask=nd, momentum=0.9)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    pp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    opt = PLP.LARS(pp, get_schedule("cosine", 0.1, 2, 5), wd, nd, 0.001, nd, 0.9)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step({k: torch.from_numpy(v) for k, v in g.items()})
        for k in p0:
            assert _rel(pp[k].numpy(), jp[k]) < 1e-6, k
            # the moves (~1e-3 of |p|, so p's own fp32 rounding is ~1e-4 of them)
            assert _rel(pp[k].numpy() - p0[k], np.asarray(jp[k]) - p0[k]) < 1e-4, k
    assert opt.count == 5


def test_head_only_training_matches_jax():
    """Three steps of LARS (wd 0.01) on the head: JAX's jitted step of
    train_linprobe.main against the port's step; the head and the BN
    statistics agree; the backbone is bit-identical."""
    jcfg, params, state, m = _probe(False, seed=2)
    mask = JLP.lp_trainable_mask(params)
    nd = jax.tree.map(lambda p: p.ndim > 1, params)
    sched = jax_schedule("cosine", 0.05, 1, 3)
    tx = optax.lars(sched, weight_decay=0.01, weight_decay_mask=nd,
                    trust_coefficient=0.001, trust_ratio_mask=nd, momentum=0.9)
    opt_state = tx.init(params)
    backbone0 = {n: p.clone() for n, p in m.backbone.named_parameters()}
    head = dict(m.lp_head.named_parameters())
    for p in head.values():
        p.requires_grad_(True)
    opt = PLP.lars_for_head(m, get_schedule("cosine", 0.05, 1, 3), 0.01)

    def loss_fn(p, st, x, y):
        logits, new_st = JLP.linear_probe_apply(p, st, x, jcfg, train=True)
        return JLP.softmax_cross_entropy_loss(logits, y), new_st

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    for i in range(3):
        x = _x(6, seed=10 + i)
        y = np.random.RandomState(i).randint(0, N_CLASSES, 6).astype(np.int32)
        (jloss, state), g = grad_fn(params, state, jnp.asarray(x), jnp.asarray(y))
        g = jax_apply_mask(g, mask)
        upd, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, jax_apply_mask(upd, mask))

        loss = PLP.softmax_cross_entropy_loss(m(torch.from_numpy(x), train=True),
                                              torch.from_numpy(y))
        opt.step(dict(zip(head, torch.autograd.grad(loss, list(head.values())))))
        assert _rel(loss.item(), jloss) < 1e-5
    for k in ("w", "b"):
        assert _rel(head[k].detach().numpy(), params["lp_head"][k]) < 1e-5
    assert _rel(m.head_bn.var.numpy(), state["head_bn"]["var"]) < 1e-5
    for n, p in m.backbone.named_parameters():
        assert torch.equal(p, backbone0[n]), n


def test_dropout_rate():
    """Dropout keeps a (1 - rate) share of the features (binomial, 5 sigma
    over 64 x 4096 draws), scaled by 1 / (1 - rate), the same for the same
    generator state; the probe applies it in train mode only."""
    h = torch.ones(64, 4096)
    out = PLP.dropout(h, 0.3, torch.Generator().manual_seed(0))
    kept = out != 0
    n = h.numel()
    assert abs(kept.float().mean().item() - 0.7) < 5 * (0.21 / n) ** 0.5
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / 0.7))
    assert torch.equal(out, PLP.dropout(h, 0.3, torch.Generator().manual_seed(0)))
    _, _, _, m = _probe(False)
    x = torch.from_numpy(_x(8, seed=3))
    a = m(x, train=True, dropout_rate=0.3,
          dropout_generator=torch.Generator().manual_seed(1))
    b = m(x, train=True, dropout_rate=0.3,
          dropout_generator=torch.Generator().manual_seed(2))
    assert not torch.equal(a, b)
    assert torch.equal(m(x), m(x, dropout_rate=0.3))


def _tactile_files(tmp_path, n=8):
    rng = np.random.RandomState(4)
    meta = tmp_path / "meta" / "modal_tactile" / "data"
    meta.mkdir(parents=True)
    anno = []
    for i in range(n):
        Image.fromarray(rng.randint(0, 255, (40, 48, 3), np.uint8)).save(
            tmp_path / f"g{i}.jpg")
        anno.append({"gel_path": f"g{i}.jpg", "image_path": "", "sr_label": i % 2})
    for f in ("train_rough.json", "test_rough.json"):
        (meta / f).write_text(json.dumps(anno))
    return tmp_path


def test_cli_end_to_end_on_tactile_files(tmp_path, monkeypatch):
    """train_linprobe on written GelSight frames at the test trunk, from a
    reference-layout backbone file: 2 epochs, an accuracy a val epoch in
    results.jsonl, the head moved, the backbone the file's."""
    from tools.reference_layout import vision_tower_state_dict
    from vitlens_tpu_torch.cli import train_linprobe as CLI

    root = _tactile_files(tmp_path)
    monkeypatch.setenv("VITLENS_TACTILE_DATA_DIR", str(root))
    monkeypatch.setenv("VITLENS_METADATA_DIR", str(root / "meta"))
    cfg = make_model_config("ViT-Tiny-Test", "tactile")
    sd = {f"visual.{k}": v for k, v in vision_tower_state_dict(
        cfg.tower, torch.Generator().manual_seed(5)).items()}
    torch.save(sd, tmp_path / "backbone.pt")
    seen = {}
    real_main_probe = PLP.LinearProbe.__init__

    def keep(self, *a, **k):
        real_main_probe(self, *a, **k)
        seen["model"] = self

    monkeypatch.setattr(PLP.LinearProbe, "__init__", keep)
    rc = CLI.main(["--modality", "tactile", "--model", "ViT-Tiny-Test",
                   "--train-split", "train_rough", "--val-split", "test_rough",
                   "--num-classes", "2", "--lp-ckpt", str(tmp_path / "backbone.pt"),
                   "--batch-size", "4", "--epochs", "2", "--warmup", "1",
                   "--precision", "fp32", "--workers", "0", "--device", "cpu",
                   "--logs", str(tmp_path / "logs"), "--name", "lp",
                   "--lp-dropout-rate", "0.1"])
    assert rc == 0
    lines = [json.loads(s) for s in
             (tmp_path / "logs" / "lp" / "results.jsonl").read_text().splitlines()]
    accs = [r for r in lines if any("accuracy" in k for k in r)]
    assert len(accs) == 2
    m = seen["model"]
    want = sd["visual.ln_post.weight"].numpy()
    np.testing.assert_array_equal(m.backbone.ln_post.scale.detach().numpy(), want)
    assert m.head_bn.mean.abs().max() > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CLI.main(["--num-classes", "2", "--logs", str(tmp_path / "x")])
