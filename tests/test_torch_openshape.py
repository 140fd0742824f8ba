"""The OpenShape trainer's model, loss and optimizer (train/openshape.py,
train/step.py) on the CPU, held against the JAX package: CLIPBind with and
without its replacement ``proj_layer`` (train and eval, fp32; eval in bf16
by cosine), ``openshape_loss`` and its gradients with both projection
flags, ``contras_loss`` and both negative masks, two AdamW steps with the
trunk's 0.1 lr scale against JAX's ``optax.chain(clip_by_global_norm(1.0),
adamw(..., mask))`` (parameters, moments, and the decay-only closed form of
the parameters no gradient reaches), the weight-decay mask name by name
against JAX's ``ndim >= 2``, ``trunk_lr_scale``, the triplet dataset from a
fixed seed and ``precomputed_text_eval``. The tower is the JAX CLI's
``--tiny`` one; parameters and BatchNorm statistics are JAX's, copied with
weights/from_jax.py; inputs come from numpy seeds; FPS starts are JAX's
draws from its key; fp32 agrees to 1e-5 of each output's largest
magnitude."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vitlens_tpu.cli import train_openshape as JCLI
from vitlens_tpu.train import openshape as JOS
from vitlens_tpu.train.schedules import get_schedule
from vitlens_tpu_torch.cli import train_openshape as PCLI
from vitlens_tpu_torch.train import openshape as POS
from vitlens_tpu_torch.train.step import _grads, make_openshape_optimizer
from vitlens_tpu_torch.weights.from_jax import (flatten, load_params,
                                                load_state, read_state)
from tests.test_torch_threads import share_cores

share_cores()

N = 64  # points a cloud
TINY = ["--tiny", "--npoints", str(N)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1e-12, np.abs(want).max())


def _cfgs(skip=None):
    j = JCLI.tower_config(JCLI.build_args(TINY))
    p = PCLI.tower_config(PCLI.build_args(TINY))
    return (dataclasses.replace(j, skip_first_n_layers=skip),
            dataclasses.replace(p, skip_first_n_layers=skip))


def _random_bn(p, s, seed):
    """Random scale/bias and mean/var for the PNSA tokenizer's BatchNorms."""
    rng = np.random.RandomState(seed)
    p, s = jax.tree.map(lambda x: x, p), jax.tree.map(lambda x: x, s)
    for lp, ls in zip(p["backbone"]["adapter"]["sa"],
                      s["backbone"]["adapter"]["sa"]):
        c = lp["bn"]["scale"].shape[0]
        lp["bn"] = {"scale": jnp.asarray(1 + 0.2 * rng.randn(c), jnp.float32),
                    "bias": jnp.asarray(0.1 * rng.randn(c), jnp.float32)}
        ls["bn"] = {"mean": jnp.asarray(0.2 * rng.randn(c), jnp.float32),
                    "var": jnp.asarray(0.5 + rng.rand(c), jnp.float32)}
    return p, s


def _binds(out_channel, skip=None, seed=0):
    """(JAX config, params, state, the port's CLIPBind loaded from them)."""
    jcfg, pcfg = _cfgs(skip)
    p, s = _random_bn(*JOS.clip_bind_init(jax.random.PRNGKey(seed), jcfg,
                                          out_channel), seed + 1)
    model = POS.CLIPBind(pcfg, out_channel)
    load_params(model, p)
    load_state(model, s)
    return jcfg, p, s, model


def _cloud(b, seed):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.randn(b, N, 3) * 0.3, rng.rand(b, N, 3)],
                          -1).astype(np.float32)


def _starts(key, b):
    return torch.from_numpy(np.array(jax.random.randint(key, (b,), 0, N)))


# -- the model ----------------------------------------------------------------------

@pytest.mark.parametrize("out_channel,train", [(40, False), (40, True),
                                               (16, False), (16, True)])
def test_clip_bind_matches_jax(out_channel, train):
    """clip_bind_apply, fp32: out_channel 40 replaces the 16-wide CLIP
    projection (JAX drops the backbone's proj and multiplies by an identity;
    the port has no proj at all), 16 keeps it; train mode also moves the
    running statistics as JAX's do."""
    jcfg, p, s, model = _binds(out_channel)
    replaced = out_channel != jcfg.embed_dim
    assert ("proj_layer" in p) == replaced == (model.proj_layer is not None)
    assert (model.backbone.proj is None) == replaced
    x = _cloud(2, seed=2)
    key = jax.random.PRNGKey(3)
    want, new_s = jax.jit(lambda p_, s_, x_, k: JOS.clip_bind_apply(
        p_, s_, x_, jcfg, train=train, fps_key=k))(p, s, jnp.asarray(x), key)
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=train, fps_start=_starts(key, 2))
    assert tuple(got.shape) == (2, out_channel)
    assert _rel(got.numpy(), want) < 1e-5
    got_s = flatten(read_state(model, new_s))
    for name, w in flatten(new_s).items():
        assert _rel(got_s[name], w) < 1e-5, name


def test_clip_bind_bf16_matches_jax():
    """bf16 compute on both sides: cosine >= 0.999 computed in fp32."""
    jcfg, p, s, model = _binds(40, seed=4)
    x = _cloud(3, seed=5)
    want, _ = jax.jit(lambda p_, s_, x_: JOS.clip_bind_apply(
        p_, s_, x_, jcfg, compute_dtype=jnp.bfloat16))(p, s, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = torch.from_numpy(np.asarray(want, np.float32))
    cos = torch.nn.functional.cosine_similarity(got.float(), want, dim=-1)
    assert cos.min().item() >= 0.999


def _batch(b, seed, width):
    rng = np.random.RandomState(seed)
    return {"xyz_features": _cloud(b, seed),
            "text_feat": rng.randn(b, width).astype(np.float32),
            "img_feat": rng.randn(b, width).astype(np.float32)}


# The biases in front of a batch-statistics BatchNorm (PNSA's sa.{i}.conv.b)
# change no output in train mode: their gradients are rounding noise.
def _cancelled(name):
    return name.startswith("backbone.adapter.sa.") and name.endswith("conv.b")


@pytest.mark.parametrize("proj", [False, True])
def test_openshape_loss_and_grads_match_jax(proj):
    """openshape_loss in train mode: the loss, its four metrics and the
    gradient of every parameter (zeros for the unused projections) to 1e-5
    of each one's max|ref|; the cancelled biases' gradients are rounding
    noise on both sides, held to 1e-5 of their weight's gradient."""
    jcfg, p, s, model = _binds(40, seed=6)
    batch = _batch(4, seed=7, width=40)
    key = jax.random.PRNGKey(8)
    kw = dict(use_text_proj=proj, use_image_proj=proj, text_weight=1.0,
              image_weight=0.5)
    (loss, (metrics, _)), grads = jax.jit(jax.value_and_grad(
        lambda p_, s_, b_, k: JOS.openshape_loss(p_, s_, b_, jcfg, fps_key=k,
                                                 **kw), has_aux=True))(
        p, s, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    want = flatten(grads)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    got_loss, got_m = POS.openshape_loss(
        model, {k: torch.from_numpy(v) for k, v in batch.items()},
        fps_start=_starts(key, 4), **kw)
    got = _grads(got_loss, params)
    assert _rel(got_loss.item(), loss) < 1e-5
    for k, v in metrics.items():
        assert _rel(got_m[k].item(), v) < 1e-5, k
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        if _cancelled(name):
            scale = np.abs(want[name[:-1] + "w"]).max()
            assert np.abs(g.numpy()).max() < 1e-5 * scale, name
        else:
            assert _rel(g.numpy(), want[name]) < 1e-5, name
    for name in ("image_proj.w", "text_proj.w"):
        assert (np.abs(want[name]).max() > 0) == proj
        assert (got[name].abs().max().item() > 0) == proj


def test_contras_loss_and_masks_match_jax():
    """contras_loss with and without a mask, knn_negative_mask and
    sim_margin_mask (with a base mask), fp32."""
    rng = np.random.RandomState(9)
    a, b, c = (rng.randn(6, 12).astype(np.float32) for _ in range(3))
    np.testing.assert_array_equal(POS.knn_negative_mask(3, 2),
                                  JOS.knn_negative_mask(3, 2))
    base = torch.from_numpy(POS.knn_negative_mask(3, 2))
    for base_mask in (None, base):
        want = JOS.sim_margin_mask(
            jnp.asarray(b), jnp.asarray(c), 0.1,
            None if base_mask is None else jnp.asarray(base_mask.numpy()))
        got = POS.sim_margin_mask(torch.from_numpy(b), torch.from_numpy(c), 0.1,
                                  base_mask)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    scale = np.float32(np.exp(np.log(1 / 0.07)))
    for mask in (None, got):
        want_l, want_a = JOS.contras_loss(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(scale),
            None if mask is None else jnp.asarray(mask.numpy()))
        loss, acc = POS.contras_loss(torch.from_numpy(a), torch.from_numpy(b),
                                     torch.tensor(scale), mask)
        assert _rel(loss.item(), want_l) < 1e-6
        assert acc.item() == float(want_a)


# -- the optimizer --------------------------------------------------------------------

def _grad_trees(p, seed):
    """Two random gradient trees with JAX's structure: zeros for the
    skipped block (index 0 of each stacked trunk leaf) and for the
    projections, which the default flags leave unused."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        g = jax.tree.map(lambda l: jnp.asarray(
            np.asarray(rng.randn(*np.shape(l)), np.float32)), p)
        g["backbone"]["trunk"]["blocks"] = jax.tree.map(
            lambda l: l.at[0].set(0.0), g["backbone"]["trunk"]["blocks"])
        for k in ("image_proj", "text_proj"):
            g[k] = jax.tree.map(jnp.zeros_like, g[k])
        out.append(g)
    return out


def _adam_state(opt):
    """The ScaleByAdamState inside JAX's optax chain."""
    for leaf in jax.tree.leaves(opt, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return leaf
    raise AssertionError("no adam state")


def test_two_steps_match_optax():
    """Two updates from the same gradients: JAX's CLI optimizer (the clip
    at 1.0, adamw with optax's defaults, the ndim >= 2 decay mask, the
    updates times trunk_lr_scale) against AdamW from
    make_openshape_optimizer with ndim_wd_mask and trunk_lr_scale:
    parameters and both moments to 1e-5; the skipped block and the unused
    projections move by decay alone, p * prod(1 - lr_t * wd * scale), and
    the projections' 1-D biases not at all."""
    jcfg, p, s, model = _binds(40, skip=1, seed=10)
    lr, wd, warmup, total = 0.01, 0.2, 1, 4
    sched = get_schedule("cosine", lr, warmup, total)
    wd_mask = jax.tree.map(lambda l: np.ndim(l) >= 2, p)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(sched, weight_decay=wd, mask=wd_mask))
    scales = JOS.trunk_lr_scale(p)
    opt = tx.init(p)
    jp = p
    grads = _grad_trees(p, seed=11)

    @jax.jit
    def update(g, opt, jp):
        updates, opt = tx.update(g, opt, jp)
        updates = jax.tree.map(lambda u, sc: u * sc.astype(u.dtype), updates,
                               scales)
        return optax.apply_updates(jp, updates), opt

    for g in grads:
        jp, opt = update(g, opt, jp)

    model.requires_grad_(True)
    ptx = make_openshape_optimizer(
        model, lr=lr, warmup=warmup, total_steps=total, weight_decay=wd,
        decay=POS.ndim_wd_mask(model), lr_scale=POS.trunk_lr_scale(model))
    state = ptx.init(model)
    p0 = {n: t.detach().clone() for n, t in model.named_parameters()}
    params = dict(model.named_parameters())
    for g in grads:
        ptx.update_(params, {n: torch.tensor(np.asarray(v))
                             for n, v in flatten(g).items()}, state)
    assert state["count"] == 2
    want = flatten(jp)
    for name, t in params.items():
        assert _rel(t.detach().numpy(), want[name]) < 1e-5, name
    adam = _adam_state(opt)
    for moment in ("mu", "nu"):
        want_m = flatten(getattr(adam, moment))
        for name, t in state[moment].items():
            assert _rel(t.numpy(), want_m[name]) < 1e-5, (moment, name)
    lrs = [float(sched(i)) for i in range(2)]
    for name, t in params.items():
        if name.startswith("backbone.trunk.blocks.0."):  # skipped: all decay
            f = (1 - lrs[0] * wd * 0.1) * (1 - lrs[1] * wd * 0.1)
        elif name in ("image_proj.w", "text_proj.w"):
            f = (1 - lrs[0] * wd) * (1 - lrs[1] * wd)
        elif name in ("image_proj.b", "text_proj.b"):
            f = 1.0
        else:
            continue
        assert _rel(t.detach().numpy(), p0[name].numpy() * f) < 1e-6, name
        assert not state["mu"][name].any() and not state["nu"][name].any()


def test_wd_mask_and_lr_scale_match_jax():
    """ndim_wd_mask name by name against jax.tree.map(np.ndim(l) >= 2) on
    JAX's trees (stacked trunk and PPAT blocks decay whole, LayerNorms
    included; the perceiver's, tokenizer's and heads' 1-D tensors do not),
    and trunk_lr_scale against JAX's."""
    _, p, _, model = _binds(40, skip=1, seed=12)
    jb, _ = JOS.baseline_bind_init(jax.random.PRNGKey(13), "PointBERT",
                                   out_channel=40, scaling=1)
    base = POS.BaselineBind("PointBERT", out_channel=40, scaling=1)
    for tree, m in ((p, model), (jb, base)):
        marks = jax.tree.map(
            lambda l: np.broadcast_to(np.ndim(l) >= 2, np.shape(l)), tree)
        want = {k: bool(v.reshape(-1)[0]) for k, v in flatten(marks).items()}
        assert POS.ndim_wd_mask(m) == want
    mask = POS.ndim_wd_mask(model)
    assert mask["backbone.trunk.blocks.1.ln_1.scale"]
    assert not mask["backbone.perceiver.layers.0.cross_ff.ln.scale"]
    assert mask["backbone.positional_embedding"]
    assert POS.ndim_wd_mask(base)["encoder.blocks.0.attn.ln.bias"]
    scales = jax.tree.map(lambda sc, l: np.broadcast_to(sc, np.shape(l)),
                          JOS.trunk_lr_scale(p), p)
    want = {k: v.reshape(-1)[0] for k, v in flatten(scales).items()}
    assert {k: np.float32(v) for k, v in POS.trunk_lr_scale(model).items()} == want
    assert sum(v == 0.1 for v in want.values()) > 0


# -- data and eval ------------------------------------------------------------------

def test_dataset_matches_jax(tmp_path):
    """OpenShapeTripletDataset from the same seed, item by item, bit for
    bit: clouds with and without rgb (0.4 grey), fewer and more points than
    npoints, train augmentation and eval."""
    rng = np.random.RandomState(14)
    files = []
    for i, n in enumerate((50, 90, 70)):
        blob = {"xyz": rng.randn(n, 3).astype(np.float32),
                "text_feat": rng.randn(1, 8).astype(np.float32),
                "img_feat": rng.randn(8).astype(np.float32)}
        if i != 1:
            blob["rgb"] = rng.rand(n, 3).astype(np.float32)
        files.append(str(tmp_path / f"o{i}.npy"))
        np.save(files[-1], blob)
    for augment in (True, False):
        want = JOS.OpenShapeTripletDataset(files, npoints=64, seed=3,
                                           augment=augment)
        got = POS.OpenShapeTripletDataset(files, npoints=64, seed=3,
                                          augment=augment)
        assert len(got) == 3
        for i in (0, 1, 2, 1):
            a, b = got[i], want[i]
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_precomputed_text_eval_matches_jax():
    rng = np.random.RandomState(15)
    pred, cls = rng.randn(20, 8), rng.randn(5, 8)
    labels = rng.randint(0, 5, 20)
    assert (POS.precomputed_text_eval(pred, labels, cls)
            == JOS.precomputed_text_eval(pred, labels, cls))


@pytest.mark.parametrize("args", [(), (512, 8)])
def test_vitlensG_tower_config_takes_jax_arguments(args):
    assert (dataclasses.asdict(POS.vitlensG_tower_config(*args))
            == dataclasses.asdict(JOS.vitlensG_tower_config(*args)))
