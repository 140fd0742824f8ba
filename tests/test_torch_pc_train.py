"""Point-cloud training on the CPU, held against the JAX package: the
batch-statistics BatchNorm, the PointBERT tokenizer in train mode (kernel 5
stays eval-only), and the published pc tri recipe's step (image, text and
visual towers locked, n_tower 3) at accum_freq 1 and 2 against JAX's
``make_train_step(...)(state, batch, fps_key)``; then the step's two traps:
the FPS starts are drawn once a micro-batch and shared by its cached and
grad passes, and the running statistics move once a micro-batch. Weights
are JAX's, copied with weights/from_jax.py; inputs come from numpy seeds;
FPS starts are JAX's own draws from its keys, given to the port; fp32
throughout, 1e-5 of each output's largest magnitude. The mini-PointNet's
ReLUs and max-pools are kinks that fp32 rounding can cross differently in
the two packages; _without_cancelled_biases says how the inputs keep clear
of them."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitlens_tpu.adapters import tokenizers as JT
from vitlens_tpu.config import PointAdapterConfig as JaxPointConfig
from vitlens_tpu.config import make_model_config as jax_model_config
from vitlens_tpu.models import tri as JTri
from vitlens_tpu.train import freeze as JF
from vitlens_tpu.train import step as JStep
from vitlens_tpu_torch import config as PC
from vitlens_tpu_torch.adapters import tokenizers as PT
from vitlens_tpu_torch.factory import make_trainable_
from vitlens_tpu_torch.models.tri import TriModel
from vitlens_tpu_torch.ops import fps as PFps
from vitlens_tpu_torch.train import freeze as PF
from vitlens_tpu_torch.train import step as PStep
from vitlens_tpu_torch.weights.from_jax import (flatten, load_params,
                                                load_state, load_tri_params,
                                                read_state)
from tests.test_torch_threads import share_cores

share_cores()

TRUNK = "ViT-Tiny-Test"
SMALL = dict(npoints=256, num_group=8, group_size=16)  # 8 groups of 16
RECIPE = dict(lock_image=True, lock_text=True, lock_visual=True)
LR = 1e-3


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1e-12, np.abs(want).max())


def _clouds(b, n, seed):
    return (np.random.RandomState(seed).randn(b, n, 3) * 0.3).astype(np.float32)


def _starts(key, b, n=SMALL["npoints"]):
    """JAX's FPS starts for a key: what fps_indices(key=key) draws."""
    return torch.from_numpy(np.array(jax.random.randint(key, (b,), 0, n)))


# -- train BatchNorm -------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 16), (2, 4, 8, 32)])
def test_train_batch_norm_matches_jax(shape):
    """BatchNorm(train=True) against tok.batch_norm(train=True): the output,
    the new running mean and var (momentum 0.1, unbiased var), and the
    gradients of the input, scale and bias, fp32, 1e-5 of max|ref|."""
    c = shape[-1]
    rng = np.random.RandomState(len(shape))
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    p = {"scale": jnp.asarray(1 + 0.2 * rng.randn(c), jnp.float32),
         "bias": jnp.asarray(0.1 * rng.randn(c), jnp.float32)}
    s = {"mean": jnp.asarray(0.2 * rng.randn(c), jnp.float32),
         "var": jnp.asarray(0.5 + rng.rand(c), jnp.float32)}
    cot = rng.randn(*shape).astype(np.float32)
    want, new_s = JT.batch_norm(jnp.asarray(x), p, s, train=True)
    _, vjp = jax.vjp(lambda x_, p_: JT.batch_norm(x_, p_, s, train=True)[0],
                     jnp.asarray(x), p)
    dx, dp = vjp(jnp.asarray(cot))

    bn = PT.BatchNorm(c)
    load_params(bn, p)
    load_state(bn, s)
    for t in bn.parameters():
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = bn(xt, train=True)
    got.backward(torch.from_numpy(cot))
    assert _rel(got.detach().numpy(), want) < 1e-5
    assert _rel(bn.mean.numpy(), new_s["mean"]) < 1e-5
    assert _rel(bn.var.numpy(), new_s["var"]) < 1e-5
    assert _rel(xt.grad.numpy(), dx) < 1e-5
    assert _rel(bn.scale.grad.numpy(), dp["scale"]) < 1e-5
    assert _rel(bn.bias.grad.numpy(), dp["bias"]) < 1e-5
    # eval leaves the statistics where they are; bf16 in, bf16 out
    mean = bn.mean.clone()
    assert bn(xt.detach().bfloat16()).dtype == torch.bfloat16
    assert bn(xt.detach().bfloat16(), train=True).dtype == torch.bfloat16
    assert bn.mean.dtype == torch.float32 and not torch.equal(bn.mean, mean)


# -- the tokenizer in train mode -----------------------------------------------

def _jax_tokenizer(seed):
    cfg = JaxPointConfig(**SMALL, knn_exact=True)
    p, s = jax.jit(JT.point_tokenizer_init, static_argnums=1)(
        jax.random.PRNGKey(seed), cfg)
    rng = np.random.RandomState(seed + 1)
    for bn, c in (("bn1", 128), ("bn2", 512)):
        p["encoder"][bn] = {"scale": jnp.asarray(1 + 0.2 * rng.randn(c), jnp.float32),
                            "bias": jnp.asarray(0.1 * rng.randn(c), jnp.float32)}
        s["encoder"][bn] = {"mean": jnp.asarray(0.2 * rng.randn(c), jnp.float32),
                            "var": jnp.asarray(0.5 + rng.rand(c), jnp.float32)}
    return cfg, _without_cancelled_biases(p), s


# The biases that a batch-statistics BatchNorm cancels: conv1's and conv3's
# feed one, conv2's shifts every row of conv3's input by one vector. In train
# mode they change no output and their gradient is zero in exact arithmetic.
CANCELLED = ("conv1", "conv2", "conv3")


def _without_cancelled_biases(p):
    """The tokenizer tree with the CANCELLED biases at 0: in train mode the
    same function, with less mean in each BatchNorm's input for the fp32
    var = E[x^2] - mean^2 to cancel. Each side's fp32 statistics differ from
    exact ones by rounding, and an entry within that distance of a kink (a
    ReLU input near 0, a max-pool's two largest values near a tie) can fall
    on different sides of it in the two runs and send its gradient another
    way: with the biases and 16 groups a cloud, JAX's tokenizer gradients
    read percents from a float64 evaluation of the same formula on some
    inputs, the port's on others. Without the biases, and at 8 groups of 16
    points a cloud, no entry of these inputs sits that close."""
    p = jax.tree.map(lambda x: x, p)
    for name in CANCELLED:
        p["encoder"][name]["b"] = jnp.zeros_like(p["encoder"][name]["b"])
    return p


def _port_tokenizer(p, s):
    tok = PT.PointTokenizer(PC.PointAdapterConfig(**SMALL))
    load_params(tok, p)
    load_state(tok, s)
    return tok


def test_point_tokenizer_train_matches_jax():
    """point_tokenizer_apply(train=True) with FPS from JAX's starts: tokens,
    pos, the new running statistics and the gradients of a fixed projection
    of the tokens and pos with respect to every parameter, fp32, 1e-5 of
    max|ref| (the CANCELLED biases, whose gradient is zero but for rounding,
    below 1e-5 of their product's weight gradient on both sides)."""
    cfg, p, s = _jax_tokenizer(seed=0)
    pts = _clouds(2, 256, seed=2)
    key = jax.random.PRNGKey(5)
    rng = np.random.RandomState(3)
    proj_t, proj_p = rng.randn(2, 2, 8, 384).astype(np.float32)

    def loss(params):
        (tokens, pos), new_s = JT.point_tokenizer_apply(
            params, s, jnp.asarray(pts), cfg, train=True, fps_key=key)
        return jnp.sum(tokens * proj_t) + jnp.sum(pos * proj_p), (tokens, pos, new_s)

    (_, (want_t, want_p, new_s)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(p)
    want_g = flatten(grads)
    tok = _port_tokenizer(p, s)
    for t in tok.parameters():
        t.requires_grad_(True)
    got_t, got_p = tok(torch.from_numpy(pts), train=True,
                       start=_starts(key, 2))
    ((got_t * torch.from_numpy(proj_t)).sum()
     + (got_p * torch.from_numpy(proj_p)).sum()).backward()
    assert _rel(got_t.detach().numpy(), want_t) < 1e-5
    assert _rel(got_p.detach().numpy(), want_p) < 1e-5
    got_s = flatten(read_state(tok, new_s))
    for name, w in flatten(new_s).items():
        assert _rel(got_s[name], w) < 1e-5, name
    for name, t in tok.named_parameters():
        if name.endswith(tuple(f"{c}.b" for c in CANCELLED)):
            scale = np.abs(want_g[name[:-1] + "w"]).max()
            assert np.abs(t.grad.numpy()).max() < 1e-5 * scale, name
            assert np.abs(want_g[name]).max() < 1e-5 * scale, name
        else:
            assert _rel(t.grad.numpy(), want_g[name]) < 1e-5, name


def test_point_encoder_kernel_is_eval_only(monkeypatch):
    """bf16 groups the kernel's gate takes go to ops.fused_point_encoder in
    eval and never in train, where the plain mini-PointNet runs with batch
    statistics, as JAX's kernel is eval-only."""
    _, p, s = _jax_tokenizer(seed=1)
    tok = _port_tokenizer(p, s).bfloat16()
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return PT.point_encoder_reference(*args)

    monkeypatch.setattr(PT, "fused_point_encoder", spy)
    pts = torch.from_numpy(_clouds(2, 256, seed=4)).bfloat16()
    start = torch.tensor([3, 7], dtype=torch.int32)
    tok(pts, start=start)
    assert calls == [(2, 8, 16, 3)]
    tokens, _ = tok(pts, train=True, start=start)
    assert len(calls) == 1 and tokens.dtype == torch.bfloat16


# -- the pc tri step -----------------------------------------------------------------

def _pc_models(seed=0):
    jcfg = jax_model_config(TRUNK, "pc",
                            point=JaxPointConfig(**SMALL, knn_exact=True))
    pcfg = PC.make_model_config(TRUNK, "pc", point=PC.PointAdapterConfig(**SMALL))
    params, state = JTri.tri_model_init(jax.random.PRNGKey(seed), jcfg)
    params["visual"]["adapter"] = _without_cancelled_biases(
        params["visual"]["adapter"])
    model = load_tri_params(TriModel(pcfg, device="cpu"), params)
    load_state(model, state)
    return jcfg, pcfg, params, state, model


def _batch(n, seed):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, 49000, size=(n, 77)).astype(np.int32)
    text[:, 0], text[:, -1] = 49406, 49407
    return {"text": text,
            "image": rng.randn(n, 3, 28, 28).astype(np.float32),
            "visual": _clouds(n, 256, seed + 100)}


def _jax_starts(key, b, accum):
    """The starts JAX's step draws from fps_key: the key itself at
    accum_freq 1, fold_in(key, i) for micro-batch i otherwise."""
    if accum == 1:
        return [_starts(key, b)]
    return [_starts(jax.random.fold_in(key, i), b // accum) for i in range(accum)]


def _step(accum):
    """One step of the pc tri recipe in both packages from the same
    weights, batch and FPS starts. Returns (JAX TrainState, port model,
    mask, (JAX metrics, port metrics), the port's parameters before)."""
    jcfg, pcfg, params, state, model = _pc_models(seed=accum)
    ocfg = dict(lr=LR, eps=1e-4, warmup=2, total_steps=10)
    jmask = JF.tri_model_mask(params, jcfg, **RECIPE)
    jtx, jmask = JStep.make_optimizer(params, JStep.OptimizerConfig(**ocfg), jmask)
    jstep = JStep.make_train_step(jcfg, jtx, jmask, JStep.StepConfig(
        n_tower=3, accum_freq=accum, local_loss=False, sync_bn=False,
        compute_dtype=jnp.float32), mesh=None)
    ts = JStep.init_train_state(params, state, jtx)
    mask = PF.tri_model_mask(model, pcfg, **RECIPE)
    tx, mask = PStep.make_optimizer(model, PStep.OptimizerConfig(**ocfg), mask)
    make_trainable_(model, mask, torch.float32)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    pstate = PStep.init_train_state(model, tx)
    pstep = PStep.make_train_step(pcfg, tx, mask, PStep.StepConfig(
        n_tower=3, accum_freq=accum, compute_dtype=torch.float32))
    batch = _batch(4, seed=30)
    key = jax.random.PRNGKey(40)
    ts, jm = jstep(ts, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    pstate, pm = pstep(pstate, batch, fps_starts=_jax_starts(key, 4, accum))
    return ts, model, mask, (jm, pm), init


@pytest.mark.parametrize("accum", [1, 2])
def test_pc_tri_step_matches_jax(accum):
    """A step of the pc tri recipe (lock image, text and visual: the
    tokenizer and the Lens train) against JAX's step with fps_key, the port
    given JAX's starts: loss, grad_norm and logit_scale; every trainable
    parameter (1e-5 relative, 1e-6 absolute) and the BatchNorm running
    statistics (the model_state) after it; frozen parameters bit-identical.
    The CANCELLED biases (at 0, their gradient zero but for rounding) move
    by Adam's lr * g / (|g| + eps) for rounding-sized g on both sides: each
    is held below 1e-2 of the learning rate. One step: after it the
    parameters differ by ~1e-6, enough to move a near-tied max-pool winner
    in the next forward."""
    ts, model, mask, (jm, pm), init = _step(accum)
    for k in ("loss", "grad_norm", "logit_scale"):
        assert _rel(pm[k].numpy(), jm[k]) < 1e-5, k
    want = flatten(ts.params)
    n_trained = 0
    for name, p in model.named_parameters():
        if mask[name] and name.endswith(tuple(f"{c}.b" for c in CANCELLED)):
            assert max(np.abs(want[name]).max(),
                       p.abs().max().item()) < 1e-2 * LR, name
            n_trained += 1
        elif mask[name]:
            np.testing.assert_allclose(p.detach().numpy(), want[name],
                                       rtol=1e-5, atol=1e-6, err_msg=name)
            assert not torch.equal(p, init[name]), name
            n_trained += 1
        else:
            assert torch.equal(p, init[name]), name
    assert n_trained == sum(mask.values()) > 0
    assert mask["visual.adapter.encoder.conv1.w"]
    assert not mask["visual.trunk.blocks.0.mlp.fc.w"]
    got_s = flatten(read_state(model, ts.model_state))
    want_s = flatten(ts.model_state)
    assert sorted(got_s) == sorted(want_s) and len(want_s) == 4
    for name, w in want_s.items():
        assert _rel(got_s[name], w) < 1e-5, name


def _recording(monkeypatch):
    """Records the starts of every FPS call and each BatchNorm's running
    mean after every train-mode call."""
    starts, means = [], []
    fps_indices = PFps.fps_indices

    def fps_spy(xyz, npoint, start=None, generator=None):
        idx = fps_indices(xyz, npoint, start=start, generator=generator)
        starts.append(idx[:, 0].clone())
        return idx

    forward = PT.BatchNorm.forward

    def bn_spy(self, x, train=False):
        y = forward(self, x, train)
        if train and self.mean.numel() == 128:
            means.append(self.mean.clone())
        return y

    monkeypatch.setattr(PFps, "fps_indices", fps_spy)
    monkeypatch.setattr(PT.BatchNorm, "forward", bn_spy)
    return starts, means


@pytest.mark.parametrize("accum", [1, 2])
def test_pc_step_draws_starts_once_a_micro_batch(monkeypatch, accum):
    """With a generator, the step draws one start a cloud for each
    micro-batch, once: the generator moves by exactly those draws, and the
    cached pass and the grad pass of micro-batch i start FPS at the same
    points (JAX folds one fps_key for both)."""
    _, pcfg, params, _, model = _pc_models(seed=3)
    mask = PF.tri_model_mask(model, pcfg, **RECIPE)
    tx, mask = PStep.make_optimizer(model, PStep.OptimizerConfig(), mask)
    make_trainable_(model, mask, torch.float32)
    step = PStep.make_train_step(pcfg, tx, mask, PStep.StepConfig(
        n_tower=3, accum_freq=accum, compute_dtype=torch.float32))
    starts, _ = _recording(monkeypatch)
    g = torch.Generator().manual_seed(9)
    step(PStep.init_train_state(model, tx), _batch(4, seed=50),
         fps_generator=g)
    same = torch.Generator().manual_seed(9)
    drawn = [torch.randint(0, 256, (4 // accum,), generator=same,
                           dtype=torch.int32) for _ in range(accum)]
    assert torch.equal(torch.randint(0, 256, (8,), generator=g),
                       torch.randint(0, 256, (8,), generator=same))
    want = drawn if accum == 1 else drawn + drawn  # cached passes, then grad
    assert len(starts) == len(want)
    for got, w in zip(starts, want):
        assert torch.equal(got, w)


def test_pc_step_moves_running_stats_once_a_micro_batch(monkeypatch):
    """At accum_freq 2 the tokenizer's BatchNorms run 4 times in train mode
    (2 cached passes, 2 grad passes), but the running statistics after the
    step are those of the 2 cached passes: the grad passes' updates are
    dropped, as JAX drops the state of its grad pass."""
    _, pcfg, params, _, model = _pc_models(seed=4)
    mask = PF.tri_model_mask(model, pcfg, **RECIPE)
    tx, mask = PStep.make_optimizer(model, PStep.OptimizerConfig(), mask)
    make_trainable_(model, mask, torch.float32)
    step = PStep.make_train_step(pcfg, tx, mask, PStep.StepConfig(
        n_tower=3, accum_freq=2, compute_dtype=torch.float32))
    _, means = _recording(monkeypatch)
    bn1 = model.visual.adapter.encoder.bn1
    before = bn1.mean.clone()
    step(PStep.init_train_state(model, tx), _batch(4, seed=60),
         fps_starts=[torch.tensor([1, 2]), torch.tensor([3, 4])])
    assert len(means) == 4
    assert not torch.equal(means[0], before)
    assert not torch.equal(means[1], means[0])
    assert torch.equal(bn1.mean, means[1])
    assert not torch.equal(bn1.mean, means[3])
