"""The port's training path on CPU in fp32, held against the JAX package:
losses, masks, schedules, trainable sets and three steps of
make_train_step from the same weights and batches, on a tiny audio config
(2 trunk layers, width 32, an 8-patch fbank)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitlens_tpu import config as JC
from vitlens_tpu.models import tri as JT
from vitlens_tpu.train import freeze as JF
from vitlens_tpu.train import losses as JLs
from vitlens_tpu.train import schedules as JS
from vitlens_tpu.train import step as JStep
from vitlens_tpu_torch import config as PC
from vitlens_tpu_torch.factory import make_trainable_
from vitlens_tpu_torch.models.tri import TriModel
from vitlens_tpu_torch.train import freeze as PF
from vitlens_tpu_torch.train import losses as PLs
from vitlens_tpu_torch.train import schedules as PS
from vitlens_tpu_torch.train import step as PStep
from vitlens_tpu_torch.weights.from_jax import flatten, load_tri_params
from tests.test_torch_threads import share_cores

share_cores()


def _tiny(C):
    arch = C.VisionArch(image_size=28, patch_size=14, width=32, layers=2,
                        head_width=16)
    tower = C.TowerConfig(
        arch=arch, embed_dim=16, modality="audio",
        audio=C.AudioAdapterConfig(mel_bins=32, target_length=48),
        perceiver=C.PerceiverConfig(
            depth=1, num_latents=4, latent_dim=32, input_dim=32, cross_heads=1,
            cross_dim_head=8, latent_heads=2, latent_dim_head=16,
            self_per_cross_attn=1))
    return C.ModelConfig(name="tiny", embed_dim=16, vision=arch, tower=tower,
                         text=C.TextArch(context_length=8, vocab_size=50,
                                         width=32, heads=2, layers=2))


def _batch(n, seed):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, 40, size=(n, 8)).astype(np.int32)
    text[:, -1] = 49  # the highest id is the EOT pooling position
    return {"text": text,
            "visual": rng.randn(n, 48, 32).astype(np.float32),
            "label": rng.randint(0, 3, size=n).astype(np.int32)}


@pytest.fixture(scope="module")
def tiny():
    jcfg = _tiny(JC)
    params, state = JT.tri_model_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, _tiny(PC), params, state


def _port_model(pcfg, params):
    return load_tri_params(TriModel(pcfg, device="cpu"), params)


def _per_param(mask, params):
    """A JAX mask tree as {port name: trainable}: broadcast to the leaves'
    shapes, so that the stacked trunk's rows fall to their blocks."""
    full = jax.tree.map(lambda m, p: np.broadcast_to(np.asarray(m), p.shape),
                        mask, params)
    return {k: bool(np.any(v)) for k, v in flatten(full).items()}


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(
        1e-12, np.abs(want).max())


# -- losses and masks --------------------------------------------------------

def _feats(n=6, d=16, seed=0):
    rng = np.random.RandomState(seed)
    f = rng.randn(3, n, d).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


def test_losses_match_jax():
    """fp32, 1e-6 relative."""
    x, y, z = _feats()
    scale = np.float32(14.3)
    labels = np.array([0, 1, 0, 2, 1, 1], np.int32)
    t = torch.from_numpy
    cases = [
        (JLs.clip_loss(x, y, scale), PLs.clip_loss(t(x), t(y), torch.tensor(scale))),
        (JLs.tri_clip_loss(x, y, z, scale),
         PLs.tri_clip_loss(t(x), t(y), t(z), torch.tensor(scale))),
        (JLs.cross_entropy(x @ y.T, np.arange(6)),
         PLs.cross_entropy(t(x @ y.T), torch.arange(6))),
        (JLs.caption_loss(x, labels % 2 * np.arange(6) % 16, pad_id=0),
         PLs.caption_loss(t(x), torch.from_numpy(labels % 2 * np.arange(6) % 16).long(),
                          pad_id=0)),
    ]
    jc, jd = JLs.distill_clip_loss(x, y, scale, z, x, np.float32(10.0))
    pc, pd = PLs.distill_clip_loss(t(x), t(y), torch.tensor(scale), t(z), t(x),
                                   torch.tensor(10.0))
    cases += [(jc, pc), (jd, pd)]
    for want, got in cases:
        assert _rel(got.numpy(), want) < 1e-6
    np.testing.assert_array_equal(
        PLs.label_mask(t(labels), t(labels)).numpy(),
        np.asarray(JLs.label_mask(jnp.asarray(labels), jnp.asarray(labels))))
    np.testing.assert_array_equal(PLs.sim_mask(t(x), 0.2).numpy(),
                                  np.asarray(JLs.sim_mask(x, 0.2)))


@pytest.mark.parametrize("n_tower,kind", [(2, "general"), (2, "label_mask"),
                                          (2, "sim_mask"), (3, "general"),
                                          (3, "label_mask"), (3, "sim_mask")])
def test_make_loss_fn_matches_jax(n_tower, kind):
    x, y, z = _feats(seed=1)
    labels = np.array([0, 1, 0, 2, 1, 1], np.int32)
    keys = (("anchor_features", "visual_features") if n_tower == 2
            else ("image_features", "text_features", "visual_features"))
    feats = dict(zip(keys, (x, y, z)))
    want = JLs.make_loss_fn(n_tower, kind, sim_thres=0.1)(
        {**feats, "logit_scale": np.float32(14.3)}, jnp.asarray(labels))
    got = PLs.make_loss_fn(n_tower, kind, sim_thres=0.1)(
        {**{k: torch.from_numpy(v) for k, v in feats.items()},
         "logit_scale": torch.tensor(14.3)}, torch.from_numpy(labels))
    assert _rel(got.numpy(), want) < 1e-6


def test_loss_fn_rejects_unported_and_unknown():
    """Every loss of the JAX package is ported: only an unknown name raises."""
    for n_tower in (2, 3):
        with pytest.raises(ValueError, match="unknown"):
            PLs.make_loss_fn(n_tower, "bogus")


@pytest.mark.parametrize("name,kw", [
    ("cosine", {}), ("const", {}),
    ("const-cooldown", dict(cooldown_steps=30, cooldown_power=2.0,
                            cooldown_end_lr=1e-5))])
def test_schedules_match_jax(name, kw):
    """A grid of steps through warmup, the body and the cooldown; 1e-6
    relative, or 1e-6 of the base lr absolute where the cosine nears 0 (JAX
    computes in fp32, the port in float64)."""
    want = JS.get_schedule(name, 5e-4, 10, 100, **kw)
    got = PS.get_schedule(name, 5e-4, 10, 100, **kw)
    for s in (0, 1, 5, 9, 10, 11, 37, 69, 70, 71, 85, 99):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6, atol=5e-10)
    with pytest.raises(ValueError):
        PS.get_schedule("linear", 5e-4, 10, 100)


@pytest.mark.parametrize("kw", [
    dict(), dict(lock_visual=False), dict(unlock_cls=True),
    dict(unlock_pos_emb=True, lock_text=False, train_logit_scale=False),
    dict(visual_unlocked_groups=1), dict(visual_unlocked_groups=3),
    dict(visual_unlocked_groups=2, unlock_from_head=True),
    dict(visual_unlocked_groups=4, unlock_from_head=True),
    dict(unlock_trans_first_n_layers=1),
    dict(unlock_trans_first_n_layers=5, unlock_cls=True)])
def test_trainable_sets_match_jax(tiny, kw):
    """Per-parameter trainability and count_trainable equal the JAX mask's
    (its stacked-trunk rows taken per block), for each lock/unlock flag."""
    jcfg, pcfg, params, _ = tiny
    jmask = JF.tri_model_mask(params, jcfg, lock_image=True, **kw)
    want = _per_param(jmask, params)
    model = _port_model(pcfg, params)
    got = PF.tri_model_mask(model, pcfg, **kw)
    assert got == want
    assert PF.count_trainable(model, got) == JF.count_trainable(params, jmask)


def test_wd_mask_matches_jax(tiny):
    _, pcfg, params, _ = tiny
    want = _per_param(JStep.wd_mask(params), params)
    assert PStep.wd_mask(_port_model(pcfg, params)) == want


# -- the train step ------------------------------------------------------------

STEP_CASES = [
    # (accum_freq, remat, grad_clip_norm, extra unlock flags): each value of
    # each setting at least once (the JAX step compiles anew for each case)
    (1, False, None, {}),
    (1, True, 1e-3, dict(unlock_trans_first_n_layers=1)),
    (2, False, 1e-3, {}),
]


@pytest.mark.parametrize("accum,remat,clip,unlock", STEP_CASES)
def test_train_step_matches_jax(tiny, accum, remat, clip, unlock):
    """Three steps from the same weights and batches, the published audio
    recipe's mask (visual and text locked, CLS unlocked; plus the first trunk
    block in one case, so that the fused MLP's and attention's weight
    gradients are held too). fp32. Loss, grad_norm and logit_scale to 1e-5
    relative; every trainable parameter to 1e-5 relative with 1e-6 absolute
    (a thousandth of one update at lr 1e-3); the frozen ones bit-identical.
    Adam's eps is 1e-4 here, not 1e-6: Adam divides by sqrt(nu), and the key
    bias of attention has a gradient that is zero in exact arithmetic (the
    softmax ignores a constant per row), so with a tiny eps both frameworks
    step it by their own fp32 summation noise scaled up to ~lr."""
    jcfg, pcfg, params, state = tiny
    flags = dict(lock_text=True, lock_visual=True, unlock_cls=True, **unlock)
    ocfg = dict(lr=1e-3, eps=1e-4, warmup=2, total_steps=10,
                grad_clip_norm=clip)
    jmask = JF.tri_model_mask(params, jcfg, lock_image=True, **flags)
    jtx, jmask = JStep.make_optimizer(params, JStep.OptimizerConfig(**ocfg), jmask)
    jstep = JStep.make_train_step(
        jcfg, jtx, jmask, JStep.StepConfig(
            n_tower=2, align_to="text", local_loss=False, sync_bn=False,
            accum_freq=accum, remat=remat, compute_dtype=jnp.float32), mesh=None)
    ts = JStep.init_train_state(params, state, jtx)

    model = _port_model(pcfg, params)
    mask = PF.tri_model_mask(model, pcfg, **flags)
    tx, mask = PStep.make_optimizer(model, PStep.OptimizerConfig(**ocfg), mask)
    make_trainable_(model, mask, torch.float32)
    frozen0 = {n: p.detach().clone() for n, p in model.named_parameters()
               if not mask[n]}
    pstate = PStep.init_train_state(model, tx)
    pstep = PStep.make_train_step(pcfg, tx, mask, PStep.StepConfig(
        n_tower=2, align_to="text", accum_freq=accum, remat=remat,
        compute_dtype=torch.float32))

    for i in range(3):
        batch = _batch(4, seed=10 + i)
        ts, jm = jstep(ts, {k: jnp.asarray(v) for k, v in batch.items()}, None)
        pstate, pm = pstep(pstate, batch)
        for k in ("loss", "grad_norm", "logit_scale"):
            assert _rel(pm[k].numpy(), jm[k]) < 1e-5, (i, k)
    assert pstate.step == 3
    want = flatten(ts.params)
    n_trained = 0
    for name, p in model.named_parameters():
        if mask[name]:
            np.testing.assert_allclose(p.detach().numpy(), want[name],
                                       rtol=1e-5, atol=1e-6, err_msg=name)
            n_trained += 1
        else:
            assert torch.equal(p, frozen0[name]), name
    assert n_trained == sum(mask.values()) > 0


def test_train_step_refuses_the_unported(tiny):
    """What still raises: an unknown partition style (FSDP without a mesh
    is the one-device step, as in JAX; over ranks: tests/
    test_torch_fsdp.py), a mesh that is not the port's (the data-parallel
    step runs over parallel.mesh.Mesh: tests/test_torch_parallel.py), an
    unknown remat tag, a mask that was never applied and a trainable
    parameter that is no fp32 master.
    Point-cloud training, train-time patch dropout and the "dots" remat,
    which raised here too, run: a train pass moves the tokenizer's running
    statistics, a dropping tower keeps CLS and the drawn patches, "dots"
    recomputes the block as full remat does."""
    jcfg, pcfg, params, _ = tiny
    model = _port_model(pcfg, params)
    mask = PF.tri_model_mask(model, pcfg, unlock_cls=True)
    tx, mask = PStep.make_optimizer(model, PStep.OptimizerConfig(), mask)
    two = PStep.StepConfig(n_tower=2, align_to="text")
    with pytest.raises(TypeError, match="Mesh"):
        PStep.make_train_step(pcfg, tx, mask, two, mesh=object())
    with pytest.raises(ValueError, match="unknown partition"):
        PStep.make_train_step(pcfg, tx, mask, two, partition="zero")
    assert callable(PStep.make_train_step(pcfg, tx, mask, two, partition="fsdp"))
    pc = TriModel(PC.make_model_config("ViT-Tiny-Test", "pc"), device="cpu")
    pc.init_(torch.Generator().manual_seed(0))
    feats = pc.visual(torch.randn(2, 64, 3), train=True)
    assert torch.isfinite(feats).all()
    assert pc.visual.adapter.encoder.bn1.mean.abs().max() > 0
    dropping = PC.replace(pcfg, tower=PC.replace(pcfg.tower, patch_dropout=0.5))
    tower = TriModel(dropping, device="cpu").visual
    tower.init_(torch.Generator().manual_seed(0))
    from vitlens_tpu_torch.models.vit import draw_patch_keep

    keep = draw_patch_keep(dropping.tower, 1, torch.Generator().manual_seed(1))
    assert keep.shape == (1, max(1, int(dropping.tower.num_tokens * 0.5)))
    assert torch.isfinite(tower(torch.zeros(1, 48, 32), train=True,
                                patch_keep=keep)).all()
    with pytest.raises(ValueError, match="make_trainable_"):
        PStep.init_train_state(model, tx)  # the mask was never applied
    with pytest.raises(ValueError, match="unknown remat"):
        model.visual.trunk(torch.zeros(1, 5, 32), remat="everything")
    x = torch.randn(1, 5, 32)
    assert torch.equal(model.visual.trunk(x, remat="dots"), model.visual.trunk(x))
    half = copy.deepcopy(model)
    half.visual.proj.data = half.visual.proj.data.bfloat16()
    with pytest.raises(ValueError, match="fp32"):
        make_trainable_(half, mask, torch.bfloat16)


def test_make_trainable_keeps_masters_and_casts_frozen(tiny):
    _, pcfg, params, _ = tiny
    model = _port_model(pcfg, params)
    mask = PF.tri_model_mask(model, pcfg, unlock_cls=True,
                             unlock_trans_first_n_layers=1)
    make_trainable_(model, mask, torch.bfloat16)
    blocks = model.visual.trunk.blocks
    assert blocks[0].mlp.fc.w.dtype == torch.float32 and blocks[0].mlp.fc.w.requires_grad
    assert blocks[1].mlp.fc.w.dtype == torch.bfloat16
    assert not blocks[1].mlp.fc.w.requires_grad
    assert model.visual.perceiver.layers[0].cross_attn.attn.to_q.w.dtype == torch.float32
    assert model.text.trunk.blocks[0].attn.qkv_w.dtype == torch.bfloat16
    assert model.visual.class_embedding.requires_grad
    assert blocks[1].ln_1.scale.dtype == torch.float32  # never cast
