"""Train-time patch dropout and the "dots" remat of the port, on the CPU in
fp32, held against the JAX package on the tiny audio config of
test_torch_train.py (2 trunk layers, width 32, a 4-latent perceiver).

Patch dropout: the apply with JAX's kept indices gives JAX's tower output
(fps_key given, train=True); the port's draw has the right count, no repeat,
and CLS kept; the step draws it once a micro-batch from its generator.
Remat: "dots" gives the gradients of no remat; under a dispatch log, its
backward recomputes no 2-D product (its mm/addmm count is no remat's) where
full remat recomputes them all."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vitlens_tpu import config as JC
from vitlens_tpu.models import tri as JT
from vitlens_tpu.models.vit import vision_tower_apply
from vitlens_tpu_torch import config as PC
from vitlens_tpu_torch.models import layers as PL
from vitlens_tpu_torch.models import tri as PT
from vitlens_tpu_torch.models.tri import TriModel
from vitlens_tpu_torch.models.vit import apply_patch_dropout, draw_patch_keep
from vitlens_tpu_torch.train import step as PStep
from vitlens_tpu_torch.weights.from_jax import load_tri_params

from test_torch_train import _batch, _tiny


def _models(prob):
    jcfg, pcfg = _tiny(JC), _tiny(PC)
    jcfg = dataclasses.replace(jcfg, tower=dataclasses.replace(
        jcfg.tower, patch_dropout=prob))
    pcfg = dataclasses.replace(pcfg, tower=dataclasses.replace(
        pcfg.tower, patch_dropout=prob))
    params, state = JT.tri_model_init(jax.random.PRNGKey(0), jcfg)
    model = load_tri_params(TriModel(pcfg, device="cpu"), params)
    return jcfg, params, state, model


@pytest.mark.parametrize("prob", [0.25, 0.5, 0.9])
def test_patch_dropout_apply_matches_jax(prob):
    """The port's tower, given the indices JAX draws from fps_key
    (fold_in(key, 17), normal, top_k), equals JAX's train-time tower output
    with that key (fp32, 1e-5)."""
    jcfg, params, state, model = _models(prob)
    x = _batch(3, 0)["visual"]
    key = jax.random.PRNGKey(7)
    want, _ = vision_tower_apply(params["visual"], state["visual"],
                                 jnp.asarray(x), jcfg.tower, train=True,
                                 fps_key=key)
    n = jcfg.tower.num_tokens
    keep = max(1, int(n * (1.0 - prob)))
    rand = jax.random.normal(jax.random.fold_in(key, 17), (3, n))
    idx = np.array(jax.lax.top_k(rand, keep)[1])
    got = model.visual(torch.from_numpy(x), train=True,
                       patch_keep=torch.from_numpy(idx))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    # and without train, or without indices, nothing is dropped
    full = model.visual(torch.from_numpy(x), train=False,
                        patch_keep=torch.from_numpy(idx))
    want_full, _ = vision_tower_apply(params["visual"], state["visual"],
                                      jnp.asarray(x), jcfg.tower, train=False)
    np.testing.assert_allclose(full.detach().numpy(), np.asarray(want_full),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("prob,n", [(0.5, 4), (0.9, 4), (0.3, 257), (0.99, 50)])
def test_patch_dropout_draw(prob, n):
    """keep = max(1, int(n * (1 - prob))) distinct indices in [0, n) per
    sample, the same draw for the same generator seed; the apply keeps CLS
    first and gathers the patches in the drawn order."""
    cfg = dataclasses.replace(_tiny(PC).tower, patch_dropout=prob)
    cfg = dataclasses.replace(cfg, perceiver=dataclasses.replace(
        cfg.perceiver, num_latents=n))
    g = torch.Generator().manual_seed(3)
    idx = draw_patch_keep(cfg, 5, g)
    keep = max(1, int(n * (1.0 - prob)))
    assert idx.shape == (5, keep)
    assert int(idx.min()) >= 0 and int(idx.max()) < n
    for row in idx.tolist():
        assert len(set(row)) == keep
    again = draw_patch_keep(cfg, 5, torch.Generator().manual_seed(3))
    assert torch.equal(idx, again)
    h = torch.arange(5 * (n + 1) * 2, dtype=torch.float32).reshape(5, n + 1, 2)
    out = apply_patch_dropout(h, idx)
    assert out.shape == (5, keep + 1, 2)
    assert torch.equal(out[:, 0], h[:, 0])
    for b in range(5):
        assert torch.equal(out[b, 1:], h[b, 1 + idx[b]])


def _trainable(model):
    from vitlens_tpu_torch.train.freeze import apply_mask, tri_model_mask

    mask = tri_model_mask(model, model.cfg, lock_visual=True, lock_text=True,
                          unlock_cls=True)
    apply_mask(model, mask)
    return mask


def test_step_draws_patch_dropout_per_micro_batch():
    """With a generator, the step draws one set of kept patches a
    micro-batch ([B / accum_freq, keep], the same for the same seed) and the
    loss differs from the step without; no draw without a generator or for
    the video distill step (JAX gives that forward no fps_key)."""
    _, _, _, model = _models(0.5)
    mask = _trainable(model)
    batch = {k: torch.from_numpy(v) for k, v in _batch(4, 1).items()}
    batch["text"] = batch["text"].long()
    sc = PStep.StepConfig(n_tower=2, align_to="text", accum_freq=2,
                          compute_dtype=torch.float32)
    params = {n: p for n, p in model.named_parameters() if mask[n]}
    from vitlens_tpu_torch.train.losses import make_loss_fn

    loss_fn = make_loss_fn(2)
    g = torch.Generator().manual_seed(11)
    keeps = PStep.draw_patch_keeps(model, batch, sc, g)
    assert len(keeps) == 2 and keeps[0].shape == (2, 2)
    l1, g1 = PStep.accum_grads(model, batch, sc, params, loss_fn, None, keeps)
    # the same draws again from a generator of the same seed
    keeps2 = PStep.draw_patch_keeps(model, batch, sc,
                                    torch.Generator().manual_seed(11))
    assert all(torch.equal(a, b) for a, b in zip(keeps, keeps2))
    l0, _ = PStep.accum_grads(model, batch, sc, params, loss_fn)
    assert float(l0) != float(l1)
    no_draw = PStep.draw_patch_keeps(model, batch, dataclasses.replace(
        sc, video_distill=True, contra_loss_type="distill_token"), g)
    assert no_draw is None and PStep.draw_patch_keeps(model, batch, sc, None) is None
    assert all(torch.isfinite(v).all() for v in g1.values())


class _Log(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def _grads_and_ops(remat):
    jcfg, params, state, model = _models(0.0)
    mask = _trainable(model)
    # train the trunk too, so that its products have weight gradients
    for n, p in model.named_parameters():
        if n.startswith("visual.trunk."):
            p.requires_grad_(True)
            mask[n] = True
    x = torch.from_numpy(_batch(3, 2)["visual"])
    feats = PT.encode_visual(model, x, train=True, remat=remat,
                             compute_dtype=torch.float32)
    loss = (feats * torch.linspace(-1, 1, feats.shape[-1])).sum()
    names = [n for n, t in mask.items() if t and n.startswith("visual.")]
    ps = [dict(model.named_parameters())[n] for n in names]
    log = _Log()
    with log:
        got = torch.autograd.grad(loss, ps)
    prods = sum(op in PL._2D_PRODUCTS for op in log.ops)
    return dict(zip(names, got)), prods


def test_dots_remat_gradients_equal_no_remat():
    """remat="dots" (and full remat) give the gradients of no remat (fp32,
    1e-6 relative)."""
    want, _ = _grads_and_ops(False)
    for remat in ("dots", True):
        got, _ = _grads_and_ops(remat)
        for n, w in want.items():
            err = (got[n] - w).abs().max() / w.abs().max().clamp_min(1e-12)
            assert float(err) <= 1e-6, (remat, n, float(err))


def test_dots_remat_recomputes_no_2d_product():
    """Under a dispatch log of the backward pass: with "dots" the count of
    mm/addmm (the gradient products) is no remat's, as the saved products
    are replayed; full remat adds the recomputed forward's: 3 a block, as
    non-reentrant checkpointing stops recomputing once it has every tensor
    the backward needs (the MLP's out-projection output is none of them)."""
    _, none = _grads_and_ops(False)
    _, dots = _grads_and_ops("dots")
    _, full = _grads_and_ops(True)
    layers = _tiny(PC).tower.arch.layers
    assert dots == none
    assert full == none + 3 * layers


@pytest.mark.parametrize("remat,want", [(False, None), (None, None),
                                        (True, "full"), ("full", "full"),
                                        ("nocse", "full"), ("dots", "dots"),
                                        ("dots_nocse", "dots")])
def test_remat_policy_tags(remat, want):
    assert PL.remat_policy(remat) == want


def test_remat_policy_rejects_unknown_tags():
    with pytest.raises(ValueError, match="unknown remat"):
        PL.remat_policy("everything")
