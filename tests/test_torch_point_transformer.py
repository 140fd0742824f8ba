"""The PointBERT classifier (models/point_transformer.py) and the
PointPerceiver head (models/perceiver.py) on the CPU, held against the JAX
package: the forward in eval and train mode (with and without the CLS/max
concat and the projection), positions re-added before every block, the
reference-layout converter against JAX's (qkv with and without bias),
``label_smoothing_loss`` and ``point_perceiver_apply``. Parameters and the
tokenizer's BatchNorm statistics are JAX's, copied with
weights/from_jax.py; inputs come from numpy seeds; FPS starts are JAX's
draws from its key; fp32 outputs agree to 1e-5 of their largest magnitude.
Tiny widths: 8 groups of 16 points, width 64, 2 blocks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import reference_layout as RL
from vitlens_tpu.config import PerceiverConfig as JaxPerceiverConfig
from vitlens_tpu.config import PointAdapterConfig as JaxPointConfig
from vitlens_tpu.models import perceiver as JP
from vitlens_tpu.models import point_transformer as JPT
from vitlens_tpu_torch.config import PerceiverConfig, PointAdapterConfig
from vitlens_tpu_torch.models import point_transformer as PPT
from vitlens_tpu_torch.models.perceiver import PointPerceiver
from vitlens_tpu_torch.weights.from_jax import (flatten, load_params,
                                                load_state, read_state)
from tests.test_torch_threads import share_cores

share_cores()

POINT = dict(npoints=256, num_group=8, group_size=16, encoder_dims=64,
             trans_dim=64)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1e-12, np.abs(want).max())


def _cfgs(**kw):
    kw = dict(dict(depth=2, num_heads=2, output_dim=32), **kw)
    j = JPT.PointTransformerConfig(point=JaxPointConfig(**POINT, knn_exact=True),
                                   **kw)
    return j, PPT.PointTransformerConfig(point=PointAdapterConfig(**POINT), **kw)


def _random_state(p, s, seed):
    """Random BatchNorm parameters and statistics in the tokenizer, and a
    random CLS token (JAX initialises it to zeros)."""
    rng = np.random.RandomState(seed)
    p, s = jax.tree.map(lambda x: x, p), jax.tree.map(lambda x: x, s)
    for bn in ("bn1", "bn2"):
        c = p["tokenizer"]["encoder"][bn]["scale"].shape[0]
        p["tokenizer"]["encoder"][bn] = {
            "scale": jnp.asarray(1 + 0.2 * rng.randn(c), jnp.float32),
            "bias": jnp.asarray(0.1 * rng.randn(c), jnp.float32)}
        s["tokenizer"]["encoder"][bn] = {
            "mean": jnp.asarray(0.2 * rng.randn(c), jnp.float32),
            "var": jnp.asarray(0.5 + rng.rand(c), jnp.float32)}
    p["cls_token"] = jnp.asarray(rng.randn(POINT["trans_dim"]), jnp.float32)
    return p, s


def _clouds(b, seed):
    return (np.random.RandomState(seed).randn(b, POINT["npoints"], 3)
            * 0.3).astype(np.float32)


def _port(cfg, p, s):
    model = PPT.PointTransformer(cfg)
    load_params(model, p)
    load_state(model, s)
    return model


@pytest.mark.parametrize("train,kw", [
    (False, {}), (True, {}), (False, dict(do_cat=False, output_dim=None))])
def test_point_transformer_matches_jax(train, kw):
    """Features of point_transformer_apply, fp32; in train mode the
    tokenizer's BatchNorms use batch statistics and their new running
    statistics agree too."""
    jcfg, pcfg = _cfgs(**kw)
    p, s = _random_state(*JPT.point_transformer_init(jax.random.PRNGKey(1),
                                                     jcfg), seed=2)
    x = _clouds(3, seed=3)
    key = jax.random.PRNGKey(4)
    want, new_s = jax.jit(lambda p_, s_, x_: JPT.point_transformer_apply(
        p_, s_, x_, jcfg, train=train, fps_key=key))(p, s, jnp.asarray(x))
    model = _port(pcfg, p, s)
    starts = torch.from_numpy(np.array(jax.random.randint(key, (3,), 0, 256)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=train, fps_start=starts)
    dim = kw.get("output_dim", 32) or 64
    assert tuple(got.shape) == (3, dim)
    assert _rel(got.numpy(), want) < 1e-5
    got_s = flatten(read_state(model, new_s))
    for name, w in flatten(new_s).items():
        assert _rel(got_s[name], w) < 1e-5, name


def test_positions_are_readded_before_every_block():
    """The second block's input is the first block's output plus [cls_pos;
    pos] again (the reference's TransformerEncoder: x = block(x + pos))."""
    _, pcfg = _cfgs()
    model = PPT.PointTransformer(pcfg)
    model.init_(torch.Generator().manual_seed(5))
    x = torch.from_numpy(_clouds(2, seed=6))
    with torch.no_grad():
        want = model(x)
        blocks = model.blocks.blocks
        calls = []
        for b in blocks:
            b.register_forward_pre_hook(lambda m, args: calls.append(args[0]))
        model(x)
    assert len(calls) == len(blocks) == 2
    tok = model.tokenizer
    with torch.no_grad():
        _, pos = tok(x)
        cls_pos = model.cls_pos.expand(2, 1, -1)
        pos_full = torch.cat([cls_pos, pos], 1)
        first = blocks[0](calls[0])
    torch.testing.assert_close(calls[1], first + pos_full, rtol=0, atol=0)
    assert torch.isfinite(want).all()


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_converter_matches_jax(qkv_bias):
    """convert_point_transformer on a reference-layout state dict: the
    port's tree equals JAX's exactly (a missing qkv bias becomes zeros), and
    the port's module loaded from it encodes as JAX does from its tree."""
    jcfg, pcfg = _cfgs()
    sd = RL.point_transformer_state_dict(pcfg, torch.Generator().manual_seed(7),
                                         qkv_bias=qkv_bias)
    want_p, want_s = JPT.convert_point_transformer(sd, jcfg)
    got_p, got_s = PPT.convert_point_transformer(sd, pcfg)
    for got, want in ((got_p, want_p), (got_s, want_s)):
        got, want = flatten(got), flatten(jax.tree.map(np.asarray, want))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert flatten(got_p)["blocks.blocks.0.attn.qkv_b"].any() == qkv_bias
    x = _clouds(2, seed=8)
    want, _ = jax.jit(lambda p_, s_, x_: JPT.point_transformer_apply(
        p_, s_, x_, jcfg))(want_p, want_s, jnp.asarray(x))
    with torch.no_grad():
        got = _port(pcfg, got_p, got_s)(torch.from_numpy(x))
    assert _rel(got.numpy(), want) < 1e-5


def test_label_smoothing_loss_matches_jax():
    rng = np.random.RandomState(9)
    pred = rng.randn(6, 5).astype(np.float32) * 3
    gt = np.array([0, 4, 2, 2, 1, 3])
    pred[1] = pred[1] + 10 * np.eye(5, dtype=np.float32)[4]  # one correct
    want_loss, want_acc = JPT.label_smoothing_loss(jnp.asarray(pred),
                                                   jnp.asarray(gt))
    loss, acc = PPT.label_smoothing_loss(torch.from_numpy(pred),
                                         torch.from_numpy(gt))
    assert _rel(loss.item(), want_loss) < 1e-6
    assert acc.item() == float(want_acc)


def test_point_perceiver_matches_jax():
    """point_perceiver_apply: the perceiver, the mean over latents, the
    LayerNorm and the projection, fp32."""
    kw = dict(depth=2, num_latents=6, latent_dim=32, input_dim=16,
              cross_heads=1, cross_dim_head=8, latent_heads=2,
              latent_dim_head=8)
    p = JP.point_perceiver_init(jax.random.PRNGKey(10), JaxPerceiverConfig(**kw),
                                24)
    tokens = np.random.RandomState(11).randn(3, 10, 16).astype(np.float32)
    want = jax.jit(lambda p_, t: JP.point_perceiver_apply(
        p_, t, JaxPerceiverConfig(**kw)))(p, jnp.asarray(tokens))
    head = PointPerceiver(PerceiverConfig(**kw), 24)
    load_params(head, p)
    with torch.no_grad():
        got = head(torch.from_numpy(tokens))
    assert tuple(got.shape) == (3, 24)
    assert _rel(got.numpy(), want) < 1e-5
    fresh = PointPerceiver(PerceiverConfig(**kw), 24)
    fresh.init_(torch.Generator().manual_seed(12))
    assert fresh.proj.std().item() == pytest.approx(32 ** -0.5, rel=0.2)
    assert dataclasses.asdict(PerceiverConfig(**kw)) == dataclasses.asdict(
        JaxPerceiverConfig(**kw))
