"""The point-cloud slice on CPU, held against the JAX package: the PointBERT
tokenizer, the pc vision tower, the pc processor and ViTLens.encode for pc
and text, on the same weights and BatchNorm statistics (JAX's, copied with
weights/from_jax.py load_params + load_state) and the same inputs. BN
statistics are set to nontrivial random values on both sides, so a missing
state load fails."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitlens_tpu.adapters import tokenizers as JT
from vitlens_tpu.api import ViTLens as JaxViTLens
from vitlens_tpu.config import PointAdapterConfig as JaxPointConfig
from vitlens_tpu.config import make_model_config as jax_model_config
from vitlens_tpu.data.processors import PointCloudProcessor as JaxPointProcessor
from vitlens_tpu.models.vit import vision_tower_apply, vision_tower_init
from vitlens_tpu_torch import config as PC
from vitlens_tpu_torch.adapters.tokenizers import PointTokenizer
from vitlens_tpu_torch.api import ViTLens
from vitlens_tpu_torch.data.processors import PointCloudProcessor
from vitlens_tpu_torch.models.vit import VisionTower
from vitlens_tpu_torch.ops import fps as PF
from vitlens_tpu_torch.ops import fused_point_encoder as PFE
from vitlens_tpu_torch.weights.from_jax import load_params, load_state
from tests.test_torch_threads import share_cores

share_cores()

SMALL = dict(npoints=512, num_group=32, group_size=32)  # 32 groups of 32


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _cos(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _randomize_bn(p, s, seed):
    """Random BN scale/bias (params) and mean/var (state) under the
    tokenizer's ``encoder`` subtree; returns new (p, s) trees."""
    rng = np.random.RandomState(seed)
    p = jax.tree.map(lambda x: x, p)
    s = jax.tree.map(lambda x: x, s)
    for bn, c in (("bn1", 128), ("bn2", 512)):
        p["encoder"][bn] = {"scale": jnp.asarray(1 + 0.2 * rng.randn(c), jnp.float32),
                            "bias": jnp.asarray(0.1 * rng.randn(c), jnp.float32)}
        s["encoder"][bn] = {"mean": jnp.asarray(0.2 * rng.randn(c), jnp.float32),
                            "var": jnp.asarray(0.5 + rng.rand(c), jnp.float32)}
    return p, s


def _clouds(b, n, seed):
    return (np.random.RandomState(seed).randn(b, n, 3) * 0.3).astype(np.float32)


def test_point_tokenizer_matches_jax():
    """Tokens and pos of point_tokenizer_apply(train=False), fp32, 1e-4
    relative; without the state load the tokens differ."""
    jcfg = JaxPointConfig(**SMALL, knn_exact=True)
    p, s = jax.jit(JT.point_tokenizer_init, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    p, s = _randomize_bn(p, s, seed=1)
    pts = _clouds(2, 512, seed=2)
    (want_t, want_p), _ = jax.jit(functools.partial(
        JT.point_tokenizer_apply, cfg=jcfg))(p, s, jnp.asarray(pts))
    tok = PointTokenizer(PC.PointAdapterConfig(**SMALL))
    tok.init_(torch.Generator().manual_seed(0))  # BN statistics 0 and 1
    load_params(tok, p)
    fresh_t, _ = tok(torch.from_numpy(pts))
    load_state(tok, s)
    got_t, got_p = tok(torch.from_numpy(pts))
    assert tuple(got_t.shape) == (2, 32, 384) and tuple(got_p.shape) == (2, 32, 384)
    assert _rel(got_t.numpy(), want_t) < 1e-4
    assert _rel(got_p.numpy(), want_p) < 1e-4
    assert _rel(fresh_t.numpy(), want_t) > 1e-2


def test_load_state_is_strict():
    tok = PointTokenizer(PC.PointAdapterConfig(**SMALL))
    good = {"encoder": {"bn1": {"mean": np.zeros(128), "var": np.ones(128)},
                        "bn2": {"mean": np.zeros(512), "var": np.ones(512)}}}
    load_state(tok, good)
    with pytest.raises(KeyError, match="state"):
        load_state(tok, {"encoder": {"bn1": good["encoder"]["bn1"]}})
    bad = {"encoder": {**good["encoder"], "bn3": {"mean": np.zeros(4)}}}
    with pytest.raises(KeyError, match="state"):
        load_state(tok, bad)
    bad = {"encoder": {"bn1": {"mean": np.zeros(64), "var": np.ones(128)},
                       "bn2": good["encoder"]["bn2"]}}
    with pytest.raises(ValueError, match="shape"):
        load_state(tok, bad)


def _tiny_pc(cfg_fn, point_cls):
    """ViT-Tiny-Test pc: width 64, 2 trunk layers, 512 points in 32 groups of
    32, a 4-latent Lens of depth 4 over 384-wide tokens."""
    tower = cfg_fn("ViT-Tiny-Test", "pc").tower
    tower = dataclasses.replace(tower, point=point_cls(**SMALL))
    assert tower.perceiver.depth == 4 and tower.perceiver.input_dim == 384
    return tower


def test_pc_tower_matches_jax():
    """fp32, 1e-4 of max|ref|."""
    jcfg = _tiny_pc(jax_model_config, JaxPointConfig)
    jcfg = dataclasses.replace(
        jcfg, point=dataclasses.replace(jcfg.point, knn_exact=True))
    p, s = jax.jit(vision_tower_init, static_argnums=1)(
        jax.random.PRNGKey(3), jcfg)
    p["adapter"], s["adapter"] = _randomize_bn(p["adapter"], s["adapter"], seed=4)
    pts = _clouds(2, 512, seed=5)
    want, _ = jax.jit(functools.partial(vision_tower_apply, cfg=jcfg))(
        p, s, jnp.asarray(pts))
    tower = VisionTower(_tiny_pc(PC.make_model_config, PC.PointAdapterConfig))
    load_state(load_params(tower, p), s)
    got = tower(torch.from_numpy(pts))
    assert tuple(got.shape) == (2, 32)
    assert _rel(got.numpy(), want) < 1e-4


def test_pc_processor_matches_jax():
    """A 9000-point cloud sampled to 8192, and an 8192-point cloud with two
    extra columns widened to 6 channels: bit for bit equal to the JAX
    package's processor."""
    rng = np.random.RandomState(6)
    cloud = (rng.randn(9000, 3) * [1.0, 0.5, 2.0] + 0.3).astype(np.float32)
    got = PointCloudProcessor()([cloud])
    want = JaxPointProcessor()([cloud])
    assert got.dtype == np.float32 and got.shape == (1, 8192, 3)
    np.testing.assert_array_equal(got, want)
    rgb = np.concatenate([cloud[:8192], rng.rand(8192, 2).astype(np.float32)], 1)
    got = PointCloudProcessor(channels=6)([rgb])
    assert got.shape == (1, 8192, 6) and (got[..., 5] == np.float32(0.4)).all()
    np.testing.assert_array_equal(got, JaxPointProcessor(channels=6)([rgb]))


MODALITIES = ("pc", "text")
CAPTIONS = ["a wooden chair", "an airplane", "a table lamp"]


@pytest.fixture(scope="module")
def jax_model():
    jm = JaxViTLens(model_var="vitlensB", modality_loaded=MODALITIES, seed=0)
    pc = jm._towers["pc"]
    pc["params"]["adapter"], pc["state"]["adapter"] = _randomize_bn(
        pc["params"]["adapter"], pc["state"]["adapter"], seed=7)
    return jm


@pytest.mark.parametrize("dtype,min_cos", [("float32", 0.99999),
                                           ("bfloat16", 0.99)])
def test_encode_matches_jax(jax_model, dtype, min_cos):
    """ViTLens("vitlensB", ("pc", "text")) on JAX's params and BN state:
    cosine per row >= 0.99999 in fp32, >= 0.99 under the bf16 policy on both
    sides (computed in fp32). CPU calls launch no kernel."""
    jm = jax_model
    jm.compute_dtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jm._jit_cache.clear()
    pm = ViTLens("vitlensB", MODALITIES, device="cpu",
                 compute_dtype=getattr(torch, dtype))
    for m in MODALITIES:
        load_params(pm.towers[m], jax_model._towers[m]["params"])
    load_state(pm.towers["pc"], jax_model._towers["pc"]["state"])
    clouds = _clouds(2, 8192, seed=8)
    PF.fps_indices.launches = PFE.fused_point_encoder.launches = 0
    got = {**pm.encode({"pc": clouds}, preprocessed=True),
           **pm.encode({"text": CAPTIONS})}
    want = {**jm.encode({"pc": clouds}, preprocessed=True),
            **jm.encode({"text": CAPTIONS})}
    assert PF.fps_indices.launches == PFE.fused_point_encoder.launches == 0
    assert tuple(got["pc"].shape) == (2, 512)
    np.testing.assert_allclose(np.linalg.norm(got["pc"].numpy(), axis=-1), 1.0,
                               atol=1e-5)
    for m in MODALITIES:
        assert _cos(got[m].float().numpy(),
                    np.asarray(jnp.asarray(want[m], jnp.float32))).min() >= min_cos


def test_raw_clouds_and_device_default(monkeypatch):
    """Raw clouds go through the processor (set to the tower's point count);
    the vitlensG pc tower builds from its own config, its processor set to
    that config's point count and width (tests/test_torch_pnsa.py encodes
    through it); with no CUDA device and no device given, the entry points
    raise."""
    pm = ViTLens("vitlensB", ("pc",), device="cpu", seed=1)
    pm.towers["pc"].trunk.blocks = pm.towers["pc"].trunk.blocks[:1]
    assert pm.processors["pc"].n == 8192 and pm.processors["pc"].channels == 3
    raw = [_clouds(1, 8300, seed=9)[0]]
    got = pm.encode({"pc": raw})["pc"]
    want = pm.encode({"pc": JaxPointProcessor()(raw)}, preprocessed=True)["pc"]
    assert tuple(got.shape) == (1, 512)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    import vitlens_tpu_torch.api as api

    tiny = PC.replace(PC.make_model_config("ViT-Tiny-Test", "pc").tower,
                      point=PC.PointAdapterConfig(tokenizer="pnsa", npoints=300,
                                                  num_group=8, group_size=8,
                                                  in_channel=6))
    monkeypatch.setattr(api, "vitlensG_tower_config", lambda: tiny)
    g = ViTLens("vitlensG", ("pc",), device="cpu")
    assert g.towers["pc"].cfg is tiny
    assert (g.processors["pc"].n, g.processors["pc"].channels) == (300, 6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ViTLens("vitlensB", ("pc",))
