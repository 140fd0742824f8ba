"""The port's model modules on CPU in fp32, held against the JAX package:
parameters initialised in JAX and copied with weights/from_jax.py, the same
numpy inputs on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitlens_tpu.config import PerceiverConfig as JaxPerceiverConfig
from vitlens_tpu.config import make_model_config as jax_model_config
from vitlens_tpu.models import layers as JL
from vitlens_tpu.models.perceiver import perceiver_apply, perceiver_init
from vitlens_tpu.models.text import text_tower_apply, text_tower_init
from vitlens_tpu.models.vit import vision_tower_apply, vision_tower_init
from vitlens_tpu.ops.attention import causal_mask as jax_causal_mask
from vitlens_tpu_torch import config as PC
from vitlens_tpu_torch.models import layers as PL
from vitlens_tpu_torch.models.perceiver import Perceiver
from vitlens_tpu_torch.models.text import TextTower
from vitlens_tpu_torch.models.vit import VisionTower
from vitlens_tpu_torch.ops.attention import causal_mask
from vitlens_tpu_torch.weights.from_jax import flatten, load_params


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max()


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("quick,ls,masked", [
    (False, None, False), (True, None, True), (False, 0.5, False)])
def test_resblock_matches_jax(quick, ls, masked):
    """One block: exact and quick GELU, with and without layer-scale, with
    and without the causal mask. fp32, 1e-5 relative."""
    p = JL.resblock_init(jax.random.PRNGKey(0), 64, 4.0, ls)
    x = _x(2, 11, 64)
    act = JL.quick_gelu if quick else JL.gelu
    want = JL.resblock(jnp.asarray(x), p, 2, act,
                       jax_causal_mask(11) if masked else None)
    block = load_params(PL.ResBlock(64, 2, 4.0, ls, quick), p)
    got = block(torch.from_numpy(x), causal_mask(11) if masked else None)
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("skip", [None, 1])
def test_transformer_matches_jax(skip):
    p = JL.transformer_init(jax.random.PRNGKey(1), 64, 3)
    x = _x(2, 9, 64, seed=1)
    want = JL.transformer(jnp.asarray(x), p, 4, JL.gelu, skip_first_n=skip)
    trunk = load_params(PL.Transformer(64, 3, 4), p)
    got = trunk(torch.from_numpy(x), skip_first_n=skip)
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("tied", [False, True])
def test_perceiver_matches_jax(tied):
    kw = dict(depth=2, num_latents=8, latent_dim=64, input_dim=32,
              cross_heads=1, cross_dim_head=64, latent_heads=2,
              latent_dim_head=32, self_per_cross_attn=2,
              weight_tie_layers=tied)
    p = perceiver_init(jax.random.PRNGKey(2), JaxPerceiverConfig(**kw))
    tokens = _x(2, 30, 32, seed=2)
    want = perceiver_apply(p, jnp.asarray(tokens), JaxPerceiverConfig(**kw))
    lens = load_params(Perceiver(PC.PerceiverConfig(**kw)), p)
    got = lens(torch.from_numpy(tokens))
    assert got.shape == (2, 8, 64)
    assert _rel(got.numpy(), want) < 1e-5


def _tiny_audio(cfg_fn):
    """ViT-Tiny-Test audio: width 64, 2 trunk layers, the 600-token AST
    adapter, a 4-latent Lens of depth 2."""
    tower = cfg_fn("ViT-Tiny-Test", "audio").tower
    assert tower.perceiver.num_latents == 4 and tower.perceiver.depth == 2
    return tower


def test_audio_tower_matches_jax():
    """fp32, 1e-4 of max|ref| (summation order over some 40 layers)."""
    jcfg = _tiny_audio(jax_model_config)
    p, s = vision_tower_init(jax.random.PRNGKey(3), jcfg)
    fbank = _x(2, 512, 128, seed=3)
    want, _ = vision_tower_apply(p, s, jnp.asarray(fbank), jcfg)
    tower = load_params(VisionTower(_tiny_audio(PC.make_model_config)), p)
    got = tower(torch.from_numpy(fbank))
    assert got.shape == (2, 32)
    assert _rel(got.numpy(), want) < 1e-4


def test_text_tower_matches_jax():
    cfg = jax_model_config("ViT-Tiny-Test", "audio")
    p = text_tower_init(jax.random.PRNGKey(4), cfg.text, cfg.embed_dim)
    rng = np.random.RandomState(4)
    ids = np.zeros((3, 77), np.int32)
    for i, n in enumerate((5, 20, 75)):
        ids[i, 0] = 49406
        ids[i, 1:n] = rng.randint(1, 49405, n - 1)
        ids[i, n] = 49407
    want = text_tower_apply(p, jnp.asarray(ids), cfg.text)
    pcfg = PC.make_model_config("ViT-Tiny-Test", "audio")
    tower = load_params(TextTower(pcfg.text, pcfg.embed_dim), p)
    got = tower(torch.from_numpy(ids).long())
    assert _rel(got.detach().numpy(), want) < 1e-4


def test_from_jax_unstacks_blocks_and_rejects_mismatch():
    p = JL.transformer_init(jax.random.PRNGKey(5), 64, 2)
    flat = flatten(p)
    assert "blocks.1.attn.qkv_w" in flat and flat["blocks.1.attn.qkv_w"].shape == (64, 192)
    np.testing.assert_array_equal(flat["blocks.1.mlp.fc.w"],
                                  np.asarray(p["blocks"]["mlp"]["fc"]["w"][1]))
    with pytest.raises(KeyError):
        load_params(PL.Transformer(64, 3, 2), p)  # missing block 2
    p["blocks"]["extra"] = jnp.zeros((2, 3))
    with pytest.raises(KeyError):
        load_params(PL.Transformer(64, 2, 2), p)  # unknown key


def test_unported_modalities_raise():
    """What is unknown raises: a point tokenizer other than PointBERT and
    PNSA. The PNSA tower (the vitlensG pc tower), the depth tower (its
    identity Lens), the EEG tower, the video train transforms and train-time
    patch dropout, ported since, build and run."""
    pc = PC.make_model_config("ViT-Tiny-Test", "pc").tower
    with pytest.raises(ValueError, match="unknown point tokenizer"):
        VisionTower(PC.replace(pc, point=PC.replace(pc.point, tokenizer="pointnet")))
    pnsa = VisionTower(PC.replace(pc, point=PC.replace(pc.point, tokenizer="pnsa")))
    assert len(pnsa.adapter.sa) == 3
    dropping = VisionTower(PC.replace(pc, patch_dropout=0.5))
    dropping.init_(torch.Generator().manual_seed(0))
    keep = torch.arange(dropping.cfg.num_tokens // 2)[None]
    assert torch.isfinite(dropping(torch.randn(1, 64, 3), train=True,
                                   patch_keep=keep)).all()
    from vitlens_tpu_torch.data.video_processors import VideoProcessor

    train = VideoProcessor(train=True)
    assert train.train and train.rand_aug is not None
    depth = VisionTower(PC.make_model_config("ViT-Tiny-Test", "depth").tower)
    assert depth.perceiver is None and depth.perceiver_transformer is None
    eeg = VisionTower(PC.make_model_config("ViT-Tiny-Test", "eeg").tower)
    assert eeg.perceiver is not None


def test_create_model_and_tri_encode_match_jax():
    """factory.create_model builds the Lens + text model from a seeded
    generator with matmul weights cast to the requested dtype; with JAX's
    weights loaded, tri.encode_visual / encode_text (normalized) match
    JAX's to 1e-4 in fp32."""
    from vitlens_tpu.models import tri as JT
    from vitlens_tpu_torch.factory import create_model
    from vitlens_tpu_torch.models import tri as PT

    half = create_model("ViT-Tiny-Test", "audio", seed=0, device="cpu",
                        dtype=torch.bfloat16)
    assert half.visual.trunk.blocks[0].mlp.fc.w.dtype == torch.bfloat16
    assert half.visual.proj.dtype == torch.bfloat16
    assert half.visual.trunk.blocks[0].ln_1.scale.dtype == torch.float32
    assert half.visual.class_embedding.dtype == torch.float32
    again = create_model("ViT-Tiny-Test", "audio", seed=0, device="cpu",
                         dtype=torch.bfloat16)
    assert torch.equal(again.visual.perceiver.latents, half.visual.perceiver.latents)

    cfg = jax_model_config("ViT-Tiny-Test", "audio")
    params, state = JT.tri_model_init(jax.random.PRNGKey(6), cfg)
    model = create_model("ViT-Tiny-Test", "audio", device="cpu")
    load_params(model.visual, params["visual"])
    load_params(model.text, params["text"])
    fbank = _x(2, 512, 128, seed=6)
    ids = np.zeros((2, 77), np.int32)
    ids[:, :3] = [[49406, 320, 49407], [49406, 1929, 49407]]
    want_v, _ = JT.encode_visual(params, state, jnp.asarray(fbank), cfg,
                                 normalize=True)
    want_t = JT.encode_text(params, jnp.asarray(ids), cfg, normalize=True)
    got_v = PT.encode_visual(model, torch.from_numpy(fbank), normalize=True)
    got_t = PT.encode_text(model, torch.from_numpy(ids).long(), normalize=True)
    assert _rel(got_v.detach().numpy(), want_v) < 1e-4
    assert _rel(got_t.detach().numpy(), want_t) < 1e-4
