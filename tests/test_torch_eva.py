"""The EVA ViT-g trunk and the Perceiver-EVA tower of the port
(vitlens_tpu_torch/models/eva.py) against the JAX package's on the CPU, at
small widths: the trunk on images and on tokens, ``skip_first_n`` keeping
the last blocks, the bicubic position resize (grow and shrink) against
``jax.image.resize``, the tower (PointBERT tokenizer -> Perceiver -> EVA
trunk -> head), the BLIP-2 converter, and the LayerNorm eps 1e-6 reaching
the fused MLP's plain version. JAX's trees are copied with
weights/from_jax.py; inputs come from numpy seeds. fp32: 1e-5 of each
output's largest magnitude; bf16: cosine >= 0.999, computed in fp32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools.reference_layout import eva_state_dict
from vitlens_tpu.config import make_tower_config as jax_tower_config
from vitlens_tpu.models import eva as JE
from vitlens_tpu_torch.config import make_tower_config
from vitlens_tpu_torch.models import eva as PE
from vitlens_tpu_torch.models import layers as PL
from vitlens_tpu_torch.weights.from_jax import load_params, load_state
from tests.test_torch_threads import share_cores

share_cores()

ARCH = dict(image_size=28, patch_size=14, width=64, layers=3, head_width=16,
            mlp_ratio=4.3637, proj_dim=32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1e-12, np.abs(want).max())


def _cos(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return (np.sum(got * want, -1) / np.linalg.norm(got, axis=-1)
            / np.linalg.norm(want, axis=-1)).min()


def _trunk(seed=0, **over):
    arch = dict(ARCH, **over)
    ja, pa = JE.EVAArch(**arch), PE.EVAArch(**arch)
    params = JE.eva_trunk_init(jax.random.PRNGKey(seed), ja)
    m = PE.EVATrunk(pa)
    load_params(m, params)
    return ja, params, m


def test_trunk_images_matches_jax():
    ja, params, m = _trunk()
    x = np.random.RandomState(0).randn(2, 3, 28, 28).astype(np.float32)
    want = JE.eva_trunk_apply(params, jnp.asarray(x), ja)
    got = m(torch.from_numpy(x))
    assert got.shape == (2, 32)
    assert _rel(got.detach().numpy(), want) < 1e-5
    want = JE.eva_trunk_apply(params, jnp.asarray(x), ja, apply_head=False)
    got = m(torch.from_numpy(x), apply_head=False)
    assert _rel(got.detach().numpy(), want) < 1e-5


@pytest.mark.parametrize("skip", [None, 1, 2])
@pytest.mark.parametrize("n_tokens", [4, 9, 1])
def test_trunk_tokens_skip_and_resize(skip, n_tokens):
    """Tokens [B, N, width]: N = 4 uses pos as it is; 9 grows the 2 x 2
    grid to 3 x 3 and 1 shrinks it to 1 x 1 (the resize in the forward);
    skip_first_n keeps the last blocks."""
    ja, params, m = _trunk(seed=1)
    x = np.random.RandomState(1).randn(3, n_tokens, 64).astype(np.float32)
    want = JE.eva_trunk_apply(params, jnp.asarray(x), ja, tokens_input=True,
                              skip_first_n=skip)
    got = m(torch.from_numpy(x), tokens_input=True, skip_first_n=skip)
    assert _rel(got.detach().numpy(), want) < 1e-5
    nopos = m(torch.from_numpy(x), tokens_input=True, use_pos_embed=False)
    want = JE.eva_trunk_apply(params, jnp.asarray(x), ja, tokens_input=True,
                              use_pos_embed=False)
    assert _rel(nopos.detach().numpy(), want) < 1e-5


@pytest.mark.parametrize("g_old,g_new", [(16, 24), (16, 7), (4, 2), (3, 5)])
def test_resize_pos_matches_jax_image_resize(g_old, g_new):
    pos = np.random.RandomState(g_old).randn(g_old * g_old + 1, 40).astype(np.float32)
    want = JE._resize_pos(jnp.asarray(pos), g_new * g_new + 1)
    got = PE.resize_pos(torch.from_numpy(pos), g_new * g_new + 1)
    assert got.shape == (g_new * g_new + 1, 40) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 1e-5


def _tower_cfgs(num_latents=4):
    kw = dict(point=dict(npoints=256, num_group=8, group_size=16,
                         encoder_dims=64, trans_dim=32),
              perceiver=dict(depth=2, num_latents=num_latents, latent_dim=64,
                             input_dim=32, cross_dim_head=16, latent_heads=4,
                             latent_dim_head=16))
    out = []
    for make in (jax_tower_config, make_tower_config):
        t = make("EVA-g-14", "pc")
        t = dataclasses.replace(
            t, point=dataclasses.replace(t.point, **kw["point"]),
            perceiver=dataclasses.replace(t.perceiver, **kw["perceiver"]))
        out.append(t)
    return out


@pytest.mark.parametrize("num_latents,embed_dim,skip", [(4, 32, None), (9, 48, 1)])
def test_perceiver_eva_tower_matches_jax(num_latents, embed_dim, skip):
    """adapter -> Perceiver -> EVA (tokens, pos resized where the latents
    are not the grid) -> head; a head of another width than proj_dim is
    drawn anew (its shape here)."""
    jt, pt = _tower_cfgs(num_latents)
    ja, pa = JE.EVAArch(**ARCH), PE.EVAArch(**ARCH)
    params, state = JE.perceiver_eva_init(jax.random.PRNGKey(2), jt, ja,
                                          embed_dim=embed_dim)
    m = PE.PerceiverEVATower(pt, pa, embed_dim=embed_dim)
    load_params(m, params)
    load_state(m, state)
    x = (np.random.RandomState(2).randn(2, 256, 3) * 0.3).astype(np.float32)
    want, _ = JE.perceiver_eva_apply(params, state, jnp.asarray(x), jt, ja,
                                     skip_first_n_layers=skip)
    got = m(torch.from_numpy(x), skip_first_n_layers=skip)
    assert got.shape == (2, embed_dim)
    assert _rel(got.detach().numpy(), want) < 1e-5


def test_tower_init_shapes_and_entry_point(monkeypatch):
    """The entry point draws the full-width tower's shapes on the card
    unless device='cpu' is given (built here at a small arch)."""
    small = PE.EVAArch(**ARCH)
    monkeypatch.setattr(PE, "perceiver_eva_tower_config",
                        lambda modality="pc", **kw: _tower_cfgs()[1])
    m = PE.make_eva_tower("pc", device="cpu", eva_arch=small, embed_dim=48)
    assert tuple(m.eva.head.w.shape) == (64, 48)
    assert m.eva.trunk.blocks[0].ln_1.eps == 1e-6 and m.eva.norm.eps == 1e-6
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PE.make_eva_tower("pc", eva_arch=small)
    cfg = make_tower_config("EVA-g-14", "pc")
    assert (cfg.arch.width, cfg.arch.layers, cfg.arch.heads) == (1408, 39, 16)
    assert int(1408 * PE.EVAArch().mlp_ratio) == 6144


@pytest.mark.parametrize("head", [True, False])
def test_convert_eva_state_dict_matches_jax(head):
    """BLIP-2 keys -> the tree, leaf for leaf equal to JAX's converter's;
    the loaded trunk encodes as JAX's on the converted tree."""
    arch = PE.EVAArch(**dict(ARCH, proj_dim=64 if not head else 32))
    sd = eva_state_dict(arch, torch.Generator().manual_seed(3), head=head)
    ja = JE.EVAArch(**dataclasses.asdict(arch))
    want = JE.convert_eva_state_dict(sd, ja)
    got = PE.convert_eva_state_dict(sd, arch)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    for path, leaf in flat_w:
        np.testing.assert_array_equal(np.asarray(flat_g[path]), np.asarray(leaf))
    np.testing.assert_array_equal(got["trunk"]["blocks"]["attn"]["qkv_b"][:, 64:128], 0)
    m = PE.EVATrunk(arch)
    load_params(m, got)
    x = np.random.RandomState(3).randn(2, 3, 28, 28).astype(np.float32)
    ref = JE.eva_trunk_apply(want, jnp.asarray(x), ja)
    assert _rel(m(torch.from_numpy(x)).detach().numpy(), ref) < 1e-5


def test_ln_eps_reaches_the_fused_mlp(monkeypatch):
    """In bf16 the blocks' MLP halves go through ops.fused_mlp (its plain
    version on the CPU) with eps 1e-6; the bf16 trunk holds cosine >= 0.999
    against JAX's bf16 trunk."""
    ja, params, m = _trunk(seed=4, width=128, head_width=32)
    PL_fused = PL.fused_mlp
    seen = []

    def spy(*args, **kw):
        seen.append(args[8] if len(args) > 8 else kw.get("eps"))
        return PL_fused(*args, **kw)

    monkeypatch.setattr(PL, "fused_mlp", spy)
    x = np.random.RandomState(4).randn(2, 3, 28, 28).astype(np.float32)
    got = m(torch.from_numpy(x), torch.bfloat16).float().detach().numpy()
    want = JE.eva_trunk_apply(params, jnp.asarray(x), ja,
                              compute_dtype=jnp.bfloat16).astype(jnp.float32)
    assert seen == [1e-6] * 3
    assert _cos(got, want) >= 0.999
