"""Head dims other than 64 in the attention kernel's wrapper, on the CPU: the
argument checks take every multiple of 8 from 8 to 128 (the trunks of
ViT-H-14, ViT-g-14, ViT-bigG-14 and ViT-e-14 have 80, 88, 104 and 112),
contiguous and as the packed qkv projection's views, and refuse the rest;
and a bigG-shaped narrow trunk (head dim 104, 2 heads, 2 blocks) matches the
JAX package's in fp32 and, by cosine, in bf16, with its attention calls
reaching the kernel's wrapper in bf16 at head dim 104."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitlens_tpu.models import layers as JL
from vitlens_tpu_torch import config as PC
from vitlens_tpu_torch.models import layers as PL
from vitlens_tpu_torch.ops import attention as PA
from vitlens_tpu_torch.ops import flash_attention as PFA
from vitlens_tpu_torch.weights.from_jax import load_params
from tests.test_torch_threads import share_cores

share_cores()


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("d", [8, 32, 64, 80, 88, 104, 112, 128])
def test_check_args_take_head_dims_to_128(d):
    q = torch.zeros(1, 2, 5, d, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 7, d, dtype=torch.bfloat16)
    PFA._check_cuda_args(q, k, k, d ** -0.5)
    # a size-1 dim's stride is reported as one row of the true head dim
    assert PFA._strides(q[:, :1]) == (d, d, d)


@pytest.mark.parametrize("d", [4, 100, 136, 256])
def test_check_args_refuse_other_head_dims(d):
    q = torch.zeros(1, 2, 5, d, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        PFA._check_cuda_args(q, q, q)


@pytest.mark.parametrize("d", [80, 104])
def test_check_args_take_packed_qkv_views(d):
    """The trunk's q, k, v at head dim 104 (and 80): views of one [B, N,
    3 * H * d] projection, rows 3 * H * d apart, heads d apart, k and v
    H * d elements into the row (16-byte aligned)."""
    qkv = torch.zeros(2, 9, 3 * 16 * d, dtype=torch.bfloat16)
    q, k, v = qkv.view(2, 9, 3, 16, d).permute(2, 0, 3, 1, 4)
    PFA._check_cuda_args(q, k, v, d ** -0.5)
    assert PFA._strides(k) == (9 * 3 * 16 * d, d, 3 * 16 * d)
    assert (k.data_ptr() - q.data_ptr()) % 16 == 0


def test_bigg_trunks_have_these_head_dims():
    heads = {name: PC.get_arch(name)["vision"].head_width
             for name in ("ViT-H-14", "ViT-g-14", "ViT-bigG-14", "ViT-e-14")}
    assert heads == {"ViT-H-14": 80, "ViT-g-14": 88, "ViT-bigG-14": 104,
                     "ViT-e-14": 112}
    assert all(d in PFA.HEAD_DIMS for d in heads.values())


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_bigg_shaped_trunk_matches_jax(dtype, monkeypatch):
    """Width 208 = 2 heads of 104, 2 blocks: fp32 within 1e-5 relative of
    JAX's trunk (the plain path, as in JAX); bf16 by cosine >= 0.999
    (computed in fp32), every attention call reaching the kernel's wrapper
    with head dim 104 on views that its argument checks take."""
    seen = []
    real = PA.flash_attention

    def spy(q, k, v, scale):
        PFA._check_cuda_args(q, k, v, scale)
        seen.append((q.shape[-1], scale))
        return real(q, k, v, scale)

    monkeypatch.setattr(PA, "flash_attention", spy)
    p = JL.transformer_init(jax.random.PRNGKey(7), 208, 2)
    x = _x(2, 17, 208, seed=7)
    trunk = load_params(PL.Transformer(208, 2, 2), p)
    if dtype == "fp32":
        want = JL.transformer(jnp.asarray(x), p, 2, JL.gelu)
        with torch.no_grad():
            got = trunk(torch.from_numpy(x))
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-5
        assert seen == []
        return
    pb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
    want = np.asarray(JL.transformer(jnp.asarray(x, jnp.bfloat16), pb, 2, JL.gelu),
                      np.float32).ravel().astype(np.float64)
    with torch.no_grad():
        got = trunk(torch.from_numpy(x).bfloat16()).float().numpy().ravel()
    cos = got @ want / np.linalg.norm(got) / np.linalg.norm(want)
    assert cos >= 0.999
    assert seen == [(104, 104 ** -0.5)] * 2
