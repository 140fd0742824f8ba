"""The port's kernel modules on CPU, held against the JAX package's Pallas
kernels (run in interpret mode, as the JAX kernel tests run them) and their
plain XLA references. On CPU tensors the port's wrappers take their plain
PyTorch versions, so these tests fix the arithmetic the CUDA kernels are held
to on the card (chip_smoke.py), and that the CPU path launches nothing."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import vitlens_tpu.ops.flash_attention as FA
from vitlens_tpu.ops import fused_mlp as FM
from vitlens_tpu.ops.attention import _xla_attention
from vitlens_tpu.ops.attention import causal_mask as jax_causal_mask
from vitlens_tpu_torch.ops import attention as PA
from vitlens_tpu_torch.ops import fused_mlp as PFM
from vitlens_tpu_torch.ops.flash_attention import (attention_reference,
                                                   flash_attention)
from tests.test_torch_threads import share_cores

share_cores()


def _mlp_args(m=200, d=128, hidden=256, seed=0):
    rng = np.random.RandomState(seed)
    return (
        (rng.randn(m, d) * 0.5).astype(np.float32),
        (rng.rand(1, d) + 0.5).astype(np.float32),
        (rng.randn(1, d) * 0.1).astype(np.float32),
        (rng.randn(d, hidden) * 0.05).astype(np.float32),
        (rng.randn(1, hidden) * 0.1).astype(np.float32),
        (rng.randn(hidden, d) * 0.05).astype(np.float32),
        (rng.randn(1, d) * 0.1).astype(np.float32),
    )


def _jax_mlp_args(args, dtype):
    x, lnw, lnb, w1, b1, w2, b2 = args
    return (jnp.asarray(x, dtype), jnp.asarray(lnw), jnp.asarray(lnb),
            jnp.asarray(w1, dtype), jnp.asarray(b1), jnp.asarray(w2, dtype),
            jnp.asarray(b2))


def _torch_mlp_args(args, dtype):
    x, lnw, lnb, w1, b1, w2, b2 = args
    t = torch.from_numpy
    return (t(x).to(dtype), t(lnw[0]), t(lnb[0]), t(w1).to(dtype), t(b1[0]),
            t(w2).to(dtype), t(b2[0]))


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(1e-6, np.abs(want).max())


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_reference_matches_pallas_kernel(act, dtype, monkeypatch):
    """M=200 is ragged against the kernel's 128-row tile. fp32: 1e-5
    relative. bf16: 2.5e-2, the JAX kernel test's own bound (the kernel keeps
    the activation input in fp32 where the plain schedule rounds it)."""
    monkeypatch.setattr(FM, "_INTERPRET", True)
    args = _mlp_args()
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = FM._pallas_fused_mlp(*_jax_mlp_args(args, jdt), act=act, eps=1e-5,
                                tm=128)
    got = PFM.fused_mlp(*_torch_mlp_args(args, tdt), act=act, eps=1e-5)
    assert got.dtype == tdt and tuple(got.shape) == (200, 128)
    tol = 1e-5 if dtype == "float32" else 2.5e-2
    assert _rel(got.float().numpy(), want) < tol


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_reference_matches_xla_reference(act, dtype):
    """The plain version mirrors JAX's _xla_reference: fp32 to 1e-5, bf16
    to 2.5e-2 (summation order across bf16 roundings)."""
    args = _mlp_args(seed=1)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = FM._xla_reference(*_jax_mlp_args(args, jdt), act=act, eps=1e-5)
    got = PFM.fused_mlp_reference(*_torch_mlp_args(args, tdt), act=act,
                                  eps=1e-5)
    tol = 1e-5 if dtype == "float32" else 2.5e-2
    assert _rel(got.float().numpy(), want) < tol


@pytest.fixture()
def interp(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _qkv(seed, b=2, h=3, nq=40, nk=56, d=64):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, nq, d).astype(np.float32),
            rng.randn(b, h, nk, d).astype(np.float32),
            rng.randn(b, h, nk, d).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 3, 40, 56), (1, 2, 70, 33)])
def test_attention_reference_matches_pallas_kernel(interp, shape):
    """NQ != NK, both ragged against the kernel's tiles; fp32 to 1e-5."""
    b, h, nq, nk = shape
    q, k, v = _qkv(0, b, h, nq, nk)
    want = FA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              None)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for got in (attention_reference(tq, tk, tv), flash_attention(tq, tk, tv),
                PA.dot_product_attention(tq, tk, tv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_dot_product_attention_matches_xla(masked):
    q, k, v = _qkv(1, nq=33, nk=33)
    scale = 0.125
    jmask = jax_causal_mask(33) if masked else None
    want = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jmask, scale)
    tmask = PA.causal_mask(33) if masked else None
    got = PA.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                   mask=tmask, scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(PA.causal_mask(5).numpy(),
                                  np.asarray(jax_causal_mask(5)))


def test_cpu_calls_launch_no_kernel():
    """On CPU tensors the wrappers take their plain versions and leave the
    launch counters alone."""
    before = (PFM.fused_mlp.launches, flash_attention.launches)
    PFM.fused_mlp(*_torch_mlp_args(_mlp_args(m=8), torch.float32))
    q, k, v = map(torch.from_numpy, _qkv(2, 1, 1, 8, 8))
    flash_attention(q, k, v)
    PA.dot_product_attention(q, k, v)
    assert (PFM.fused_mlp.launches, flash_attention.launches) == before == (0, 0)
