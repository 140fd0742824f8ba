"""Attention on strided views, as the trunk and the Lens now call it: q, k and
v are views of the packed projections (no copies), on the CPU through the
plain version, held against contiguous copies and against the JAX package's
``mha`` and Lens attention at small width (fp32 to 1e-5, bf16 by cosine)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitlens_tpu.models import layers as JL
from vitlens_tpu.models import perceiver as JP
from vitlens_tpu.ops.attention import causal_mask as jax_causal_mask
from vitlens_tpu_torch.models import layers as PL
from vitlens_tpu_torch.models import perceiver as PP
from vitlens_tpu_torch.ops import attention as PA
from vitlens_tpu_torch.ops.attention import causal_mask
from vitlens_tpu_torch.ops.flash_attention import flash_attention
from vitlens_tpu_torch.weights.from_jax import load_params
from tests.test_torch_threads import share_cores

share_cores()

DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _cos(got, want):
    got = np.asarray(got, np.float32).ravel()
    want = np.asarray(want, np.float32).ravel()
    return float(got @ want / np.linalg.norm(got) / np.linalg.norm(want))


def _views(kind, dtype):
    """(q, k, v) views as the callers make them."""
    if kind == "packed qkv":  # the trunk: [B, N, 3, H, Dh] of one projection
        qkv = torch.from_numpy(_x(2, 9, 3 * 3 * 64)).to(dtype)
        return tuple(qkv.view(2, 9, 3, 3, 64).permute(2, 0, 3, 1, 4))
    q = torch.from_numpy(_x(2, 5, 2 * 64, seed=1)).to(dtype)  # the Lens
    kv = torch.from_numpy(_x(2, 11, 2 * 2 * 64, seed=2)).to(dtype)
    k, v = kv.view(2, 11, 2, 2, 64).permute(2, 0, 3, 1, 4)
    return q.view(2, 5, 2, 64).transpose(1, 2), k, v


@pytest.mark.parametrize("kind", ["packed qkv", "lens"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_attention_on_views_equals_contiguous(kind, dtype):
    q, k, v = _views(kind, DTYPES[dtype][0])
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    got = flash_attention(q, k, v)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_backward_on_views(dtype):
    """The Function's gradients flow back through the views into the packed
    tensor as they would from contiguous copies."""
    base = torch.from_numpy(_x(2, 9, 3 * 3 * 64, seed=3)).to(DTYPES[dtype][0])
    grads = []
    for copy in (False, True):
        qkv = base.clone().requires_grad_(True)
        q, k, v = qkv.view(2, 9, 3, 3, 64).permute(2, 0, 3, 1, 4)
        if copy:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = flash_attention(q, k, v)
        assert "Function" in type(out.grad_fn).__name__
        (g,) = torch.autograd.grad(out.float().square().sum(), qkv)
        grads.append(g)
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mha_from_qkv_matches_jax(masked, dtype):
    """MHA on the packed projection's views against the JAX ``mha``: fp32
    within 1e-5, bf16 at cosine >= 0.999."""
    tdt, jdt = DTYPES[dtype]
    p = JL.mha_init(jax.random.PRNGKey(4), 128)
    x = _x(2, 13, 128, seed=4)
    want = JL.mha(jnp.asarray(x, jdt), p, 2,
                  jax_causal_mask(13) if masked else None)
    mha = load_params(PL.MHA(128, 2), p)
    with torch.no_grad():
        got = mha(torch.from_numpy(x).to(tdt),
                  causal_mask(13).to(tdt) if masked else None)
    assert got.dtype == tdt and got.shape == (2, 13, 128)
    if dtype == "fp32":
        assert _rel(got.float().numpy(), want) < 1e-5
    else:
        assert _cos(got.float().numpy(), want.astype(jnp.float32)) >= 0.999


@pytest.mark.parametrize("heads,dim_head", [(1, 64), (2, 64)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lens_attention_matches_jax(heads, dim_head, dtype):
    """The Lens's cross- (one head) and self-attention shapes on the to_q /
    to_kv views against the JAX ``_attn``."""
    tdt, jdt = DTYPES[dtype]
    p = JP._attn_init(jax.random.PRNGKey(5), 96, 48, heads, dim_head)
    x, ctx = _x(2, 7, 96, seed=5), _x(2, 19, 48, seed=6)
    want = JP._attn(jnp.asarray(x, jdt), jnp.asarray(ctx, jdt), p, heads, dim_head)
    attn = load_params(PP.Attention(96, 48, heads, dim_head), p)
    with torch.no_grad():
        got = attn(torch.from_numpy(x).to(tdt), torch.from_numpy(ctx).to(tdt))
    assert got.dtype == tdt and got.shape == (2, 7, 96)
    if dtype == "fp32":
        assert _rel(got.float().numpy(), want) < 1e-5
    else:
        assert _cos(got.float().numpy(), want.astype(jnp.float32)) >= 0.999


@pytest.mark.parametrize("module", ["mha", "lens"])
def test_callers_pass_views_not_copies(module, monkeypatch):
    """The trunk's and the Lens's q, k, v reach the kernel's entry point as
    views of one projection each (no copies were made). In bf16: the kernel
    takes bf16, and an fp32 call takes the plain path, as in JAX."""
    seen = []

    def record(q, k, v, scale):
        seen.append((q, k, v))
        return flash_attention(q, k, v, scale)

    monkeypatch.setattr(PA, "flash_attention", record)
    with torch.no_grad():
        if module == "mha":
            m = PL.MHA(128, 2)
            m.init_(torch.Generator().manual_seed(0))
            m(torch.from_numpy(_x(2, 5, 128)).bfloat16())
        else:
            m = PP.Attention(64, 32, 2, 64)
            m.init_(torch.Generator().manual_seed(0))
            m(torch.from_numpy(_x(2, 5, 64)).bfloat16(),
              torch.from_numpy(_x(2, 8, 32)).bfloat16())
    (q, k, v), = seen
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    assert k.untyped_storage().data_ptr() == v.untyped_storage().data_ptr()
    if module == "mha":
        assert q.untyped_storage().data_ptr() == k.untyped_storage().data_ptr()
