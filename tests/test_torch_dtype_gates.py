"""The dtype gates of the port's kernel call sites, held against the JAX
package's: a block, a Lens attention and the point tokenizer in fp32 (the
default compute dtype) take the plain versions and match the JAX package's
fp32 path to ~1e-5, while bf16 calls reach the kernels' wrappers. On the CPU
the wrappers run their plain versions too, so a spy in the calling module
shows which way each call went; on the card the bf16 way launches the kernel
and the fp32 way launches nothing (``chip_smoke.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitlens_tpu.adapters import tokenizers as JT
from vitlens_tpu.config import PointAdapterConfig as JaxPointConfig
from vitlens_tpu.models import layers as JL
from vitlens_tpu.models import perceiver as JP
from vitlens_tpu_torch import config as PC
from vitlens_tpu_torch.adapters import tokenizers as PT
from vitlens_tpu_torch.models import layers as PL
from vitlens_tpu_torch.models import perceiver as PP
from vitlens_tpu_torch.ops import attention as PA
from vitlens_tpu_torch.ops.flash_attention import flash_attention_applicable
from vitlens_tpu_torch.ops.fused_mlp import fused_mlp_applicable
from vitlens_tpu_torch.ops.fused_point_encoder import point_encoder_applicable
from vitlens_tpu_torch.weights.from_jax import load_params, load_state
from tests.test_torch_threads import share_cores

share_cores()

SMALL = dict(npoints=256, num_group=16, group_size=32)
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _cos(got, want):
    got = np.asarray(got, np.float32).ravel().astype(np.float64)
    want = np.asarray(want, np.float32).ravel().astype(np.float64)
    return float(got @ want / np.linalg.norm(got) / np.linalg.norm(want))


def _spy(monkeypatch, module, name):
    """Replace ``module.name`` by a pass-through that counts its calls."""
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(args[0].dtype)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def _resblock(dtype):
    tdt, jdt = DTYPES[dtype]
    p = JL.resblock_init(jax.random.PRNGKey(0), 64, 4.0, None)
    x = _x(2, 11, 64)
    want = JL.resblock(jnp.asarray(x, jdt), jax.tree.map(lambda a: a.astype(jdt), p),
                       2, JL.gelu, None)
    block = load_params(PL.ResBlock(64, 2, 4.0, None, False), p)
    with torch.no_grad():
        got = block(torch.from_numpy(x).to(tdt))
    return got, want


def _lens(dtype):
    tdt, jdt = DTYPES[dtype]
    p = JP._attn_init(jax.random.PRNGKey(5), 96, 48, 2, 64)
    x, ctx = _x(2, 7, 96, seed=5), _x(2, 19, 48, seed=6)
    want = JP._attn(jnp.asarray(x, jdt), jnp.asarray(ctx, jdt), p, 2, 64)
    attn = load_params(PP.Attention(96, 48, 2, 64), p)
    with torch.no_grad():
        got = attn(torch.from_numpy(x).to(tdt), torch.from_numpy(ctx).to(tdt))
    return got, want


def _tokenizer(dtype):
    tdt, jdt = DTYPES[dtype]
    jcfg = JaxPointConfig(**SMALL, knn_exact=True)
    p, s = jax.jit(JT.point_tokenizer_init, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(1)
    for bn, c in (("bn1", 128), ("bn2", 512)):
        s["encoder"][bn] = {"mean": jnp.asarray(0.2 * rng.randn(c), jnp.float32),
                            "var": jnp.asarray(0.5 + rng.rand(c), jnp.float32)}
    pts = (np.random.RandomState(2).randn(2, 256, 3) * 0.3).astype(np.float32)
    # both sides see the coordinates rounded to the compute dtype
    pts = np.array(jnp.asarray(pts, jdt).astype(jnp.float32))
    (want, _), _ = jax.jit(functools.partial(JT.point_tokenizer_apply, cfg=jcfg))(
        p, s, jnp.asarray(pts, jdt))
    tok = PT.PointTokenizer(PC.PointAdapterConfig(**SMALL))
    tok.init_(torch.Generator().manual_seed(0))
    load_params(tok, p)
    load_state(tok, s)
    with torch.no_grad():
        got, _ = tok(torch.from_numpy(pts).to(tdt))
    return got, want


CASES = {  # (module holding the call, the wrapper's name there, the forward)
    "resblock": (PL, "fused_mlp", _resblock),
    "lens attention": (PA, "flash_attention", _lens),
    "point tokenizer": (PT, "fused_point_encoder", _tokenizer),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fp32_takes_the_plain_version_and_matches_jax(case, monkeypatch):
    """fp32 (the default): the kernel's wrapper is not called, and the
    output matches the JAX package's fp32 path (1e-5 relative; the
    tokenizer's kNN and BN 1e-4, as its own parity test)."""
    module, name, forward = CASES[case]
    calls = _spy(monkeypatch, module, name)
    got, want = forward("fp32")
    assert calls == []
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) < (1e-4 if case == "point tokenizer" else 1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_reaches_the_kernel(case, monkeypatch):
    """bf16: the call goes to the kernel's wrapper, in bf16, and the output
    agrees with the JAX package's bf16 path by cosine (computed in fp32)."""
    module, name, forward = CASES[case]
    calls = _spy(monkeypatch, module, name)
    got, want = forward("bf16")
    assert calls and set(calls) == {torch.bfloat16}
    assert got.dtype == torch.bfloat16
    assert _cos(got.float().numpy(), np.asarray(want, np.float32)) >= 0.999


@pytest.mark.parametrize("dtype,taken", [(torch.bfloat16, True), (torch.float32, False),
                                         (torch.float16, False)])
def test_gate_predicates(dtype, taken):
    """The MLP and attention gates are predicates of the activations' dtype
    alone: no shape or size threshold. The point encoder's also reads the
    group size and widths its kernel takes; at the tokenizer's own (M = 32,
    the published widths) it too follows the dtype alone, at any batch."""
    for shape in ((1, 8), (4096, 1024)):
        x = torch.zeros(shape, dtype=dtype)
        assert fused_mlp_applicable(x) is taken
        assert flash_attention_applicable(x.view(1, 1, *shape)) is taken
    ws = [torch.zeros(a, b) for a, b in ((3, 128), (128, 256), (512, 512), (512, 256))]
    for groups in ((1, 1), (64, 512)):
        nb = torch.zeros(*groups, 32, 3, dtype=dtype)
        assert point_encoder_applicable(nb, *ws) is taken


def test_masked_bf16_attention_stays_plain(monkeypatch):
    """A mask always takes the plain path (the kernel has none), in bf16 as
    in fp32, as in JAX."""
    calls = _spy(monkeypatch, PA, "flash_attention")
    q = torch.from_numpy(_x(1, 2, 5, 64)).bfloat16()
    PA.dot_product_attention(q, q, q, mask=PA.causal_mask(5))
    assert calls == []
