"""The kernel-backed autograd Functions of the port (fused MLP with its
save-preact variant, attention, fused LN + projection) on CPU, held against
the JAX package's Pallas kernels in interpret mode and the gradients of its
custom_vjps, and against torch autograd of the port's plain versions."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import vitlens_tpu.ops.flash_attention as FA
from vitlens_tpu.models import layers as JL
from vitlens_tpu.ops import fused_ln_proj as FL
from vitlens_tpu.ops import fused_mlp as FM
from vitlens_tpu_torch.models import layers as PL
from vitlens_tpu_torch.ops import flash_attention as PFA
from vitlens_tpu_torch.ops import fused_ln_proj as PFL
from vitlens_tpu_torch.ops import fused_mlp as PFM
from vitlens_tpu_torch.weights.from_jax import load_params
from tests.test_torch_threads import share_cores

share_cores()

BF16_ULP = 2.0 ** -7  # spacing of bf16 values in [1, 2)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1e-12, np.abs(want).max())


def _within_bf16_rounding(got, want, ulps=1):
    """max |got - want| at most ``ulps`` bf16 spacings at the scale of
    max |want|: a bf16 LN output that rounds the other way after an fp32
    summation-order difference moves the outputs by up to about one spacing
    of its own size times a weight."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() <= ulps * BF16_ULP * np.abs(want).max()


def _ln_proj_args(m, d, n, seed=0):
    rng = np.random.RandomState(seed)
    return ((rng.randn(m, d) * 0.5).astype(np.float32),
            (rng.rand(1, d) + 0.5).astype(np.float32),
            (rng.randn(1, d) * 0.1).astype(np.float32),
            (rng.randn(d, n) * 0.05).astype(np.float32),
            (rng.randn(1, n) * 0.1).astype(np.float32))


def _mlp_args(m=200, d=128, h=256, seed=0):
    rng = np.random.RandomState(seed)
    return ((rng.randn(m, d) * 0.5).astype(np.float32),
            (rng.rand(1, d) + 0.5).astype(np.float32),
            (rng.randn(1, d) * 0.1).astype(np.float32),
            (rng.randn(d, h) * 0.05).astype(np.float32),
            (rng.randn(1, h) * 0.1).astype(np.float32),
            (rng.randn(h, d) * 0.05).astype(np.float32),
            (rng.randn(1, d) * 0.1).astype(np.float32))


# Weights (positions 0, 3, 5 of the MLP, 0 and 3 of ln_proj) take the compute
# dtype; LN parameters and biases stay fp32, as the wrappers require.
def _jax(args, dtype, wide=(0, 3, 5)):
    return tuple(jnp.asarray(a, dtype if i in wide else jnp.float32)
                 for i, a in enumerate(args))


def _torch(args, dtype, wide=(0, 3, 5), grad=False):
    out = []
    for i, a in enumerate(args):
        t = torch.from_numpy(a[0] if a.shape[0] == 1 and a.ndim == 2 else a)
        t = t.to(dtype if i in wide else torch.float32)
        out.append(t.requires_grad_(grad))
    return tuple(out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_proj_reference_matches_pallas_kernel(dtype, monkeypatch):
    """M=200 leaves a partial last 128-row tile. fp32: 1e-5 relative. bf16:
    within one bf16 spacing at the output's scale (the same fp32 LN, products
    and bias; only the summation order differs)."""
    monkeypatch.setattr(FL, "_INTERPRET", True)
    args = _ln_proj_args(200, 128, 384)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = FL._pallas_ln_proj(*_jax(args, jdt, (0, 3)), eps=1e-5, tm=128)
    got = PFL.fused_ln_proj(*_torch(args, tdt, (0, 3)), eps=1e-5)
    assert got.dtype == tdt and tuple(got.shape) == (200, 384)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        assert _rel(got.numpy(), want) < 1e-5
    else:
        assert _within_bf16_rounding(got.float().numpy(), want)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_preact_matches_pallas_kernel(act, dtype, monkeypatch):
    """(out, a) of the save-preact variant against the JAX kernel's two
    outputs (save_preact=True), M=200 ragged against the 128-row tile.
    fp32: 1e-5 relative. bf16: 2.5e-2 relative for out (the JAX kernel test's
    own bound), and a within two bf16 spacings at its scale (the plain
    version rounds the product before adding b1, the kernel adds b1 in
    fp32)."""
    monkeypatch.setattr(FM, "_INTERPRET", True)
    args = _mlp_args()
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want_out, want_a = FM._pallas_fused_mlp(*_jax(args, jdt), act=act, eps=1e-5,
                                            tm=128, save_preact=True)
    got_out, got_a = PFM.fused_mlp_save_preact(*_torch(args, tdt), act=act)
    assert got_a.dtype == tdt and tuple(got_a.shape) == (200, 256)
    want_a = np.asarray(want_a.astype(jnp.float32))
    want_out = np.asarray(want_out.astype(jnp.float32))
    if dtype == "float32":
        assert _rel(got_a.numpy(), want_a) < 1e-5
        assert _rel(got_out.numpy(), want_out) < 1e-5
    else:
        assert _within_bf16_rounding(got_a.float().numpy(), want_a, ulps=2)
        assert _rel(got_out.float().numpy(), want_out) < 2.5e-2
    # the plain variant's output is the save-preact variant's
    plain = PFM.fused_mlp(*_torch(args, tdt), act=act)
    assert torch.equal(plain, got_out)


def _grads_close(got, want, tol=1e-5):
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w)
        assert _rel(np.reshape(g, w.shape), w) < tol, i


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_fused_mlp_function_grads_match_jax(act, monkeypatch):
    """fp32, M=200: every gradient of FusedMLPFunction against jax.grad
    through the JAX _make_op custom_vjp (its forward the interpret-mode
    kernel), and against torch autograd of the plain version; 1e-5
    relative."""
    monkeypatch.setattr(FM, "_INTERPRET", True)
    args = _mlp_args(seed=3)
    cot = np.random.RandomState(4).randn(200, 128).astype(np.float32)
    op = FM._make_op(act, 1e-5)
    want = jax.grad(lambda *a: jnp.sum(op(*a) * cot), argnums=tuple(range(7)))(
        *_jax(args, jnp.float32))
    t = _torch(args, torch.float32, grad=True)
    out = PFM.fused_mlp(*t, act=act)
    assert out.grad_fn is not None and "FusedMLPFunction" in type(out.grad_fn).__name__
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), t)
    _grads_close(got, want)
    plain = PFM.fused_mlp_reference(*t, act=act)
    _grads_close(got, torch.autograd.grad((plain * torch.from_numpy(cot)).sum(), t))


def test_fused_mlp_function_computes_only_what_is_asked():
    """With the weights frozen, the backward returns dx alone and it equals
    the full backward's dx."""
    args = _mlp_args(m=16, seed=5)
    x, *rest = _torch(args, torch.float32)
    x.requires_grad_(True)
    cot = torch.randn(16, 128, generator=torch.Generator().manual_seed(0))
    out = PFM.fused_mlp(x, *rest)
    (dx,) = torch.autograd.grad((out * cot).sum(), [x])
    full = PFM.fused_mlp_backward(cot, x.detach(), PFM.fused_mlp_reference(
        x.detach(), *rest, save_preact=True)[1], rest[0], rest[1], rest[2],
        rest[4], "gelu", 1e-5)
    assert torch.allclose(dx, full[0], rtol=1e-6, atol=1e-7)
    part = PFM.fused_mlp_backward(cot, x.detach(), PFM.fused_mlp_reference(
        x.detach(), *rest, save_preact=True)[1], rest[0], rest[1], rest[2],
        rest[4], "gelu", 1e-5, needs=(True,) + (False,) * 6)
    assert part[0] is not None and all(g is None for g in part[1:])


@pytest.fixture()
def interp(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("shape", [(2, 3, 40, 56), (1, 2, 70, 33)])
def test_attention_function_grads_match_jax(interp, shape):
    """fp32: dq, dk, dv of FlashAttentionFunction against jax.grad through
    the JAX flash_attention custom_vjp (interpret-mode kernel forward) and
    against torch autograd of the plain version; 1e-5 relative."""
    b, h, nq, nk = shape
    rng = np.random.RandomState(6)
    q, k, v = (rng.randn(b, h, n, 64).astype(np.float32) for n in (nq, nk, nk))
    cot = rng.randn(b, h, nq, 64).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(FA.flash_attention(*a, None) * cot),
                    argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v))
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = PFA.flash_attention(*t)
    assert "FlashAttentionFunction" in type(out.grad_fn).__name__
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), t)
    _grads_close(got, want)
    plain = PFA.attention_reference(*t)
    _grads_close(got, torch.autograd.grad((plain * torch.from_numpy(cot)).sum(), t))


def test_ln_proj_function_grads_match_jax(monkeypatch):
    """fp32, M=200: dx, dLN, dW, db of FusedLnProjFunction against jax.grad
    through the JAX _make_op custom_vjp (interpret-mode kernel forward) and
    against torch autograd of the plain version; 1e-5 relative."""
    monkeypatch.setattr(FL, "_INTERPRET", True)
    args = _ln_proj_args(200, 128, 384, seed=7)
    cot = np.random.RandomState(8).randn(200, 384).astype(np.float32)
    op = FL._make_op(1e-5)
    want = jax.grad(lambda *a: jnp.sum(op(*a) * cot), argnums=tuple(range(5)))(
        *_jax(args, jnp.float32, (0, 3)))
    t = _torch(args, torch.float32, (0, 3), grad=True)
    out = PFL.fused_ln_proj(*t)
    assert "FusedLnProjFunction" in type(out.grad_fn).__name__
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), t)
    _grads_close(got, want)
    plain = PFL.ln_proj_reference(*t)
    _grads_close(got, torch.autograd.grad((plain * torch.from_numpy(cot)).sum(), t))


def test_resblock_front_half_opt_in_matches_jax(monkeypatch):
    """With VITLENS_ENABLE_FUSED_LNQKV set, a bf16 port block (D=128) sends
    its front half through fused_ln_qkv, as the JAX block does when the
    opt-in applies (forced on here: the JAX gate also asks for a TPU and
    4096 rows). The packed qkv within one bf16 spacing of the JAX kernel's
    (interpret mode); the block's output within 2.5e-2 relative (bf16
    attention rounds at other places in the two packages). Without the
    variable the port takes ln_1 + the qkv matmul."""
    monkeypatch.setattr(FL, "_INTERPRET", True)
    monkeypatch.setattr(FL, "_MIN_ROWS", 0)
    monkeypatch.setattr(JL, "fused_ln_proj_available", lambda: True)
    p = JL.resblock_init(jax.random.PRNGKey(9), 128, 4.0)
    x = np.random.RandomState(9).randn(2, 37, 128).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    want_qkv = FL.fused_ln_qkv(xj, p["ln_1"], p["attn"])
    want = JL.resblock(xj, p, 2, JL.gelu)

    block = load_params(PL.ResBlock(128, 2, 4.0), p)
    xt = torch.from_numpy(x).bfloat16()
    calls = []
    real = PL.fused_ln_qkv
    monkeypatch.setattr(PL, "fused_ln_qkv",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setenv("VITLENS_ENABLE_FUSED_LNQKV", "1")
    got = block(xt)
    assert calls == [1]
    got_qkv = PFL.fused_ln_qkv(xt, block.ln_1, block.attn)
    assert _within_bf16_rounding(got_qkv.float().numpy(),
                                 np.asarray(want_qkv.astype(jnp.float32)))
    assert _rel(got.float().numpy(), np.asarray(want.astype(jnp.float32))) < 2.5e-2
    monkeypatch.delenv("VITLENS_ENABLE_FUSED_LNQKV")
    block(xt)
    assert calls == [1]
    assert not PFL.fused_ln_proj_applicable(xt.float(), block.attn.qkv_w)
    assert not PFL.fused_ln_proj_applicable(torch.zeros(2, 96, dtype=torch.bfloat16),
                                            torch.zeros(96, 288))


def test_cpu_functions_launch_no_kernel():
    """Forward and backward of the Functions on CPU tensors launch nothing."""
    before = (PFM.fused_mlp.launches, PFM.fused_mlp_save_preact.launches,
              PFA.flash_attention.launches, PFL.fused_ln_proj.launches)
    t = _torch(_mlp_args(m=8), torch.float32, grad=True)
    PFM.fused_mlp(*t).sum().backward()
    t = _torch(_ln_proj_args(8, 128, 384), torch.float32, (0, 3), grad=True)
    PFL.fused_ln_proj(*t).sum().backward()
    q = torch.randn(1, 2, 5, 64, requires_grad=True)
    PFA.flash_attention(q, q, q).sum().backward()
    assert before == (PFM.fused_mlp.launches, PFM.fused_mlp_save_preact.launches,
                      PFA.flash_attention.launches,
                      PFL.fused_ln_proj.launches) == (0, 0, 0, 0)
