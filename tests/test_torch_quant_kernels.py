"""The plain versions of the quantise kernel and of the int8 product's DEQUANT
epilogue (``ops/int8_matmul.py``), which the kernels are held to bit for bit
on the card, held bit for bit against the JAX package's ``quant.int8_matmul``
on the CPU: its head (row scales and int8 rows) and its tail (the
dequantised output for a given int32 product) are read out of the JAX
function itself by replacing ``jax.lax.dot_general`` while it runs. The rows
include all-zero rows (the 1e-12 floor), exact .5 ties (round half to even)
and rows whose extremes are negative; and the wrappers' argument checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitlens_tpu import quant as JQ
from vitlens_tpu_torch import quant as PQ
from vitlens_tpu_torch.ops import int8_matmul as PI
from tests.test_torch_threads import share_cores

share_cores()


def _rows(m, k, seed=0):
    """fp32 rows holding bf16 values: a zero row, a row of .5 ties at scale
    1 (its amax is 127), a row with negative extremes, then random rows of
    several magnitudes."""
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32) * rng.choice([1e-3, 1.0, 40.0], (m, 1))
    x[0] = 0
    x[1] = np.resize(np.float32([127, -0.5, 0.5, 1.5, 2.5, -1.5, -2.5, 3.5]), k)
    x[2] = -np.abs(x[2]) * 3
    return np.asarray(torch.from_numpy(x).bfloat16().float())


def _jax_head(x, monkeypatch):
    """(xi, xs) as JAX's int8_matmul computes them for x: the product is
    replaced by ones, so with unit column scales and no bias the output is
    the row scale itself, in fp32."""
    seen = {}

    def dot(xi, w, *args, **kwargs):
        seen["xi"] = np.asarray(xi)
        return jnp.ones((xi.shape[0], w.shape[1]), jnp.int32)

    monkeypatch.setattr(jax.lax, "dot_general", dot)
    y = JQ.int8_matmul(jnp.asarray(x), jnp.zeros((x.shape[1], 8), jnp.int8),
                       jnp.ones((1, 8), jnp.float32))
    return seen["xi"], np.asarray(y)[:, :1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_head_equals_jax(dtype, monkeypatch):
    x = _rows(40, 96)
    want_i, want_s = _jax_head(x, monkeypatch)
    xi, xs = PI.int8_quantize(torch.from_numpy(x).to(dtype))
    assert xi.dtype == torch.int8 and xs.dtype == torch.float32
    assert tuple(xs.shape) == (40, 1)
    np.testing.assert_array_equal(xi.numpy(), want_i)
    np.testing.assert_array_equal(xs.numpy().view(np.int32), want_s.view(np.int32))
    assert float(xs[0]) == np.float32(1e-12) and not xi[0].any()
    assert float(xs[1]) == 1.0
    assert xi[1, :8].tolist() == [127, 0, 0, 2, 2, -2, -2, 4]
    assert int(xi[2].min()) == -127


def test_quantize_divides_exactly():
    """The row scale is amax / 127 correctly rounded (an IEEE division), not
    amax times the rounded reciprocal of 127: the two differ on these rows."""
    amax = np.float32([1.0, 1.125, 1.625, 3.25, 9.0, 100.0])
    x = np.zeros((6, 32), np.float32)
    x[:, 0] = amax
    _, xs = PI.int8_quantize_reference(torch.from_numpy(x))
    exact = (amax.astype(np.float64) / 127).astype(np.float32)
    np.testing.assert_array_equal(xs.numpy()[:, 0], exact)
    assert (amax * np.float32(1 / 127) != exact).any()


@pytest.mark.parametrize("bias", [True, False])
def test_dequant_tail_equals_jax(bias, monkeypatch):
    """For the same int32 product, the bf16 output of the port's plain
    dequantise equals JAX's bit for bit (row scale, column scale and bias
    applied in fp32 in JAX's order, one rounding)."""
    rng = np.random.RandomState(3)
    x = _rows(24, 64, seed=3)
    acc = rng.randint(-400000, 400000, (24, 40)).astype(np.int32)
    w_s = (rng.rand(1, 40) * 0.01 + 1e-5).astype(np.float32)
    b = rng.randn(40).astype(np.float32) if bias else None
    monkeypatch.setattr(jax.lax, "dot_general", lambda *a, **k: jnp.asarray(acc))
    want = JQ.int8_matmul(jnp.asarray(x, jnp.bfloat16), jnp.zeros((64, 40), jnp.int8),
                          jnp.asarray(w_s), None if b is None else jnp.asarray(b))
    _, xs = PI.int8_quantize(torch.from_numpy(x).bfloat16())
    got = PI.dequant_reference(torch.from_numpy(acc), xs, torch.from_numpy(w_s),
                               None if b is None else torch.from_numpy(b),
                               torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


@pytest.mark.parametrize("bias", [True, False])
def test_quant_int8_matmul_equals_jax_bitwise(bias):
    """End to end through the real products: the port's quant.int8_matmul
    (quantise -> DEQUANT product, their plain versions on the CPU) equals
    JAX's bit for bit in bf16, and equals the port's composed plain
    version."""
    rng = np.random.RandomState(4)
    x = _rows(33, 128, seed=4)
    w = (rng.randn(128, 256) * 0.05).astype(np.float32)
    b = rng.randn(256).astype(np.float32) if bias else None
    wq, ws = JQ.quantize_weight(jnp.asarray(w))
    want = JQ.int8_matmul(jnp.asarray(x, jnp.bfloat16), wq, ws,
                          None if b is None else jnp.asarray(b))
    tq, tw = torch.from_numpy(np.array(wq)), torch.from_numpy(np.array(ws))
    tb = None if b is None else torch.from_numpy(b)
    tx = torch.from_numpy(x).bfloat16()
    got = PQ.int8_matmul(tx, tq, tw, tb, tq.t().contiguous())
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    assert torch.equal(got, PQ.int8_matmul_reference(tx, tq, tw, tb))
    assert (PI.int8_quantize.launches, PI.int8_matmul_dequant.launches) == (0, 0)


def test_quantize_argument_checks():
    PI._check_quantize_args(torch.zeros(4, 64, dtype=torch.bfloat16))
    PI._check_quantize_args(torch.zeros(4, 64))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        PI._check_quantize_args(torch.zeros(4, 64, dtype=torch.float16))
    with pytest.raises(ValueError, match="multiple of 32"):
        PI._check_quantize_args(torch.zeros(4, 48, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match=r"\[M, K\]"):
        PI._check_quantize_args(torch.zeros(2, 4, 64, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        PI._check_quantize_args(torch.zeros(64, 64, dtype=torch.bfloat16).t()[:, :64])


def test_dequant_argument_checks():
    a = torch.zeros(8, 64, dtype=torch.int8)
    b = torch.zeros(64, 128, dtype=torch.int8)
    bt, xs, ws, bias = b.t().contiguous(), torch.ones(8, 1), torch.ones(1, 128), torch.zeros(128)
    for dtype in (torch.bfloat16, torch.float32):
        PI._check_dequant_args(a, b, bt, xs, ws, bias, dtype)
    PI._check_dequant_args(a, b, bt, xs, ws, None, torch.bfloat16)
    with pytest.raises(ValueError, match="output dtype"):
        PI._check_dequant_args(a, b, bt, xs, ws, bias, torch.float16)
    with pytest.raises(ValueError, match="xs must be 8"):
        PI._check_dequant_args(a, b, bt, torch.ones(4, 1), ws, bias, torch.bfloat16)
    with pytest.raises(ValueError, match="w_s must be 128 torch.float32"):
        PI._check_dequant_args(a, b, bt, xs, ws.double(), bias, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        PI._check_dequant_args(a, b, bt, xs, ws, torch.zeros(128, 2)[:, 0],
                               torch.bfloat16)
    with pytest.raises(ValueError, match="is on"):
        PI._check_dequant_args(a, b, bt, xs.to("meta"), ws, bias, torch.bfloat16)
    with pytest.raises(ValueError, match="of 128"):  # the product's own checks
        PI._check_dequant_args(a, torch.zeros(64, 96, dtype=torch.int8),
                               torch.zeros(96, 64, dtype=torch.int8), xs,
                               torch.ones(96), None, torch.bfloat16)
