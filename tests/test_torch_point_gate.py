"""The point encoder's gate, held against the JAX package's: bf16 point
groups go to the kernel exactly where JAX's ``point_encoder_applicable``
sends them to its Pallas kernel (JAX's TPU VMEM cap aside), within the
port's kernel caps, and every other group size or width computes on the
plain path (``point_encoder_reference``), which matches JAX's XLA path and
its Pallas kernel (interpret mode) at group sizes the kernel cannot take
(M = 24) and can (M = 48). On CPU tensors the wrapper runs the plain
version too, so a spy in the tokenizer's module shows which way a call
went; on the card the plain way launches no point-encoder kernel
(``chip_smoke.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitlens_tpu.adapters import tokenizers as JT
from vitlens_tpu.config import PointAdapterConfig as JaxPointConfig
from vitlens_tpu.ops import fused_point_encoder as FPE
from vitlens_tpu_torch import config as PC
from vitlens_tpu_torch.adapters import tokenizers as PT
from vitlens_tpu_torch.ops import fused_point_encoder as PFE
from vitlens_tpu_torch.weights.from_jax import load_params, load_state
from tests.test_torch_threads import share_cores

share_cores()

GROUP_SIZES = (8, 16, 24, 32, 48, 64, 128)
KERNEL_WIDTHS = ((128, 256, 512, 256), (128, 256, 512, 128),
                 (128, 256, 512, 384), (128, 256, 512, 512))
OTHER_WIDTHS = ((128, 256, 512, 200), (96, 256, 512, 256), (128, 192, 512, 256))


def _weights(widths, w3_rows=None):
    """Zero weights of the given widths: torch [in, out] and the JAX tree."""
    c1, c2, c3, c4 = widths
    shapes = {"conv1": (3, c1), "conv2": (c1, c2),
              "conv3": (2 * c2 if w3_rows is None else w3_rows, c3),
              "conv4": (c3, c4)}
    enc_p = {k: {"w": jnp.zeros(s, jnp.float32), "b": jnp.zeros(s[1], jnp.float32)}
             for k, s in shapes.items()}
    torch_w = [torch.zeros(s, dtype=torch.bfloat16) for s in shapes.values()]
    return torch_w, enc_p


def _gates(m, widths, dtype="bf16", w3_rows=None):
    torch_w, enc_p = _weights(widths, w3_rows)
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if dtype == "bf16"
                else (torch.float32, jnp.float32))
    nb_t = torch.zeros(2, 3, m, 3, dtype=tdt)
    nb_j = jnp.zeros((2, 3, m, 3), jdt)
    return (PFE.point_encoder_applicable(nb_t, *torch_w),
            FPE.point_encoder_applicable(nb_j, enc_p))


def _meta_args(m, widths):
    """The wrapper's arguments on the meta device: shapes and dtypes only."""
    c1, c2, c3, c4 = widths
    bf, f32, meta = torch.bfloat16, torch.float32, "meta"
    z = functools.partial(torch.empty, device=meta)
    bn = lambda n: tuple(z(n, dtype=f32) for _ in range(4))  # noqa: E731
    return [z(2, 3, m, 3, dtype=bf), z(3, c1, dtype=bf), z(c1, dtype=f32), bn(c1),
            z(c1, c2, dtype=bf), z(c2, dtype=f32), z(2 * c2, c3, dtype=bf),
            z(c3, dtype=f32), bn(c3), z(c3, c4, dtype=bf), z(c4, dtype=f32)]


@pytest.mark.parametrize("widths", KERNEL_WIDTHS + OTHER_WIDTHS)
@pytest.mark.parametrize("m", GROUP_SIZES)
def test_gate_agrees_with_jax(m, widths):
    """bf16: the port's gate is True exactly where JAX's is; where it is,
    the wrapper's own checks accept the arguments; fp32 never passes."""
    port, jax_gate = _gates(m, widths)
    assert port == bool(jax_gate)
    assert port == (m % 16 == 0 and widths in KERNEL_WIDTHS)
    if port:
        PFE._check_cuda_args(*_meta_args(m, widths))
    else:
        with pytest.raises(ValueError, match="group size|widths"):
            PFE._check_cuda_args(*_meta_args(m, widths))
    assert _gates(m, widths, dtype="fp32") == (False, False)


@pytest.mark.parametrize("m,widths", [(32, (128, 256, 384, 256)),
                                      (32, (256, 256, 512, 256)),
                                      (144, (128, 256, 512, 256))])
def test_gate_keeps_the_kernel_caps(m, widths):
    """Where JAX's kernel (VMEM-resident on the TPU) takes a shape that the
    port's kernel cannot (C1..C3 other than the tokenizer's fixed 128, 256,
    512, M past the 128-row tile), the port's gate sends it to the plain
    path and the wrapper refuses it."""
    port, jax_gate = _gates(m, widths)
    assert bool(jax_gate) and not port
    with pytest.raises(ValueError, match="group size|widths"):
        PFE._check_cuda_args(*_meta_args(m, widths))


def test_gate_checks_conv3_rows():
    """As JAX's: a conv3 weight that is not [2 * C2, C3] is never the
    kernel's."""
    assert _gates(32, KERNEL_WIDTHS[0], w3_rows=384) == (False, False)


def _enc(seed):
    rng = np.random.RandomState(seed)
    w = lambda a, b, s: (rng.randn(a, b) * s).astype(np.float32)  # noqa: E731
    v = lambda n, s: (rng.randn(n) * s).astype(np.float32)  # noqa: E731
    p = {"conv1": {"w": w(3, 128, 0.3), "b": v(128, 0.1)},
         "conv2": {"w": w(128, 256, 0.05), "b": v(256, 0.1)},
         "conv3": {"w": w(512, 512, 0.04), "b": v(512, 0.1)},
         "conv4": {"w": w(512, 256, 0.04), "b": v(256, 0.1)},
         "bn1": {"scale": 1 + 0.1 * v(128, 1.0), "bias": v(128, 0.1)},
         "bn2": {"scale": 1 + 0.1 * v(512, 1.0), "bias": v(512, 0.1)}}
    s = {"bn1": {"mean": v(128, 0.2), "var": 1 + 0.5 * np.abs(v(128, 1.0))},
         "bn2": {"mean": v(512, 0.2), "var": 1 + 0.5 * np.abs(v(512, 1.0))}}
    return p, s


def _torch_enc(p, s, dtype):
    t = torch.from_numpy
    bn = lambda k: (t(s[k]["mean"]), t(s[k]["var"]),  # noqa: E731
                    t(p[k]["scale"]), t(p[k]["bias"]))
    return (t(p["conv1"]["w"]).to(dtype), t(p["conv1"]["b"]), bn("bn1"),
            t(p["conv2"]["w"]).to(dtype), t(p["conv2"]["b"]),
            t(p["conv3"]["w"]).to(dtype), t(p["conv3"]["b"]), bn("bn2"),
            t(p["conv4"]["w"]).to(dtype), t(p["conv4"]["b"]))


def _jax_tree(tree):
    return {k: _jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _nb(m, seed):
    return (np.random.RandomState(seed).randn(2, 5, m, 3) * 0.3).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _cos(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(got @ want / np.linalg.norm(got) / np.linalg.norm(want))


@pytest.mark.parametrize("m", [24, 48])
def test_plain_path_matches_xla_reference_fp32(m):
    """fp32: the plain version against JAX's XLA reference, 1e-5 of
    max|ref| (summation order)."""
    p, s = _enc(seed=m)
    nb = _nb(m, seed=m + 1)
    want = FPE.xla_reference(jnp.asarray(nb), _jax_tree(p), _jax_tree(s))
    got = PFE.point_encoder_reference(torch.from_numpy(nb), *_torch_enc(p, s, torch.float32))
    assert tuple(got.shape) == (2, 5, 256)
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("m", [24, 48])
def test_plain_path_matches_pallas_kernel_bf16(monkeypatch, m):
    """bf16: the plain version against JAX's Pallas kernel in interpret
    mode, by cosine (bf16 roundings at other points), with a partial last
    tile of groups."""
    monkeypatch.setattr(FPE, "_INTERPRET", True)
    monkeypatch.setenv("VITLENS_POINT_ENC_TG", "4")
    p, s = _enc(seed=m + 2)
    nb = _nb(m, seed=m + 3)
    nb_bf = torch.from_numpy(nb).to(torch.bfloat16)
    want = FPE.fused_point_encoder(jnp.asarray(nb, jnp.bfloat16), _jax_tree(p),
                                   _jax_tree(s))
    got = PFE.point_encoder_reference(nb_bf, *_torch_enc(p, s, torch.bfloat16))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 5, 256)
    assert _cos(got.float().numpy(), np.asarray(want, np.float32)) >= 0.999
    assert _rel(got.float().numpy(), want) < 2e-2


def _spy(monkeypatch):
    calls = []
    real = PT.fused_point_encoder

    def spy(*args, **kwargs):
        calls.append(args[0].shape[2])
        return real(*args, **kwargs)

    monkeypatch.setattr(PT, "fused_point_encoder", spy)
    return calls


@pytest.mark.parametrize("group_size,kernel", [(24, False), (48, True)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_tokenizer_group_sizes_match_jax(monkeypatch, group_size, kernel, dtype):
    """The whole PointTokenizer at group_size 24 and 48 against JAX's
    point_tokenizer_apply on the same weights, BN statistics and points:
    bf16 calls the kernel's wrapper only at 48 (M = 24 takes the plain
    path, as JAX sends it to XLA), fp32 never; tokens within 1e-4 relative
    in fp32, by cosine in bf16."""
    small = dict(npoints=256, num_group=12, group_size=group_size)
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if dtype == "bf16"
                else (torch.float32, jnp.float32))
    jcfg = JaxPointConfig(**small, knn_exact=True)
    p, s = jax.jit(JT.point_tokenizer_init, static_argnums=1)(
        jax.random.PRNGKey(group_size), jcfg)
    rng = np.random.RandomState(group_size)
    for bn, c in (("bn1", 128), ("bn2", 512)):
        s["encoder"][bn] = {"mean": jnp.asarray(0.2 * rng.randn(c), jnp.float32),
                            "var": jnp.asarray(0.5 + rng.rand(c), jnp.float32)}
    pts = (rng.randn(2, 256, 3) * 0.3).astype(np.float32)
    pts = np.array(jnp.asarray(pts, jdt).astype(jnp.float32))
    (want, _), _ = jax.jit(functools.partial(JT.point_tokenizer_apply, cfg=jcfg))(
        p, s, jnp.asarray(pts, jdt))
    tok = PT.PointTokenizer(PC.PointAdapterConfig(**small))
    tok.init_(torch.Generator().manual_seed(0))
    load_params(tok, p)
    load_state(tok, s)
    if dtype == "bf16":
        tok.to(torch.bfloat16)
    calls = _spy(monkeypatch)
    with torch.no_grad():
        got, _ = tok(torch.from_numpy(pts).to(tdt))
    assert calls == ([group_size] if kernel and dtype == "bf16" else [])
    assert tuple(got.shape) == (2, 12, 384) and got.dtype == tdt
    if dtype == "fp32":
        assert _rel(got.numpy(), want) < 1e-4
    else:
        assert _cos(got.float().numpy(), np.asarray(want, np.float32)) >= 0.999


@pytest.mark.parametrize("encoder_dims", [384, 512])
def test_tokenizer_encoder_dims_take_the_kernel(monkeypatch, encoder_dims):
    """A bf16 PointTokenizer whose encoder_dims (the kernel's C4) is a
    multiple of 128 other than 256 calls the kernel's wrapper, as JAX's
    gate sends it to its Pallas kernel, and its tokens agree with JAX's
    by cosine."""
    small = dict(npoints=256, num_group=12, group_size=32,
                 encoder_dims=encoder_dims)
    jcfg = JaxPointConfig(**small, knn_exact=True)
    p, s = jax.jit(JT.point_tokenizer_init, static_argnums=1)(
        jax.random.PRNGKey(encoder_dims), jcfg)
    rng = np.random.RandomState(encoder_dims)
    pts = (rng.randn(2, 256, 3) * 0.3).astype(np.float32)
    pts = np.array(jnp.asarray(pts, jnp.bfloat16).astype(jnp.float32))
    (want, _), _ = jax.jit(functools.partial(JT.point_tokenizer_apply, cfg=jcfg))(
        p, s, jnp.asarray(pts, jnp.bfloat16))
    tok = PT.PointTokenizer(PC.PointAdapterConfig(**small))
    tok.init_(torch.Generator().manual_seed(0))
    load_params(tok, p)
    load_state(tok, s)
    tok.to(torch.bfloat16)
    calls = _spy(monkeypatch)
    with torch.no_grad():
        got, _ = tok(torch.from_numpy(pts).to(torch.bfloat16))
    assert calls == [32]
    assert tuple(got.shape) == (2, 12, 384) and got.dtype == torch.bfloat16
    assert _cos(got.float().numpy(), np.asarray(want, np.float32)) >= 0.999
