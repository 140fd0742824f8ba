"""The port's point-cloud kernel modules on CPU (ops/fps.py and
ops/fused_point_encoder.py), held against the JAX package: its XLA FPS
recurrence and both Pallas FPS kernels (interpret mode), its exact kNN and
grouping, and the mini-PointNet's XLA reference and Pallas kernel (interpret
mode). On CPU tensors the port's wrappers take their plain PyTorch versions,
so these tests fix the arithmetic that the CUDA kernels are held to on the
card (chip_smoke.py), and that the CPU path launches nothing."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import vitlens_tpu.ops.fps as JF
from vitlens_tpu.ops import fused_point_encoder as FPE
from vitlens_tpu_torch.ops import fps as PF
from vitlens_tpu_torch.ops import fused_point_encoder as PFE
from tests.test_torch_threads import share_cores

share_cores()


def _xyz(b, n, seed=0):
    return np.random.RandomState(seed).randn(b, n, 3).astype(np.float32)


def _starts(kind, b, n):
    if kind == "zero":
        return np.zeros(b, np.int32)
    return np.array([0, 5, 17, n - 1][:b], np.int32)


@pytest.mark.parametrize("n", [256, 250])
@pytest.mark.parametrize("starts", ["zero", "mixed"])
def test_fps_reference_matches_jax_kernels(monkeypatch, n, starts):
    """Index-exact against the XLA recurrence, the all-batch Pallas kernel
    and the per-row Pallas kernel (both in interpret mode), for N a multiple
    of 128 and not, with zero and mixed starts."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    xyz = _xyz(4, n, seed=n)
    st = _starts(starts, 4, n)
    got = PF.fps_indices(torch.from_numpy(xyz), 48, torch.from_numpy(st))
    assert got.dtype == torch.int32 and tuple(got.shape) == (4, 48)
    jx, js = jnp.asarray(xyz), jnp.asarray(st)
    for want in (JF._fps_indices_xla(jx, 48, js),
                 JF._fps_indices_pallas_batched(jx, 48, js, interpret=True),
                 JF._fps_indices_pallas(jx, 48, js)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fps_indices_starts_and_shape_check():
    xyz = torch.from_numpy(_xyz(3, 100, seed=1))
    assert (PF.fps_indices(xyz, 8)[:, 0] == 0).all()
    g1 = torch.Generator().manual_seed(7)
    g2 = torch.Generator().manual_seed(7)
    a = PF.fps_indices(xyz, 8, generator=g1)
    b = PF.fps_indices(xyz, 8, generator=g2)
    assert torch.equal(a, b) and (a[:, 0] >= 0).all() and (a[:, 0] < 100).all()
    assert PF.fps_indices(xyz, 8, start=a[:, 0])[:, 1:].equal(a[:, 1:])
    with pytest.raises(ValueError, match=r"\[B, N, 3\]"):
        PF.fps_indices(torch.zeros(2, 50, 6), 4)
    pts6 = torch.cat([xyz, torch.randn(3, 100, 3)], -1)
    centers = PF.fps(pts6, 8)
    np.testing.assert_array_equal(centers[..., :3].numpy(),
                                  PF.fps(xyz, 8).numpy())


def test_knn_and_grouping_match_jax():
    """fp32: the sorted neighbour sets equal JAX's exact kNN; where they
    differ, the swapped points tie with the k-th distance to 1e-6 relative.
    group_points' neighbourhoods and centers then match JAX's."""
    xyz = _xyz(2, 300, seed=2)
    center_idx = np.asarray(JF._fps_indices_xla(
        jnp.asarray(xyz), 24, jnp.zeros(2, jnp.int32)))
    query = np.take_along_axis(xyz, center_idx[..., None], axis=1)
    want = np.sort(np.asarray(JF.knn_indices(jnp.asarray(xyz),
                                             jnp.asarray(query), 16,
                                             exact=True)), -1)
    got = np.sort(PF.knn_indices(torch.from_numpy(xyz), torch.from_numpy(query),
                                 16).numpy(), -1)
    d = ((query[:, :, None, :] - xyz[:, None, :, :]) ** 2).sum(-1)
    kth = np.sort(d, -1)[..., 15]
    for b, s in zip(*np.nonzero((got != want).any(-1))):
        for i in set(got[b, s]) ^ set(want[b, s]):
            assert abs(d[b, s, i] - kth[b, s]) <= 1e-6 * kth[b, s]
    assert (got == want).mean() > 0.99

    jnb, jc = JF.group_points(jnp.asarray(xyz), 24, 16, knn_exact=True)
    pnb, pc = PF.group_points(torch.from_numpy(xyz), 24, 16)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(np.sort(pnb.numpy(), axis=2),
                               np.sort(np.asarray(jnb), axis=2), atol=1e-6)


def _enc(seed=0, c4=256):
    """JAX-layout encoder params and BN state with nontrivial statistics."""
    rng = np.random.RandomState(seed)
    w = lambda a, b, s: (rng.randn(a, b) * s).astype(np.float32)  # noqa: E731
    v = lambda n, s: (rng.randn(n) * s).astype(np.float32)  # noqa: E731
    p = {
        "conv1": {"w": w(3, 128, 0.3), "b": v(128, 0.1)},
        "conv2": {"w": w(128, 256, 0.05), "b": v(256, 0.1)},
        "conv3": {"w": w(512, 512, 0.04), "b": v(512, 0.1)},
        "conv4": {"w": w(512, c4, 0.04), "b": v(c4, 0.1)},
        "bn1": {"scale": 1.0 + 0.1 * v(128, 1.0), "bias": v(128, 0.1)},
        "bn2": {"scale": 1.0 + 0.1 * v(512, 1.0), "bias": v(512, 0.1)},
    }
    s = {
        "bn1": {"mean": v(128, 0.2), "var": 1.0 + 0.5 * np.abs(v(128, 1.0))},
        "bn2": {"mean": v(512, 0.2), "var": 1.0 + 0.5 * np.abs(v(512, 1.0))},
    }
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


def _nb(b=2, g=16, m=32, seed=1):
    return (np.random.RandomState(seed).randn(b, g, m, 3) * 0.3).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 2e-2)])
def test_point_encoder_reference_matches_xla(dtype, tol):
    """fp32: 1e-6 of max|ref| (summation order). bf16: 2e-2 (bf16 rounding,
    and rounding points that differ by one ulp)."""
    p, s = _enc()
    nb = _nb()
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = FPE.xla_reference(jnp.asarray(nb, jdt), _jax_tree(p), _jax_tree(s))
    got = PFE.point_encoder_reference(torch.from_numpy(nb).to(tdt),
                                      *_torch_enc(p, s, tdt))
    assert got.dtype == tdt and tuple(got.shape) == (2, 16, 256)
    assert _rel(got.float().numpy(), want) < tol


@pytest.mark.parametrize("b,g,tile", [(2, 16, "128"), (1, 25, "16")])
def test_point_encoder_matches_pallas_kernel(monkeypatch, b, g, tile):
    """Within 2e-2 of the Pallas kernel in interpret mode (bf16), including
    a partial last tile of groups (25 groups, tile 16)."""
    monkeypatch.setattr(FPE, "_INTERPRET", True)
    monkeypatch.setenv("VITLENS_POINT_ENC_TG", tile)
    p, s = _enc(seed=3)
    nb = _nb(b=b, g=g, seed=4)
    want = FPE.fused_point_encoder(jnp.asarray(nb, jnp.bfloat16), _jax_tree(p),
                                   _jax_tree(s))
    got = PFE.fused_point_encoder(torch.from_numpy(nb).to(torch.bfloat16),
                                  *_torch_enc(p, s, torch.bfloat16))
    assert tuple(got.shape) == (b, g, 256)
    assert _rel(got.float().numpy(), want) < 2e-2


def test_cpu_calls_launch_no_kernel():
    PF.fps_indices.launches = PFE.fused_point_encoder.launches = 0
    p, s = _enc()
    PF.group_points(torch.from_numpy(_xyz(2, 128)), 8, 16)
    PFE.fused_point_encoder(torch.from_numpy(_nb()), *_torch_enc(p, s, torch.float32))
    assert PF.fps_indices.launches == 0
    assert PFE.fused_point_encoder.launches == 0
