"""The cluster design of the port's FPS kernel (csrc/fps.cu) on CPU: the
wrapper's choice of CTAs a row, its argument checks past the old 16384-point
cap, and a plain emulation of the kernel's partitioned argmax (contiguous
partitions of ceil(N / C) points, point l of a partition on thread l % 256,
each level keeping the largest distance bits and the smallest index among
them: thread, warp, CTA, cluster), index-exact against the port's plain
version and JAX's XLA recurrence on clouds with exact ties."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vitlens_tpu.ops.fps as JF
from vitlens_tpu_torch.ops import fps as PF
from tests.test_torch_threads import share_cores

share_cores()

THREADS = 256  # csrc/fps.cu's CTA
NO_INDEX = 0x7FFFFFFF


@pytest.mark.parametrize("sms, b, want16", [
    (132, 1, 16), (132, 2, 16), (132, 64, 2), (132, 65, 2), (132, 200, 1),
    (114, 1, 16), (114, 2, 16), (114, 64, 1), (114, 65, 1), (114, 200, 1)])
def test_cluster_size(sms, b, want16):
    """``want16``: floor(SMs / B) as a power of two up to 16, the kernel's
    largest cluster; the wrapper caps it at MAX_CLUSTER for the pc encode's
    8192 points, whose partition fits on chip at every size."""
    want = min(want16, PF.MAX_CLUSTER)
    assert PF.cluster_size(b, sms, 8192) == want
    assert PF.cluster_size(b, sms, 1) == want
    # a partition past the on-chip tiers doubles the cluster while the rows
    # still fit the SMs: up to want16 for a row of 16 tiers' worth of points
    assert PF.cluster_size(b, sms, 16 * PF.ON_CHIP_POINTS) == want16


@pytest.mark.parametrize("b, n, want", [
    (1, 8192, 4), (1, 100000, 8), (1, 300000, 16), (2, 40000, 4), (2, 70000, 8),
    (64, 100000, 2), (133, 100000, 1)])
def test_cluster_grows_until_a_partition_fits_on_chip(b, n, want):
    assert PF.cluster_size(b, 132, n) == want


def test_cluster_size_is_a_power_of_two_that_fits_the_card():
    for sms in (132, 114, 78):
        for b in range(1, 300):
            for n in (8192, 100000):
                c = PF.cluster_size(b, sms, n)
                assert c & (c - 1) == 0 and 1 <= c <= 16
                assert c == 1 or b * c <= sms


@pytest.mark.parametrize("n", [16385, 100000])
def test_check_cuda_args_takes_n_past_16384(n):
    xyz = torch.empty(2, n, 3, device="meta")
    PF._check_cuda_args(xyz, torch.zeros(2, dtype=torch.int32, device="meta"), 512)


def _pairs(key, idx, dim):
    """Per group along ``dim``: the largest key, the smallest index among
    the entries that hold it."""
    m = key.amax(dim)
    cand = torch.where(key == m.unsqueeze(dim), idx, torch.full_like(idx, NO_INDEX))
    return m, cand.amin(dim)


def emulate_cluster_fps(xyz, npoint, start, c, threads=THREADS):
    """The kernel's steps with its reduction tree: the distances in fp32 as
    (dx*dx + dy*dy) + dz*dz, points outside a partition at -1, keys the bits
    of max(dist, 0), (0, NO_INDEX) for a thread that holds no point."""
    b, n, _ = xyz.shape
    p = -(-n // c)
    k = -(-p // threads)  # points a thread
    slots = k * threads
    g = torch.arange(c)[:, None] * p + torch.arange(slots)[None, :]  # global index
    valid = (torch.arange(slots)[None, :] < p) & (g < n)
    pts = xyz[:, g.clamp(max=n - 1)]  # [b, c, slots, 3]
    dist = torch.where(valid, torch.tensor(1e10), torch.tensor(-1.0)).expand(b, c, slots)
    rows = torch.arange(b)
    far = start.long()
    out = torch.empty(b, npoint, dtype=torch.int32)
    for s in range(npoint):
        out[:, s] = far
        d = pts - xyz[rows, far][:, None, None, :]
        d = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        dist = torch.minimum(dist, torch.where(valid, d, torch.tensor(-1.0)))
        key = dist.clamp_min(0).view(torch.int32)  # nonnegative floats order as ints
        idx = torch.where(valid & (dist >= 0), g.expand(b, c, slots),
                          torch.tensor(NO_INDEX))
        # thread t holds the points l = kk * threads + t
        key, idx = _pairs(key.view(b, c, k, threads), idx.view(b, c, k, threads), 2)
        key, idx = _pairs(key.view(b, c, -1, 32), idx.view(b, c, -1, 32), 3)  # warps
        key, idx = _pairs(key, idx, 2)  # the CTA
        key, idx = _pairs(key, idx, 1)  # the cluster
        far = idx.long().clamp(0, n - 1)
    return out


def _cloud(kind, b, n, seed):
    rng = np.random.RandomState(seed)
    i = np.arange(n)
    if kind == "random":
        return (rng.randn(b, n, 3) * 0.3).astype(np.float32)
    if kind == "lattice":  # equal distances inside warps and across partitions
        grid = np.stack((i % 16, (i // 16) % 16, i // 256), -1) * 0.125
        return np.broadcast_to(grid, (b, n, 3)).astype(np.float32).copy()
    base = rng.randn(b, 37, 3).astype(np.float32)  # 37 points, repeated
    return base[:, i % 37].copy()


@pytest.mark.parametrize("c", [1, 2, 8, 16])
@pytest.mark.parametrize("kind, n, npoint", [
    ("lattice", 1500, 40), ("duplicates", 1100, 45), ("random", 1031, 32),
    ("lattice", 37, 42)])
def test_partitioned_argmax_is_index_exact(c, kind, n, npoint):
    """The emulation equals the plain version and JAX's XLA recurrence,
    index for index, on tied clouds (lattice, duplicates: every distance
    reaches 0 and index 0 repeats), ragged partitions and npoint past N."""
    xyz = _cloud(kind, 3, n, seed=c)
    start = np.array([0, n // 2, n - 1], np.int32)
    got = emulate_cluster_fps(torch.from_numpy(xyz), npoint, torch.from_numpy(start), c)
    want = PF.fps_indices_reference(torch.from_numpy(xyz), npoint, torch.from_numpy(start))
    assert torch.equal(got, want)
    jax_idx = np.asarray(JF._fps_indices_xla(jnp.asarray(xyz), npoint, jnp.asarray(start)))
    np.testing.assert_array_equal(got.numpy(), jax_idx)
    if kind == "duplicates":
        assert (got[:, 37:] == 0).all()


def test_emulation_spans_many_points_a_thread():
    """A partition of more than 256 points (several a thread, as the
    register tier holds them) with ties across the partition boundary."""
    xyz = _cloud("lattice", 2, 4096, seed=0)
    start = torch.tensor([0, 4095], dtype=torch.int32)
    got = emulate_cluster_fps(torch.from_numpy(xyz), 24, start, 2)
    assert torch.equal(got, PF.fps_indices_reference(torch.from_numpy(xyz), 24, start))
