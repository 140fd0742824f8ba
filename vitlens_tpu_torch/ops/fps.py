"""Farthest-point sampling and kNN grouping (port of vitlens_tpu/ops/fps.py).

On a CUDA tensor :func:`fps_indices` launches the hand-written Hopper kernel in
``csrc/fps.cu`` (the port of both ``_fps_indices_pallas_batched`` and
``_fps_indices_pallas``), a thread-block cluster of :func:`cluster_size` CTAs
a row, or raises on what the kernel does not take. On a CPU
tensor it runs :func:`fps_indices_reference`, the plain PyTorch version, which
mirrors the JAX package's ``_fps_indices_xla`` step for step. Both are
index-exact: the distance is ``(dx*dx + dy*dy) + dz*dz`` rounded after every
operation, and ties go to the smallest index.

kNN and the ball query are the exact branches only (a pairwise-distance
matmul and ``torch.topk``; JAX's ``approx_min_k`` is a TPU workaround and is
not ported); gathers are plain ``torch.gather``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from vitlens_tpu_torch.ops.custom import through_ops

# CTAs a row at most for a partition that fits on chip. The kernel takes up to
# 16, but every warp of a cluster sends its winner to every CTA, so the
# exchange grows with C: on an H100, one row of 8192 points took 0.32 ms at
# C = 4 and 0.46 at C = 16 (tools/kernel_variants.py fps).
MAX_CLUSTER = 4
# Points a CTA holds on chip: csrc/fps.cu's REG_POINTS + SMEM_POINTS. Past
# them a partition reads global memory each step, which costs more than a
# larger cluster (one row of 100000 points: 3.35 ms at C = 4, 0.69 at 16).
ON_CHIP_POINTS = 8192 + 7680


def cluster_size(batch: int, sm_count: int, n: int) -> int:
    """CTAs a row: floor(SMs / rows) rounded down to a power of two, at most
    MAX_CLUSTER and at least 1 (132 SMs: B64 takes 2, one row 4); then
    doubled, up to 16 and while the rows still fit the SMs, until a
    partition of the ``n`` points fits on chip."""
    c = min(sm_count // max(batch, 1), MAX_CLUSTER)
    c = 1 << (c.bit_length() - 1) if c >= 1 else 1
    while c < 16 and -(-n // c) > ON_CHIP_POINTS and batch * 2 * c <= sm_count:
        c *= 2
    return c


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distance in the matmul form, in the inputs' dtype.
    src [..., N, C], dst [..., M, C] -> [..., N, M]."""
    d = -2.0 * (src @ dst.transpose(-1, -2))
    d = d + (src * src).sum(-1)[..., :, None]
    return d + (dst * dst).sum(-1)[..., None, :]


def fps_indices_reference(xyz: torch.Tensor, npoint: int,
                          start: torch.Tensor) -> torch.Tensor:
    """Plain version: xyz [B, N, 3] fp32, start [B] -> [B, npoint] int32.

    Each step records the current point, lowers the running distance
    (starting at 1e10) to the squared distance from it, and moves to the
    first index of the largest running distance."""
    B, N, _ = xyz.shape
    x, y, z = xyz.float().unbind(-1)
    rows = torch.arange(B, device=xyz.device)
    dist = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    idx = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    far = start.to(device=xyz.device, dtype=torch.long)
    for i in range(npoint):
        idx[:, i] = far
        dx = x - x[rows, far][:, None]
        dy = y - y[rows, far][:, None]
        dz = z - z[rows, far][:, None]
        d = (dx * dx + dy * dy) + dz * dz
        dist = torch.minimum(dist, d)
        far = torch.argmax(dist, dim=-1)
    return idx


def _check_cuda_args(xyz, start, npoint):
    if xyz.dim() != 3 or xyz.shape[2] != 3:
        raise ValueError(f"fps_indices: xyz must be [B, N, 3], got {tuple(xyz.shape)}")
    if xyz.dtype != torch.float32:
        raise ValueError(f"fps_indices: xyz must be float32, got {xyz.dtype}")
    if not xyz.is_contiguous():
        raise ValueError("fps_indices: xyz must be contiguous")
    B, N, _ = xyz.shape
    if not 1 <= N < 2 ** 31:
        raise ValueError(f"fps_indices: N={N} must be in [1, 2**31)")
    if npoint < 1:
        raise ValueError(f"fps_indices: npoint={npoint} must be >= 1")
    if start.device != xyz.device:
        raise ValueError(f"fps_indices: start is on {start.device}, xyz on {xyz.device}")
    if start.dtype != torch.int32 or tuple(start.shape) != (B,):
        raise ValueError(f"fps_indices: start must be int32 [{B}], got "
                         f"{start.dtype} {tuple(start.shape)}")
    if not start.is_contiguous():
        raise ValueError("fps_indices: start must be contiguous")


def fps_indices(xyz: torch.Tensor, npoint: int,
                start: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Batched farthest-point sampling: xyz [B, N, 3] -> [B, npoint] int32.

    The start is 0 for every row, or ``start`` [B], or uniform in [0, N) from
    ``generator``. xyz is cast to fp32 first, as in JAX. CPU tensors take
    :func:`fps_indices_reference`; CUDA tensors launch the kernel (contiguous
    xyz, any N >= 1) or raise. Start indices must lie in [0, N)."""
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(
            f"fps_indices expects xyz [B, N, 3]; got {tuple(xyz.shape)} — pass "
            "coordinates only (xyz[..., :3])")
    B, N, _ = xyz.shape
    if start is None:
        if generator is not None:
            start = torch.randint(0, N, (B,), generator=generator,
                                  device=generator.device).to(xyz.device)
        else:
            start = torch.zeros((B,), dtype=torch.int32, device=xyz.device)
    start = start.to(torch.int32)
    xyz = xyz.float()
    if through_ops():  # a trace (ops/custom.py): the op
        return torch.ops.vitlens.fps_indices(xyz, npoint, start)
    if not xyz.is_cuda:
        return fps_indices_reference(xyz, npoint, start)
    _check_cuda_args(xyz, start, npoint)
    from vitlens_tpu_torch.ops import _build

    idx = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    if B == 0:
        return idx
    c = cluster_size(B, _sm_count(xyz.device.index), N)
    # distance scratch for the points of a partition past the on-chip tiers
    work = (torch.empty((B, N), dtype=torch.float32, device=xyz.device)
            if -(-N // c) > ON_CHIP_POINTS else None)
    err = _build.library().vitlens_fps_fwd(
        xyz.data_ptr(), start.data_ptr(), idx.data_ptr(),
        None if work is None else work.data_ptr(), B, N, npoint, c,
        _build.stream_of(xyz))
    _build.check(err, "fps_indices")
    fps_indices.launches += 1
    return idx


fps_indices.launches = 0


@torch.library.custom_op("vitlens::fps_indices", mutates_args=())
def _fps_indices_op(xyz: torch.Tensor, npoint: int,
                    start: torch.Tensor) -> torch.Tensor:
    return fps_indices(xyz, npoint, start)


@_fps_indices_op.register_fake
def _(xyz, npoint, start):
    return xyz.new_empty((xyz.shape[0], npoint), dtype=torch.int32)


def take_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, ...] -> [B, ..., C] (a plain gather)."""
    B, _, C = points.shape
    flat = idx.reshape(B, -1).long()
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, C))
    return out.reshape(*idx.shape, C)


def fps(xyz: torch.Tensor, npoint: int, start: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The sampled points [B, npoint, C]; distances use xyz[..., :3] and the
    other channels ride along. The start is 0, or ``start`` [B], or drawn
    from ``generator`` (see :func:`fps_indices`)."""
    idx = fps_indices(xyz[..., :3].contiguous(), npoint, start=start,
                      generator=generator)
    return take_points(xyz, idx)


def knn_indices(xyz: torch.Tensor, query: torch.Tensor, k: int) -> torch.Tensor:
    """The k nearest points of each query point, nearest first.
    xyz [B, N, C], query [B, S, C] -> [B, S, k] int64."""
    return torch.topk(-square_distance(query, xyz), k, dim=-1).indices


def group_points(xyz: torch.Tensor, num_group: int, group_size: int,
                 start: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FPS centers and their kNN neighbourhoods, center-normalised:
    (neighborhood [B, G, M, C], center [B, G, C]). FPS starts as in
    :func:`fps`."""
    center = fps(xyz, num_group, start=start, generator=generator)
    idx = knn_indices(xyz, center, group_size)
    return take_points(xyz, idx) - center[:, :, None, :], center


def ball_query(xyz: torch.Tensor, query: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """Up to ``nsample`` points within ``radius`` of each query point, the
    first by index; xyz [B, N, 3], query [B, S, 3] -> [B, S, nsample] int32.

    The exact branch of JAX's ``ball_query``: a candidate is the point's
    index when it lies in the ball (squared distance <= radius**2, in the
    inputs' dtype) and N otherwise; the k = min(nsample, N) smallest
    candidates are taken, slots that hold N take the first in-ball index
    (clamped to N - 1 for an empty ball), and columns past N repeat it.
    Candidates are distinct but for the N's, so the selection has no ties
    to break."""
    B, N, _ = xyz.shape
    S = query.shape[1]
    in_ball = square_distance(query, xyz) <= radius ** 2
    arange = torch.arange(N, dtype=torch.int32, device=xyz.device)
    cand = torch.where(in_ball, arange, torch.full_like(arange, N))
    k = min(nsample, N)
    sel = torch.topk(cand, k, dim=-1, largest=False, sorted=True).values
    first = sel[..., :1].clamp_max(N - 1)
    sel = torch.where(sel == N, first, sel)
    if k < nsample:
        sel = torch.cat([sel, first.expand(B, S, nsample - k)], dim=-1)
    return sel
