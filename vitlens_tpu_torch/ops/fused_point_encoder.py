"""Eval-mode PointBERT mini-PointNet over point groups (the tokenizer's
per-group encoder).

    h = relu(BN1(nb @ W1 + b1)) @ W2 + b2;  g = max over M of h
    h = relu(BN2(h @ W3[C2:] + g @ W3[:C2] + b3)) @ W4 + b4;  out = max over M

On a CUDA tensor :func:`fused_point_encoder` launches the hand-written Hopper
kernel in ``csrc/fused_point_encoder.cu`` (the port of
``vitlens_tpu/ops/fused_point_encoder.py::_pallas_point_encoder``, forward
only) or raises on what the kernel does not take. On a CPU tensor it runs
:func:`point_encoder_reference`, the plain PyTorch version, which mirrors the
JAX package's ``xla_reference`` cast for cast.

A BatchNorm is given as ``(mean, var, scale, bias)``; eval BN is
``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in fp32.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from vitlens_tpu_torch.ops.custom import through_ops

BN_EPS = 1e-5
# What the kernel takes (csrc/fused_point_encoder.cu): whole groups of M
# points in 128-row tiles, M a multiple of 16 (a warp's 16 rows then belong
# to one group) from 16 to 128; the tokenizer's widths C1..C3 (compile-time
# constants of its products) and an output width C4 (the tokenizer's
# encoder_dims) that is a multiple of 128, taken 256 or 128 columns a pass.
MAX_GROUP_SIZE = 128
WIDTHS = (128, 256, 512)


def _bn_fold(bn: Sequence[torch.Tensor], eps: float):
    """(mean, rsqrt(var + eps) * scale, bias), all fp32."""
    mean, var, scale, bias = bn
    inv = torch.rsqrt(var.float() + eps) * scale.float()
    return mean.float(), inv, bias.float()


def _kernel_takes(m: int, widths) -> bool:
    return (m % 16 == 0 and 16 <= m <= MAX_GROUP_SIZE
            and tuple(widths[:3]) == WIDTHS and widths[3] % 128 == 0
            and widths[3] > 0)


def point_encoder_applicable(nb: torch.Tensor, w1, w2, w3, w4) -> bool:
    """The gate of the tokenizer, JAX's ``point_encoder_applicable`` with
    the kernel's own caps in place of the TPU's VMEM cap: bf16 groups
    [B, G, M, 3] with M a multiple of 16, at most 128; C1, C2, C3 = 128, 256,
    512 (the tokenizer's fixed widths) and C4 a multiple of 128; w3
    [2 * C2, C3]. (JAX takes any M that is a multiple of 16 and any widths
    that are multiples of 128 within 48 MB of VMEM; the port's kernel keeps
    whole groups in a 128-row tile and compiles C1..C3 in, hence its caps.)
    Everything else, the fp32 default among it,
    takes :func:`point_encoder_reference`, as JAX sends it to XLA. The
    wrapper itself raises on what its kernel does not take."""
    if nb.dtype != torch.bfloat16 or nb.dim() != 4 or nb.shape[-1] != 3:
        return False
    widths = (w1.shape[-1], w2.shape[-1], w3.shape[-1], w4.shape[-1])
    return w3.shape[0] == 2 * widths[1] and _kernel_takes(nb.shape[2], widths)


def mini_pointnet(nb, w1, b1, bn1, w2, b2, w3, b3, bn2, w4, b4) -> torch.Tensor:
    """The mini-PointNet with each BatchNorm given as a function of its input
    (eval BN in :func:`point_encoder_reference`, batch BN in the tokenizer's
    train pass): nb [..., M, 3] -> [..., C4] in nb's dtype. Matmuls rounded
    once, biases added in nb's dtype, conv3 accumulated in fp32 and rounded
    once; both max-pools are ``amax``, whose gradient splits evenly among
    ties, as JAX's ``max`` does."""
    dt = nb.dtype
    h = nb @ w1.to(dt) + b1.to(dt)
    h = torch.relu(bn1(h))
    h = h @ w2.to(dt) + b2.to(dt)
    g = h.amax(dim=-2, keepdim=True)
    w3 = w3.to(dt).float()
    c2 = h.shape[-1]
    h32 = (h.float() @ w3[c2:] + g.float() @ w3[:c2]) + b3.float()
    h = torch.relu(bn2(h32.to(dt)))
    h = h @ w4.to(dt) + b4.to(dt)
    return h.amax(dim=-2)


def point_encoder_reference(nb, w1, b1, bn1, w2, b2, w3, b3, bn2, w4, b4,
                            eps: float = BN_EPS) -> torch.Tensor:
    """Plain version: :func:`mini_pointnet` with eval BN, in fp32 rounded
    back to nb's dtype."""
    def eval_bn(stats):
        mean, inv, bias = _bn_fold(stats, eps)
        return lambda x: ((x.float() - mean) * inv + bias).to(x.dtype)

    return mini_pointnet(nb, w1, b1, eval_bn(bn1), w2, b2, w3, b3,
                         eval_bn(bn2), w4, b4)


def _check_cuda_args(nb, w1, b1, bn1, w2, b2, w3, b3, bn2, w4, b4):
    if nb.dim() != 4 or nb.shape[-1] != 3:
        raise ValueError(f"fused_point_encoder: nb must be [B, G, M, 3], "
                         f"got {tuple(nb.shape)}")
    m = nb.shape[2]
    if m % 16 or not 16 <= m <= MAX_GROUP_SIZE:
        raise ValueError(f"fused_point_encoder: group size M={m} must be a "
                         f"multiple of 16 from 16 to {MAX_GROUP_SIZE}")
    c1, c2, c3, c4 = w1.shape[-1], w2.shape[-1], w3.shape[-1], w4.shape[-1]
    tensors = [("nb", nb, tuple(nb.shape), torch.bfloat16),
               ("w1", w1, (3, c1), torch.bfloat16),
               ("w2", w2, (c1, c2), torch.bfloat16),
               ("w3", w3, (2 * c2, c3), torch.bfloat16),
               ("w4", w4, (c3, c4), torch.bfloat16),
               ("b1", b1, (c1,), torch.float32), ("b2", b2, (c2,), torch.float32),
               ("b3", b3, (c3,), torch.float32), ("b4", b4, (c4,), torch.float32)]
    for bn_name, bn, c in (("bn1", bn1, c1), ("bn2", bn2, c3)):
        tensors += [(f"{bn_name}[{i}]", t, (c,), torch.float32)
                    for i, t in enumerate(bn)]
    for name, t, shape, dtype in tensors:
        if t.device != nb.device:
            raise ValueError(f"fused_point_encoder: {name} is on {t.device}, "
                             f"nb on {nb.device}")
        if t.dtype != dtype:
            raise ValueError(f"fused_point_encoder: {name} must be {dtype}, "
                             f"got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_point_encoder: {name} must be {shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_point_encoder: {name} must be contiguous "
                             "and 16-byte aligned")
    if not _kernel_takes(m, (c1, c2, c3, c4)):
        raise ValueError(f"fused_point_encoder: widths {(c1, c2, c3, c4)} "
                         f"must be {WIDTHS} and C4 a multiple of 128")


def fused_point_encoder(nb, w1, b1, bn1, w2, b2, w3, b3, bn2, w4, b4,
                        eps: float = BN_EPS) -> torch.Tensor:
    """nb [B, G, M, 3] -> features [B, G, C4].

    CPU tensors take :func:`point_encoder_reference`. CUDA tensors launch the
    kernel: nb and w1..w4 bf16, biases and BN tensors fp32, all contiguous,
    M a multiple of 16 from 16 to 128, C1..C3 = 128, 256, 512 and C4 a
    multiple of 128. Anything else raises."""
    if through_ops():  # a trace (ops/custom.py): the op
        return torch.ops.vitlens.fused_point_encoder(
            nb, w1, b1, list(bn1), w2, b2, w3, b3, list(bn2), w4, b4, eps)
    if not nb.is_cuda:
        return point_encoder_reference(nb, w1, b1, bn1, w2, b2, w3, b3, bn2,
                                       w4, b4, eps)
    _check_cuda_args(nb, w1, b1, bn1, w2, b2, w3, b3, bn2, w4, b4)
    from vitlens_tpu_torch.ops import _build

    B, G, M, _ = nb.shape
    c1, c2, c3, c4 = w1.shape[1], w2.shape[1], w3.shape[1], w4.shape[1]
    out = torch.empty((B, G, c4), dtype=nb.dtype, device=nb.device)
    if B * G == 0:
        return out
    m1, i1, s1 = _bn_fold(bn1, eps)
    m2, i2, s2 = _bn_fold(bn2, eps)
    stream = _build.stream_of(nb)
    err = _build.library().vitlens_point_encoder_fwd(
        nb.data_ptr(), w1.data_ptr(), b1.data_ptr(), m1.data_ptr(),
        i1.data_ptr(), s1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        w3.data_ptr(), b3.data_ptr(), m2.data_ptr(), i2.data_ptr(),
        s2.data_ptr(), w4.data_ptr(), b4.data_ptr(), out.data_ptr(),
        B * G, M, c1, c2, c3, c4, stream)
    _build.check(err, "fused_point_encoder")
    fused_point_encoder.launches += 1
    return out


fused_point_encoder.launches = 0


@torch.library.custom_op("vitlens::fused_point_encoder", mutates_args=())
def _point_encoder_op(nb: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      bn1: List[torch.Tensor], w2: torch.Tensor,
                      b2: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor,
                      bn2: List[torch.Tensor], w4: torch.Tensor,
                      b4: torch.Tensor, eps: float) -> torch.Tensor:
    return fused_point_encoder(nb, w1, b1, tuple(bn1), w2, b2, w3, b3,
                               tuple(bn2), w4, b4, eps)


@_point_encoder_op.register_fake
def _(nb, w1, b1, bn1, w2, b2, w3, b3, bn2, w4, b4, eps):
    return nb.new_empty(tuple(nb.shape[:2]) + (w4.shape[1],))
