"""LayerNorm + linear projection: out = LN(x) @ W + b (the resblock front half,
ln_1 + the packed qkv projection).

On a CUDA tensor :func:`fused_ln_proj` launches the hand-written Hopper kernel
in ``csrc/fused_ln_proj.cu`` (the port of
``vitlens_tpu/ops/fused_ln_proj.py::_pallas_ln_proj``) or raises on what the
kernel does not take. On a CPU tensor it runs :func:`ln_proj_reference`, the
plain PyTorch version of the Pallas kernel's contract (``_kernel``): fp32 LN
rounded to x's dtype, the product accumulated in fp32, the bias added in fp32
before the one cast. (The JAX package's ``_xla_reference`` adds the bias in
bf16 instead.)

Training follows the JAX ``custom_vjp``: the forward is the kernel, the
backward the JAX ``bwd`` formula (LN output recomputed from x, the 2 grad
matmuls, the closed-form LN grad), on both devices, computing only the
gradients autograd asks for.

Opt-in, as in the JAX package: the resblocks dispatch to :func:`fused_ln_qkv`
only while ``VITLENS_ENABLE_FUSED_LNQKV`` is set (read at each call).
"""

from __future__ import annotations

import os

import torch

from vitlens_tpu_torch.ops.custom import through_ops

from vitlens_tpu_torch.ops.fused_mlp import _layer_norm32

MAX_D = 8192  # the widest LN the kernel is held to (bigG's D is 1664)


def ln_proj_reference(x, lnw, lnb, w, b, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version. x [M, D]; lnw, lnb [D]; w [D, N]; b [N] ->
    [M, N] in x.dtype."""
    y = _layer_norm32(x, lnw, lnb, eps)[2].to(x.dtype)
    return (y.float() @ w.to(x.dtype).float() + b.float()).to(x.dtype)


def _check_cuda_args(x, lnw, lnb, w, b):
    if x.dim() != 2:
        raise ValueError(f"fused_ln_proj: x must be [M, D], got {tuple(x.shape)}")
    m, d = x.shape
    n = w.shape[-1]
    for name, t, shape, dtype in (
            ("x", x, (m, d), torch.bfloat16),
            ("w", w, (d, n), torch.bfloat16),
            ("lnw", lnw, (d,), torch.float32),
            ("lnb", lnb, (d,), torch.float32),
            ("b", b, (n,), torch.float32)):
        if t.device != x.device:
            raise ValueError(f"fused_ln_proj: {name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise ValueError(f"fused_ln_proj: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_ln_proj: {name} must be {shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_ln_proj: {name} must be contiguous and "
                             "16-byte aligned")
    if d % 128 or n % 128 or d > MAX_D:
        raise ValueError(f"fused_ln_proj: D={d} and N={n} must be multiples of "
                         f"128, D at most {MAX_D}")


def _forward(x, lnw, lnb, w, b, eps):
    if not x.is_cuda:
        return ln_proj_reference(x, lnw, lnb, w, b, eps)
    _check_cuda_args(x, lnw, lnb, w, b)
    from vitlens_tpu_torch.ops import _build

    m, d = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    y = torch.empty_like(x)  # LN(x), the GEMM's A operand
    err = _build.library().vitlens_fused_ln_proj_fwd(
        x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), w.data_ptr(),
        b.data_ptr(), y.data_ptr(), out.data_ptr(), m, d, n, float(eps),
        _build.stream_of(x))
    _build.check(err, "fused_ln_proj")
    fused_ln_proj.launches += 1
    return out


def ln_proj_backward(g, x, lnw, lnb, w, eps: float, needs=(True,) * 5):
    """The JAX ``bwd`` formula: grads of (x, lnw, lnb, w, b), each None
    unless ``needs`` asks for it."""
    need_x, need_lnw, need_lnb, need_w, need_b = needs
    xhat, rstd, y32 = _layer_norm32(x, lnw, lnb, eps)
    dx = dlnw = dlnb = dw = db = None
    if need_b:
        db = g.float().sum(0)
    if need_w:
        dw = (y32.to(x.dtype).t() @ g).to(w.dtype)
    if need_x or need_lnw or need_lnb:
        dy32 = (g @ w.t()).float()
        if need_lnw:
            dlnw = (dy32 * xhat).sum(0)
        if need_lnb:
            dlnb = dy32.sum(0)
        if need_x:
            dxhat = dy32 * lnw.float()
            dx = (rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                          - xhat * (dxhat * xhat).mean(-1, keepdim=True))
                  ).to(x.dtype)
    return dx, dlnw, dlnb, dw, db


class FusedLnProjFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lnw, lnb, w, b, eps):
        ctx.save_for_backward(x, lnw, lnb, w)
        ctx.eps = eps
        return _forward(x, lnw, lnb, w, b, eps)

    @staticmethod
    def backward(ctx, g):
        x, lnw, lnb, w = ctx.saved_tensors
        return (*ln_proj_backward(g.contiguous(), x, lnw, lnb, w, ctx.eps,
                                  ctx.needs_input_grad[:5]), None)


def fused_ln_proj(x, lnw, lnb, w, b, eps: float = 1e-5) -> torch.Tensor:
    """x [M, D] -> LN(x) @ w + b [M, N].

    CPU tensors take :func:`ln_proj_reference`. CUDA tensors launch the
    kernel (counted in ``fused_ln_proj.launches``): x, w bf16; lnw, lnb, b
    fp32; all contiguous; D and N multiples of 128. Anything else raises.
    When autograd records and an input requires grad, this is
    :class:`FusedLnProjFunction`."""
    args = (x, lnw, lnb, w, b)
    if through_ops():  # a trace (ops/custom.py): the op, run forward only
        return torch.ops.vitlens.fused_ln_proj(*args, eps)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return FusedLnProjFunction.apply(*args, eps)
    return _forward(*args, eps)


fused_ln_proj.launches = 0


@torch.library.custom_op("vitlens::fused_ln_proj", mutates_args=())
def _fused_ln_proj_op(x: torch.Tensor, lnw: torch.Tensor, lnb: torch.Tensor,
                      w: torch.Tensor, b: torch.Tensor,
                      eps: float) -> torch.Tensor:
    return _forward(x, lnw, lnb, w, b, eps)


@_fused_ln_proj_op.register_fake
def _(x, lnw, lnb, w, b, eps):
    return x.new_empty((x.shape[0], w.shape[1]))


def fused_ln_proj_available() -> bool:
    """The opt-in switch of the JAX package, read at each call."""
    return bool(os.environ.get("VITLENS_ENABLE_FUSED_LNQKV"))


def fused_ln_proj_applicable(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Shape gate. x is the [B, N, D] (or [M, D]) resblock input, w the packed
    [D, 3D] qkv weight: bf16, D and the output width multiples of 128. The
    JAX package's rows >= 4096 threshold was a TPU choice and is not carried
    over."""
    return (x.dtype == torch.bfloat16 and x.shape[-1] % 128 == 0
            and w.shape[1] % 128 == 0)


def fused_ln_qkv(x: torch.Tensor, ln, attn) -> torch.Tensor:
    """x [..., D] -> ln(x) @ attn.qkv_w + attn.qkv_b [..., 3D] through
    :func:`fused_ln_proj`. ``ln`` has ``scale``, ``bias`` and ``eps``;
    ``attn`` has ``qkv_w`` [D, 3D] and ``qkv_b``."""
    d = x.shape[-1]
    qkv = fused_ln_proj(x.reshape(-1, d), ln.scale.float(), ln.bias.float(),
                        attn.qkv_w.to(x.dtype), attn.qkv_b.float(), ln.eps)
    return qkv.reshape(x.shape[:-1] + (qkv.shape[-1],))
