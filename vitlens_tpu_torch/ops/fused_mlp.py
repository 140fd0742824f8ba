"""Residual MLP half of a transformer block: out = x + act(LN(x) @ W1 + b1) @ W2 + b2.

On a CUDA tensor :func:`fused_mlp` launches the hand-written Hopper kernel in
``csrc/fused_mlp.cu`` (the port of
``vitlens_tpu/ops/fused_mlp.py::_pallas_fused_mlp``) or raises on what the
kernel does not take. On a CPU tensor it runs :func:`fused_mlp_reference`,
the plain PyTorch version, which mirrors the JAX package's ``_xla_reference``.

Training follows the JAX package's ``custom_vjp`` (``_make_op``): when an
input requires grad, the forward runs the save-preact variant
(:func:`fused_mlp_save_preact`, which also returns the pre-activation
``a = LN(x) @ W1 + b1`` in x's dtype) and the backward is the closed-form
formula of the JAX ``bwd`` (4 matmuls plus the LayerNorm and activation
grads, recomputing h and act' from ``a``), on both devices. It computes only
the gradients autograd asks for: through a frozen block that is dx alone.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from vitlens_tpu_torch.ops.custom import through_ops

ACTS = ("gelu", "quick_gelu")


def _act(h32: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu":
        return F.gelu(h32)
    return h32 * torch.sigmoid(1.702 * h32)


def _act_and_grad(act: str, a32: torch.Tensor, need_h: bool = True):
    """h = act(a) (None unless ``need_h``) and dh/da, exact closed forms in
    fp32."""
    if act == "gelu":
        cdf = 0.5 * (1.0 + torch.erf(a32 * (2.0 ** -0.5)))
        pdf = torch.exp(-0.5 * a32 * a32) * (1.0 / math.sqrt(2.0 * math.pi))
        return a32 * cdf if need_h else None, cdf + a32 * pdf
    s = torch.sigmoid(1.702 * a32)
    return a32 * s if need_h else None, s + a32 * 1.702 * s * (1.0 - s)


def _layer_norm32(x, lnw, lnb, eps):
    """(xhat, rstd, y) of the fp32 LayerNorm; y = xhat * lnw + lnb in fp32."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    rstd = torch.rsqrt((x32 - mean).square().mean(-1, keepdim=True) + eps)
    xhat = (x32 - mean) * rstd
    return xhat, rstd, xhat * lnw.float() + lnb.float()


def fused_mlp_applicable(x: torch.Tensor) -> bool:
    """The dtype gate of the call sites: JAX's ``fused_mlp_applicable``
    without its TPU row threshold. The kernel takes bf16 activations; a block
    whose activations are in any other dtype (the fp32 default) takes the
    plain composition, as the JAX package sends them to XLA. The wrapper
    itself still raises on a non-bf16 CUDA tensor."""
    return x.dtype == torch.bfloat16


def fused_mlp_reference(x, lnw, lnb, w1, b1, w2, b2, act: str = "gelu",
                        eps: float = 1e-5, save_preact: bool = False):
    """Plain PyTorch version. x [M, D]; lnw, lnb [D]; w1 [D, H]; b1 [H];
    w2 [H, D]; b2 [D]. LN in fp32 rounded to x.dtype, biases cast to x.dtype,
    the activation in fp32 rounded once. With ``save_preact`` it returns
    (out, a) with a the pre-activation [M, H] in x.dtype."""
    y = _layer_norm32(x, lnw, lnb, eps)[2].to(x.dtype)
    a = y @ w1.to(x.dtype) + b1.to(x.dtype)
    h = _act(a.float(), act).to(x.dtype)
    out = x + (h @ w2.to(x.dtype) + b2.to(x.dtype))
    return (out, a) if save_preact else out


def _check_cuda_args(x, lnw, lnb, w1, b1, w2, b2, act):
    if act not in ACTS:
        raise ValueError(f"fused_mlp: act must be one of {ACTS}, got {act!r}")
    if x.dim() != 2:
        raise ValueError(f"fused_mlp: x must be [M, D], got {tuple(x.shape)}")
    m, d = x.shape
    h = w1.shape[-1]
    for name, t, shape, dtype in (
            ("x", x, (m, d), torch.bfloat16),
            ("w1", w1, (d, h), torch.bfloat16),
            ("w2", w2, (h, d), torch.bfloat16),
            ("lnw", lnw, (d,), torch.float32),
            ("lnb", lnb, (d,), torch.float32),
            ("b1", b1, (h,), torch.float32),
            ("b2", b2, (d,), torch.float32)):
        if t.device != x.device:
            raise ValueError(f"fused_mlp: {name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise ValueError(f"fused_mlp: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_mlp: {name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_mlp: {name} must be contiguous and "
                             "16-byte aligned")
    if d % 64 or h % 64:
        raise ValueError(f"fused_mlp: D={d} and H={h} must be multiples of 64")


def _launch(x, lnw, lnb, w1, b1, w2, b2, act, eps, save_preact):
    """One launch of the kernel (either variant); returns out or (out, a)."""
    _check_cuda_args(x, lnw, lnb, w1, b1, w2, b2, act)
    from vitlens_tpu_torch.ops import _build

    m, d = x.shape
    h = w1.shape[1]
    out = torch.empty_like(x)
    a = torch.empty((m, h), dtype=x.dtype, device=x.device) if save_preact else None
    if m == 0:
        return (out, a) if save_preact else out
    y_scratch = torch.empty_like(x)
    h_scratch = torch.empty((m, h), dtype=x.dtype, device=x.device)
    stream = _build.stream_of(x)
    lib = _build.library()
    ptrs = [x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), y_scratch.data_ptr(),
            h_scratch.data_ptr()]
    tail = (m, d, h, ACTS.index(act), float(eps), stream)
    if save_preact:
        err = lib.vitlens_fused_mlp_fwd_save_preact(*ptrs, a.data_ptr(),
                                                    out.data_ptr(), *tail)
    else:
        err = lib.vitlens_fused_mlp_fwd(*ptrs, out.data_ptr(), *tail)
    _build.check(err, "fused_mlp")
    return (out, a) if save_preact else out


def fused_mlp_save_preact(x, lnw, lnb, w1, b1, w2, b2, act: str = "gelu",
                          eps: float = 1e-5):
    """The save-preact variant: (out, a). CPU tensors take the plain version;
    CUDA tensors launch the kernel (counted in this function's own
    ``launches``) or raise."""
    if not x.is_cuda:
        return fused_mlp_reference(x, lnw, lnb, w1, b1, w2, b2, act, eps,
                                   save_preact=True)
    out = _launch(x, lnw, lnb, w1, b1, w2, b2, act, eps, save_preact=True)
    fused_mlp_save_preact.launches += 1
    return out


def fused_mlp_backward(g, x, a, lnw, lnb, w1, w2, act: str, eps: float,
                       needs=(True,) * 7):
    """The JAX ``bwd`` formula: grads of (x, lnw, lnb, w1, b1, w2, b2), each
    None unless ``needs`` asks for it."""
    need_x, need_lnw, need_lnb, need_w1, need_b1, need_w2, need_b2 = needs
    xhat, rstd, y32 = _layer_norm32(x, lnw, lnb, eps)
    h32, dact = _act_and_grad(act, a.float(), need_h=need_w2)
    dx = dlnw = dlnb = dw1 = db1 = dw2 = db2 = None
    if need_b2:
        db2 = g.float().sum(0)
    if need_w2:
        dw2 = (h32.to(x.dtype).t() @ g).to(w2.dtype)
    if not (need_x or need_lnw or need_lnb or need_w1 or need_b1):
        return dx, dlnw, dlnb, dw1, db1, dw2, db2
    da32 = (g @ w2.t()).float() * dact
    da = da32.to(x.dtype)
    if need_b1:
        db1 = da32.sum(0)
    if need_w1:
        dw1 = (y32.to(x.dtype).t() @ da).to(w1.dtype)
    if need_x or need_lnw or need_lnb:
        dy32 = (da @ w1.t()).float()
        if need_lnw:
            dlnw = (dy32 * xhat).sum(0)
        if need_lnb:
            dlnb = dy32.sum(0)
        if need_x:
            dxhat = dy32 * lnw.float()
            dx_ln = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                            - xhat * (dxhat * xhat).mean(-1, keepdim=True))
            dx = (g.float() + dx_ln).to(x.dtype)
    return dx, dlnw, dlnb, dw1, db1, dw2, db2


class FusedMLPFunction(torch.autograd.Function):
    """Forward: the save-preact variant. Backward: :func:`fused_mlp_backward`."""

    @staticmethod
    def forward(ctx, x, lnw, lnb, w1, b1, w2, b2, act, eps):
        out, a = fused_mlp_save_preact(x, lnw, lnb, w1, b1, w2, b2, act, eps)
        ctx.save_for_backward(x, a, lnw, lnb, w1, w2)
        ctx.act, ctx.eps = act, eps
        return out

    @staticmethod
    def backward(ctx, g):
        x, a, lnw, lnb, w1, w2 = ctx.saved_tensors
        grads = fused_mlp_backward(g.contiguous(), x, a, lnw, lnb, w1, w2,
                                   ctx.act, ctx.eps, ctx.needs_input_grad[:7])
        return (*grads, None, None)


def fused_mlp(x, lnw, lnb, w1, b1, w2, b2, act: str = "gelu",
              eps: float = 1e-5) -> torch.Tensor:
    """x [M, D] -> x + act(LN(x) @ w1 + b1) @ w2 + b2.

    When autograd records and an input requires grad, this is
    :class:`FusedMLPFunction`. Otherwise CPU tensors take
    :func:`fused_mlp_reference` and CUDA tensors launch the plain variant of
    the kernel (counted in ``fused_mlp.launches``): x, w1, w2 bf16; lnw, lnb,
    b1, b2 fp32; all contiguous; D and H multiples of 64. Anything else
    raises."""
    args = (x, lnw, lnb, w1, b1, w2, b2)
    if through_ops():  # a trace (ops/custom.py): the op, run forward only
        return torch.ops.vitlens.fused_mlp(*args, act, eps)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return FusedMLPFunction.apply(*args, act, eps)
    if not x.is_cuda:
        return fused_mlp_reference(*args, act, eps)
    out = _launch(*args, act, eps, save_preact=False)
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0
fused_mlp_save_preact.launches = 0


@torch.library.custom_op("vitlens::fused_mlp", mutates_args=())
def _fused_mlp_op(x: torch.Tensor, lnw: torch.Tensor, lnb: torch.Tensor,
                  w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                  b2: torch.Tensor, act: str, eps: float) -> torch.Tensor:
    return fused_mlp(x, lnw, lnb, w1, b1, w2, b2, act, eps)


@_fused_mlp_op.register_fake
def _(x, lnw, lnb, w1, b1, w2, b2, act, eps):
    return torch.empty_like(x)
