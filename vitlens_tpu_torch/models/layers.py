"""Core transformer building blocks (port of vitlens_tpu/models/layers.py).

Parameter names and layouts follow the JAX pytree so that
``weights/from_jax.py`` is a plain copy: matmul weights are [in, out], the
LayerNorm parameters are ``scale``/``bias``, attention keeps the packed
``qkv_w``. The stacked trunk (one leading [layers] axis in JAX) is an
``nn.ModuleList`` of blocks here.

Numerical contracts, as in JAX: LayerNorm in fp32 cast back; exact-erf GELU;
QuickGELU x * sigmoid(1.702 x); weights, biases and LayerNorm parameters cast
to the activation dtype at use (a no-op for frozen matmul weights, which the
factory casts to the compute dtype once at load; trainable ones stay fp32
masters and the cast carries their gradient).

A ``Linear`` or ``MHA`` quantized by ``quant.py`` holds int8 weights and
their scales as buffers in place of its float weight and sends its product
through ``quant.int8_matmul``; the dispatch is on the presence of ``w_q``, as
the JAX package dispatches on the key.

Each module's ``init_(g)`` fills its parameters from the ``torch.Generator``
``g`` with the JAX package's init distributions.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from vitlens_tpu_torch.ops.attention import dot_product_attention
from vitlens_tpu_torch.ops.fused_ln_proj import (fused_ln_proj_applicable,
                                                 fused_ln_proj_available,
                                                 fused_ln_qkv)
from vitlens_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_applicable
from vitlens_tpu_torch.quant import int8_matmul
from vitlens_tpu_torch.models.lora import merged_block_weights
from vitlens_tpu_torch.parallel.mesh import (model_copy, model_gather,
                                             model_reduce_scatter, model_sum)

# Leaf names of the parameters that feed a matmul or a convolution: the
# factory casts exactly these to the compute dtype once, at load (q_w, k_w and
# v_w are CoCa's attentional pooler's).
MATMUL_WEIGHTS = frozenset({"w", "qkv_w", "out_w", "proj", "text_projection",
                            "q_w", "k_w", "v_w"})


def _param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device), requires_grad=False)


def _quant_slots(module: nn.Module, name: str) -> None:
    """Empty buffers for the int8 form of the weight ``name``: ``<name>_q``
    (int8 [K, N]), ``<name>_s`` (fp32 [1, N]) and ``<name>_qt`` (int8 [N, K],
    what the CUDA kernel reads). ``quant.py`` fills them."""
    for suffix in ("_q", "_s", "_qt"):
        module.register_buffer(name + suffix, None)


def normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    with torch.no_grad():
        t.normal_(0.0, std, generator=g)


def uniform_(t: torch.Tensor, bound: float, g: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=g)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, fp32 compute, cast back to x.dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = _param(dim, device=device)
        self.bias = _param(dim, device=device)

    def init_(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, self.eps)


class Linear(nn.Module):
    """y = x @ w + b with w [in, out]."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, device=None):
        super().__init__()
        self.w = _param(d_in, d_out, device=device)
        self.b = _param(d_out, device=device) if bias else None
        _quant_slots(self, "w")

    def init_(self, g: torch.Generator) -> None:
        """torch nn.Linear's default init, in the [in, out] layout."""
        fan_in = self.w.shape[0]
        uniform_(self.w, math.sqrt(1.0 / fan_in) * math.sqrt(3.0), g)
        if self.b is not None:
            uniform_(self.b, 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0, g)

    def forward(self, x):
        if self.w_q is not None:  # int8-quantized (quant.py)
            return int8_matmul(x, self.w_q, self.w_s, self.b, self.w_qt)
        y = x @ self.w.to(x.dtype)
        if self.b is not None:
            y = y + self.b.to(x.dtype)
        return y


class MHA(nn.Module):
    """Self-attention on [B, N, D] with a packed qkv projection
    (torch nn.MultiheadAttention semantics)."""

    def __init__(self, dim: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.qkv_w = _param(dim, 3 * dim, device=device)
        self.qkv_b = _param(3 * dim, device=device)
        self.out_w = _param(dim, dim, device=device)
        self.out_b = _param(dim, device=device)
        _quant_slots(self, "qkv_w")
        _quant_slots(self, "out_w")

    def init_(self, g: torch.Generator) -> None:
        dim = self.out_w.shape[0]
        # xavier_uniform_ over the packed [3*dim, dim] in_proj weight
        uniform_(self.qkv_w, math.sqrt(6.0 / (dim + 3 * dim)), g)
        uniform_(self.out_w, math.sqrt(1.0 / dim) * math.sqrt(3.0), g)
        with torch.no_grad():
            self.qkv_b.zero_()
            self.out_b.zero_()

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        if self.qkv_w_q is not None:  # int8-quantized (quant.py)
            qkv = int8_matmul(x, self.qkv_w_q, self.qkv_w_s, self.qkv_b,
                              self.qkv_w_qt)
        else:
            qkv = x @ self.qkv_w.to(x.dtype) + self.qkv_b.to(x.dtype)
        return self.from_qkv(qkv, mask)

    def from_qkv(self, qkv, mask: Optional[torch.Tensor] = None):
        """Attention and the out-projection given the packed [B, N, 3D]
        projection (JAX ``_attn_from_qkv``)."""
        o = attend_packed(qkv, self.heads, mask)
        if self.out_w_q is not None:  # int8-quantized (quant.py)
            return int8_matmul(o, self.out_w_q, self.out_w_s, self.out_b,
                               self.out_w_qt)
        return o @ self.out_w.to(qkv.dtype) + self.out_b.to(qkv.dtype)


def attend_packed(qkv, heads: int, mask: Optional[torch.Tensor] = None):
    """Attention of the packed [B, N, 3 * heads * Dh] projection ([q|k|v],
    each head-major) -> [B, N, heads * Dh]."""
    B, N, D3 = qkv.shape
    D = D3 // 3
    # q, k, v are strided views of the packed projection (the kernel reads
    # them in place) and the kernel's output is [B, N, H, Dh] seen as
    # [B, H, N, Dh], so the reshape back to [B, N, D] is a view too.
    q, k, v = qkv.view(B, N, 3, heads, D // heads).permute(2, 0, 3, 1, 4)
    o = dot_product_attention(q, k, v, mask=mask)
    return o.transpose(1, 2).reshape(B, N, D)


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc = Linear(dim, hidden, device=device)
        self.proj = Linear(hidden, dim, device=device)

    def init_(self, g: torch.Generator) -> None:
        self.fc.init_(g)
        self.proj.init_(g)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float, device=None):
        super().__init__()
        self.init_value = init_value
        self.gamma = _param(dim, device=device)

    def init_(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.gamma.fill_(self.init_value)

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class ResBlock(nn.Module):
    """Pre-LN residual attention block. The MLP half of a bf16 block goes
    through ``ops.fused_mlp`` (the kernel on CUDA); a block in another dtype
    (``fused_mlp_applicable``) or with layer-scale takes the plain
    composition, as in JAX, since the kernel takes bf16 and has no
    layer-scale.
    With ``VITLENS_ENABLE_FUSED_LNQKV`` set, the front half (ln_1 + the
    packed qkv projection) goes through ``ops.fused_ln_proj`` where it
    applies (bf16, widths multiples of 128), as in JAX. A quantized block
    (``quant.quantize_resblocks``) takes the plain composition for both
    halves, as in JAX: neither kernel reads int8 weights. ``ln_eps`` is
    both LayerNorms' eps (EVA's 1e-6), which the kernels take too.

    ``tp`` is the mesh whose model axis splits the block (Megatron tensor
    parallelism, set by ``parallel.tp.shard_vision_tower``, which also cuts
    the weights) or None. A block called with ``sp`` (a
    :class:`SequenceFrame`, from a :class:`Transformer` inside
    ``parallel.sp.sequence_sharded_activations``) holds this model rank's
    rows of the sequence. Either takes :meth:`model_axis_forward`."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0,
                 ls_init_value: Optional[float] = None,
                 quick: bool = False, device=None, ln_eps: float = 1e-5):
        super().__init__()
        self.tp = None
        self.act = "quick_gelu" if quick else "gelu"
        self.ln_1 = LayerNorm(dim, ln_eps, device=device)
        self.attn = MHA(dim, heads, device=device)
        self.ln_2 = LayerNorm(dim, ln_eps, device=device)
        self.mlp = MLP(dim, int(dim * mlp_ratio), device=device)
        if ls_init_value is not None:
            self.ls_1 = LayerScale(dim, ls_init_value, device=device)
            self.ls_2 = LayerScale(dim, ls_init_value, device=device)
        else:
            self.ls_1 = self.ls_2 = None

    def init_(self, g: torch.Generator) -> None:
        for m in (self.ln_1, self.attn, self.ln_2, self.mlp, self.ls_1,
                  self.ls_2):
            if m is not None:
                m.init_(g)

    @property
    def quantized(self) -> bool:
        return self.attn.qkv_w_q is not None

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                sp: Optional["SequenceFrame"] = None):
        if self.tp is not None or sp is not None:
            return self.model_axis_forward(x, mask, sp)
        if (not self.quantized and fused_ln_proj_available()
                and fused_ln_proj_applicable(x, self.attn.qkv_w)):
            a = self.attn.from_qkv(fused_ln_qkv(x, self.ln_1, self.attn), mask)
        else:
            a = self.attn(self.ln_1(x), mask)
        if self.ls_1 is not None:
            a = self.ls_1(a)
        x = x + a
        if (self.ls_2 is not None or self.mlp.fc.w_q is not None
                or not fused_mlp_applicable(x)):
            act = quick_gelu if self.act == "quick_gelu" else gelu
            h = self.mlp.proj(act(self.mlp.fc(self.ln_2(x))))
            return x + (h if self.ls_2 is None else self.ls_2(h))
        d = x.shape[-1]
        fc, proj = self.mlp.fc, self.mlp.proj
        out = fused_mlp(x.reshape(-1, d), self.ln_2.scale.float(),
                        self.ln_2.bias.float(), fc.w.to(x.dtype), fc.b.float(),
                        proj.w.to(x.dtype), proj.b.float(), self.act,
                        self.ln_2.eps)
        return out.reshape(x.shape)

    def model_axis_forward(self, x, mask: Optional[torch.Tensor] = None,
                           sp: Optional["SequenceFrame"] = None):
        """The block split over a model axis, the same function as
        :meth:`forward` on the whole sequence.

        Tensor parallelism (``self.tp``; JAX's ``parallel/tp.py`` specs):
        this rank holds its heads' columns of the packed qkv (q, k and v
        alike) and their rows of ``out_w``, and its columns of the MLP's
        ``fc`` and rows of ``proj``; Megatron's f (``model_copy``) stands
        in front of each column-parallel product and g (``model_sum``)
        after each row-parallel one, and ``out_b`` and ``proj.b`` are added
        once, after g. Attention runs on the rank's own heads (kernel 2 in
        bf16). Where the ranks cannot split the heads (``heads % tp``),
        this rank holds JAX's contiguous columns of the packed qkv: they are
        gathered, attention runs on all heads and the rank keeps its
        columns of the output for ``out_w``. The MLP takes the plain
        composition, as JAX's TP trunk does: kernel 1 adds the residual and
        ``proj.b`` itself, which a rank's partial product must not get.

        Sequence parallelism (``sp``): ``x`` is this rank's rows. Alone,
        the rank runs ln_1, the products and the MLP (kernel 1 in bf16,
        which works row by row) on its rows, and its queries attend to the
        keys and values of every rank, gathered (kernel 2: NQ rows against
        NK). With tensor parallelism (Megatron-SP) the rows are gathered in
        front of each column-parallel product and reduce-scattered after
        each row-parallel one. A replicated parameter used on a rank's rows
        gets that rank's part of its gradient: ``model_copy`` sums them.
        Padded rows (``sp.rows`` * tp >= N) are never keys.

        The LayerNorms and products are plain: kernel 6 (the opt-in LN +
        qkv) runs in the unsplit block alone. A quantized block is not split
        (``parallel.tp`` refuses it)."""
        if self.quantized:
            raise NotImplementedError("a quantized block does not run split "
                                      "over a model axis")
        tp = self.tp
        mesh = tp if tp is not None else sp.mesh
        attn, fc, proj = self.attn, self.mlp.fc, self.mlp.proj
        dt = x.dtype

        def part(t):  # a replicated parameter used on this rank's rows
            return model_copy(t, mesh) if sp is not None else t

        def ln(m, h):
            return layer_norm(h, part(m.scale), part(m.bias), m.eps)

        h = ln(self.ln_1, x)
        if tp is None:  # sequence parallelism alone: replicated weights
            qkv = h @ part(attn.qkv_w).to(dt) + part(attn.qkv_b).to(dt)
            d = qkv.shape[-1] // 3
            kv = model_gather(qkv[..., d:], mesh, 1)[:, :sp.n]
            a = _attend_rows(qkv[..., :d], kv, attn.heads, sp.mask_rows(mask))
            a = a @ part(attn.out_w).to(dt) + part(attn.out_b).to(dt)
        else:
            h = (model_copy(h, mesh) if sp is None else
                 model_gather(h, mesh, 1)[:, :sp.n])
            qkv = h @ attn.qkv_w.to(dt) + attn.qkv_b.to(dt)
            if attn.heads % mesh.model == 0:
                o = attend_packed(qkv, attn.heads // mesh.model, mask)
            else:  # JAX's contiguous columns: gather, keep the rank's
                o = attend_packed(model_gather(qkv, mesh, -1), attn.heads,
                                  mask)
                w = o.shape[-1] // mesh.model
                o = o[..., mesh.model_rank * w:(mesh.model_rank + 1) * w]
            a = o @ attn.out_w.to(dt)
            a = (model_sum(a, mesh) if sp is None else
                 model_reduce_scatter(sp.pad(a), mesh, 1))
            a = a + part(attn.out_b).to(dt)
        if self.ls_1 is not None:
            a = a * part(self.ls_1.gamma).to(dt)
        x = x + a
        act = quick_gelu if self.act == "quick_gelu" else gelu
        if tp is None:
            if (self.ls_2 is None and fused_mlp_applicable(x)):
                out = fused_mlp(
                    x.reshape(-1, x.shape[-1]), part(self.ln_2.scale).float(),
                    part(self.ln_2.bias).float(), part(fc.w).to(dt),
                    part(fc.b).float(), part(proj.w).to(dt),
                    part(proj.b).float(), self.act, self.ln_2.eps)
                return out.reshape(x.shape)
            h = act(ln(self.ln_2, x) @ part(fc.w).to(dt) + part(fc.b).to(dt))
            h = h @ part(proj.w).to(dt) + part(proj.b).to(dt)
        else:
            h = ln(self.ln_2, x)
            h = model_copy(h, mesh) if sp is None else model_gather(h, mesh, 1)
            h = act(h @ fc.w.to(dt) + fc.b.to(dt)) @ proj.w.to(dt)
            h = (model_sum(h, mesh) if sp is None else
                 model_reduce_scatter(h, mesh, 1))
            h = h + part(proj.b).to(dt)
        if self.ls_2 is not None:
            h = h * part(self.ls_2.gamma).to(dt)
        return x + h


def _attend_rows(q, kv, heads: int, mask: Optional[torch.Tensor]):
    """Attention of this rank's queries q [B, NQ, D] to every key and value,
    kv [B, NK, 2D] ([k|v]) -> [B, NQ, D]."""
    B, nq, D = q.shape
    dh = D // heads
    q = q.view(B, nq, heads, dh).transpose(1, 2)
    k, v = kv.view(B, kv.shape[1], 2, heads, dh).permute(2, 0, 3, 1, 4)
    o = dot_product_attention(q, k, v, mask=mask)
    return o.transpose(1, 2).reshape(B, nq, D)


# The activation hook of ``parallel.sp.sequence_sharded_activations`` (JAX's
# ``set_activation_constraint``): a :class:`SequenceSharding` under which
# every Transformer keeps its carry sequence-sharded over a model axis
# between blocks, or None.
_ACTIVATION_CONSTRAINT = None


def set_activation_constraint(constraint) -> None:
    global _ACTIVATION_CONSTRAINT
    _ACTIVATION_CONSTRAINT = constraint


class SequenceFrame:
    """The sequence split of one Transformer call: the true length ``n``,
    the ``rows`` each model rank holds (the length padded to a multiple of
    the model axis, divided by it) and the ``mesh``."""

    def __init__(self, mesh, n: int):
        self.mesh, self.n = mesh, n
        self.rows = -(-n // mesh.model)

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        """[B, n, ...] -> [B, rows * tp, ...], zero rows appended."""
        extra = self.rows * self.mesh.model - x.shape[1]
        if not extra:
            return x
        return torch.cat([x, x.new_zeros((x.shape[0], extra) + x.shape[2:])], 1)

    def mask_rows(self, mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's query rows of an additive [n, n] mask (padded rows
        see every key)."""
        if mask is None:
            return None
        r0 = self.mesh.model_rank * self.rows
        rows = mask[r0:r0 + self.rows]
        if rows.shape[0] < self.rows:
            rows = torch.cat([rows, rows.new_zeros(
                (self.rows - rows.shape[0],) + rows.shape[1:])])
        return rows


class Transformer(nn.Module):
    """A stack of residual blocks (JAX: stacked params under ``blocks``)."""

    def __init__(self, dim: int, layers: int, heads: int,
                 mlp_ratio: float = 4.0, ls_init_value: Optional[float] = None,
                 quick: bool = False, device=None, ln_eps: float = 1e-5):
        super().__init__()
        self.blocks = nn.ModuleList(
            ResBlock(dim, heads, mlp_ratio, ls_init_value, quick, device=device,
                     ln_eps=ln_eps)
            for _ in range(layers))

    def init_(self, g: torch.Generator) -> None:
        for b in self.blocks:
            b.init_(g)

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                skip_first_n: Optional[int] = None, remat=False, lora=None):
        """``skip_first_n`` drops the first N blocks (the vitlensG recipe).
        ``remat`` recomputes each block in the backward pass with
        non-reentrant ``torch.utils.checkpoint`` (JAX ``jax.checkpoint`` of
        the scan body); it only acts while autograd records. See
        :func:`remat_policy` for its values. ``lora`` (``models/lora.py``)
        runs each block on its merged weights, merged inside the block's
        checkpoint. Inside ``parallel.pp.pipelined_trunks`` a trunk whose
        depth after ``skip_first_n`` divides the stages and whose batch
        divides the microbatches runs the GPipe schedule instead (JAX's
        gate; it takes precedence over sequence parallelism)."""
        first = skip_first_n or 0
        if _TRUNK_PIPELINE is not None:
            mesh, n_mb = _TRUNK_PIPELINE
            if ((len(self.blocks) - first) % mesh.pipe == 0
                    and x.shape[0] % n_mb == 0):
                from vitlens_tpu_torch.parallel.pp import pipeline_transformer

                return pipeline_transformer(
                    x, self, mask, mesh=mesh, n_microbatches=n_mb,
                    remat=remat, skip_first_n=first, lora=lora)
        policy = remat_policy(remat)
        hook = _ACTIVATION_CONSTRAINT
        sp = None
        if hook is not None and x.ndim == 3:  # the carry, sequence-sharded
            x, sp = hook.shard(x)
        for i, b in enumerate(self.blocks[first:], start=first):
            x = run_block(b, i, x, mask, policy, lora, sp)
        return x if sp is None else hook.unshard(x, sp)


# The trunk-pipelining hook of ``parallel.pp.pipelined_trunks`` (JAX's
# ``set_trunk_pipeline``): a (pipe mesh, n_microbatches) pair, or None.
_TRUNK_PIPELINE = None


def set_trunk_pipeline(cfg) -> None:
    global _TRUNK_PIPELINE
    _TRUNK_PIPELINE = cfg


def run_block(block, i: int, x, mask=None, policy: Optional[str] = None,
              lora=None, sp=None):
    """Trunk block ``i`` on ``x``: on ``lora``'s merged weights where given,
    recomputed in the backward pass under the remat ``policy``
    (:func:`remat_policy`'s) while autograd records."""
    if lora is not None:
        block = functools.partial(_lora_block, lora, i, block)
    if policy is None or not torch.is_grad_enabled():
        return block(x, mask, sp)
    if policy == "dots":
        return checkpoint(block, x, mask, sp, use_reentrant=False,
                          context_fn=_save_2d_products_context)
    return checkpoint(block, x, mask, sp, use_reentrant=False)


def _lora_block(lora, i, block, x, mask, sp=None):
    """Block ``i`` on W + scale * a @ b for each weight ``lora`` adapts."""
    return functional_call(block, merged_block_weights(lora, i, block),
                           (x, mask, sp))


# The 2-D products of a block: the qkv and out projections and the plain
# MLP's two products (``x @ w`` on [B, N, D] dispatches as ``mm`` on a view,
# with the bias added after it), and ``addmm`` where a bias is fused.
_2D_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_2d_products(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _2D_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_2d_products_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(_save_2d_products)


def remat_policy(remat) -> Optional[str]:
    """The remat setting of a train step: False/None -> None (no remat);
    True or "full" -> "full" (recompute the whole block); a tag holding
    "dots" -> "dots": JAX's ``dots_with_no_batch_dims_saveable``, here a
    selective checkpoint that saves the outputs of the 2-D products
    (``aten.mm``/``aten.addmm``: qkv, out and the plain MLP) and recomputes
    the rest, the batched ``bmm`` of attention included. The hand kernels
    (fused MLP, attention) launch inside autograd Functions through ctypes,
    where no policy sees a product, so they are recomputed, as JAX
    recomputes a ``pallas_call`` (it is no ``dot_general``). "nocse" is a
    JAX-only tag (no CSE guard inside a scan) and means full remat here."""
    if remat is None or remat is False:
        return None
    if remat is True:
        return "full"
    tag = str(remat)
    if "dots" in tag:
        return "dots"
    if tag in ("full", "nocse", "full_nocse"):
        return "full"
    raise ValueError(f"unknown remat setting {remat!r}")
