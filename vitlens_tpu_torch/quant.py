"""Post-training int8 quantization (W8A8) for the encode path (port of
vitlens_tpu/quant.py).

The trunk matmuls (qkv, out-projection, MLP fc and proj) run int8 x int8 ->
int32 with

  * per-output-channel symmetric weight scales, made once
    (:func:`quantize_weight`), and
  * dynamic per-row (per-token) symmetric activation scales, computed at each
    call (:func:`int8_matmul`).

Opt-in and inference-only: ``quantize_model(model)`` returns a quantized copy
of a model built by ``factory.create_model`` (or of an ``api.ViTLens``, with
``towers=("towers.audio",)``); the train step never makes one. LayerNorm,
layer-scale, biases, the Lens, the adapter and the attention products stay
float. Whether the mode pays on an H100 is a measurement: PERF.md.

Layout: a quantized ``Linear`` holds the buffers ``w_q`` (int8 [K, N], the
JAX layout), ``w_s`` (fp32 [1, N]) and ``w_qt`` (int8 [N, K], the copy the
CUDA kernel reads, made once here or at load) and no float ``w``; a quantized
``MHA`` holds ``qkv_w_q``/``qkv_w_s``/``qkv_w_qt`` and the same for
``out_w``. ``models/layers.py`` dispatches on the presence of ``w_q``. No
parameter of a quantized module asks for a gradient.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from vitlens_tpu_torch.ops.int8_matmul import (dequant_reference,
                                               int8_matmul_dequant,
                                               int8_matmul_reference as _product_reference,
                                               int8_quantize,
                                               int8_quantize_reference)

_Q = 127.0


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., K, N] float -> (int8 [..., K, N], fp32 scales [..., 1, N]).

    Symmetric per output channel: s_n = max(amax_k |w[..., k, n]| / 127,
    1e-12), q = clip(round(w / s), -127, 127), with IEEE divisions on either
    device (see ``ops.int8_matmul.int8_quantize_reference``). Works unchanged
    on stacked [L, K, N] weights (the reduction is over axis -2 only)."""
    wf = w.detach().float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    s = (amax / amax.new_tensor(_Q)).clamp_min(1e-12)
    q = torch.round(wf / s).clamp(-_Q, _Q).to(torch.int8)
    return q, s


def int8_matmul_reference(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of :func:`int8_matmul`, on either device: the
    quantise step, the exact int8 product and the dequantise step as plain
    tensor code (``ops.int8_matmul``'s ``*_reference`` functions)."""
    shape = x.shape
    k, n = shape[-1], w_q.shape[-1]
    xi, xs = int8_quantize_reference(x.reshape(-1, k))
    y = dequant_reference(_product_reference(xi, w_q), xs, w_s, bias, x.dtype)
    return y.reshape(shape[:-1] + (n,))


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                w_qt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., K] @ dequant(w_q, w_s) with dynamic per-row activation
    quantization, in x.dtype.

    One amax over the contracted axis gives each row's scale in fp32
    (``ops.int8_quantize``); the int8 x int8 -> int32 product, the row scale,
    the column scale and the bias, applied in fp32 before the one cast, are
    ``ops.int8_matmul_dequant``. On CUDA tensors these are two kernel launches
    (the product reads ``w_qt``, w_q transposed), which make no other pass
    over the activations, as XLA fuses the JAX package's; on CPU tensors
    they are :func:`int8_matmul_reference`'s plain steps."""
    shape = x.shape
    k, n = shape[-1], w_q.shape[-1]
    xi, xs = int8_quantize(x.reshape(-1, k))
    if bias is not None:
        bias = bias.float()
    y = int8_matmul_dequant(xi, w_q, xs, w_s, bias, x.dtype, w_qt)
    return y.reshape(shape[:-1] + (n,))


def _swap_weight_(module: nn.Module, name: str) -> None:
    """Replace the float parameter ``name`` of ``module`` by the buffers
    ``<name>_q``, ``<name>_s`` and ``<name>_qt``."""
    q, s = quantize_weight(getattr(module, name))
    setattr(module, name, None)  # the parameter slot stays, empty
    setattr(module, f"{name}_q", q)
    setattr(module, f"{name}_s", s)
    setattr(module, f"{name}_qt", q.t().contiguous())


def quantize_resblocks(blocks: nn.Module) -> nn.Module:
    """Quantize, in place, the four trunk matmuls of every ``ResBlock`` under
    ``blocks`` (a ``Transformer`` or its ``ModuleList``). LayerNorm,
    layer-scale and biases stay float; the attention score and value
    products stay in the activation dtype."""
    from vitlens_tpu_torch.models.layers import ResBlock

    for block in blocks.modules():
        if isinstance(block, ResBlock) and not block.quantized:
            _swap_weight_(block.attn, "qkv_w")
            _swap_weight_(block.attn, "out_w")
            _swap_weight_(block.mlp.fc, "w")
            _swap_weight_(block.mlp.proj, "w")
    return blocks


def quantize_tower_params(
        tower: nn.Module,
        trunk_keys: Sequence[str] = ("trunk", "perceiver_transformer")) -> nn.Module:
    """Quantize, in place, every transformer trunk of one tower (a
    ``VisionTower`` or a ``TextTower``: both keep theirs under ``trunk``).
    A LoRA-adapted tower is rejected, as in JAX: quantizing the base weights
    would drop the adaptation; merge it first."""
    if getattr(tower, "lora", None) is not None:
        raise ValueError(
            "cannot quantize a LoRA-adapted tower: merge the adapters into "
            "plain weights first (ViTLens.export_params() / "
            "ViTLens.export_checkpoint(), or train/lora.py::merge_lora)")
    for key in trunk_keys:
        trunk = getattr(tower, key, None)
        if isinstance(trunk, nn.Module):
            quantize_resblocks(trunk)
    return tower


def quantize_model(model: nn.Module,
                   towers: Sequence[str] = ("visual",)) -> nn.Module:
    """Return a copy of ``model`` with the named towers' trunks quantized to
    int8; ``model`` itself is untouched. ``towers`` are submodule paths
    (``"visual"``, ``"text"`` of a ``TriModel``; ``"towers.audio"`` of a
    ``ViTLens``); a path the model lacks is skipped."""
    out = copy.deepcopy(model)
    modules = dict(out.named_modules())
    for t in towers:
        if t in modules:
            quantize_tower_params(modules[t])
    return out


def is_quantized(tower: nn.Module) -> bool:
    trunk = getattr(tower, "trunk", None)
    blocks = getattr(trunk, "blocks", None)
    return bool(blocks) and blocks[0].quantized
