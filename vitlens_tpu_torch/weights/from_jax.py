"""Loads a JAX-package parameter pytree (numpy arrays) into the port's modules.

The port's parameter names are the JAX key paths joined with dots, with two
structural differences handled here:

* a transformer's stacked ``blocks`` (every leaf with a leading [layers]
  axis) becomes ``blocks.<i>.<leaf path>``, one entry per layer (the
  trunks, PPAT's blocks; a ``blocks`` that holds a ``blocks`` of its own,
  as the PointTransformer's ``{"blocks": transformer_init(...)}`` does,
  is a plain subtree);
* lists (the perceiver's ``layers`` and ``self_blocks``) are indexed
  ``<name>.<i>``.

A tree quantized by the JAX package's ``quant.py`` (``w_q``/``w_s`` leaves in
place of ``w``, int8 [L, K, N] and fp32 [L, 1, N] under ``blocks``) loads into
a module quantized by the port's ``quant.py``: the int8 leaves and scales go
into the buffers of the same names, and the transposed copies the CUDA kernel
reads (``*_qt``) are remade from them.

Layouts are unchanged ([in, out] matmul weights, the OIHW audio conv). A key
of the tree that the module lacks, a module parameter the tree lacks, or a
shape mismatch raises. :func:`load_tri_params` loads a whole JAX
``tri_model_init`` tree, :func:`load_coca_params` a ``coca_init`` pair.
:func:`load_state` does the same for the JAX state
tree (the point tokenizers' BatchNorm running statistics: PointBERT's
``encoder.bn1/bn2``, PNSA's ``sa.{i}.bn``) and the module's buffers;
:func:`read_state` reads the buffers back into the layout of a JAX state
tree (a train step's ``model_state``). :func:`merge_params` is the
non-strict load of a checkpoint: it copies the leaves the trees have and
leaves the module's other parameters as they are. Values are copied into the existing parameters, so
they take each parameter's dtype and device (matmul weights already cast to
the compute dtype stay so).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn


def flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """JAX pytree -> {dotted port name: array}."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            name = f"{prefix}{k}"
            if k == "blocks" and isinstance(v, dict) and "blocks" not in v:
                for path, leaf in flatten(v).items():
                    for i in range(leaf.shape[0]):
                        out[f"{name}.{i}.{path}"] = leaf[i]
            else:
                out.update(flatten(v, name + "."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}."))
    elif tree is None:  # an absent module (a BERT tree without its pooler)
        pass
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _copy_into(module: nn.Module, tree: Any, targets: Dict[str, torch.Tensor],
               what: str, strict: bool = True) -> nn.Module:
    flat = flatten(tree)
    unknown = sorted(set(flat) - set(targets))
    missing = sorted(set(targets) - set(flat)) if strict else []
    if unknown or missing:
        raise KeyError(f"JAX {what} do not match {type(module).__name__}: "
                       f"unknown {unknown[:8]}, missing {missing[:8]}")
    with torch.no_grad():
        for name, arr in flat.items():
            p = targets[name]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: JAX shape {tuple(arr.shape)}, "
                                 f"port shape {tuple(p.shape)}")
            dtype = np.int8 if arr.dtype == np.int8 else np.float32
            p.copy_(torch.from_numpy(np.array(arr, dtype=dtype)))
    return module


def _quant_buffers(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The int8 weights, their scales and their transposed copies."""
    return {n: b for n, b in module.named_buffers()
            if n.endswith(("_q", "_s", "_qt"))}


def load_params(module: nn.Module, tree: Any) -> nn.Module:
    """Copy the JAX param tree ``tree`` into ``module`` in place. The leaves
    of a quantized tree go into the quantized module's buffers."""
    quant = _quant_buffers(module)
    targets = dict(module.named_parameters())
    targets.update((n, b) for n, b in quant.items() if not n.endswith("_qt"))
    _copy_into(module, tree, targets, "params")
    with torch.no_grad():
        for name, b in quant.items():
            if name.endswith("_qt"):
                b.copy_(quant[name[:-1]].t())
    return module


def load_tri_params(model: nn.Module, params: Any) -> nn.Module:
    """Copy a JAX ``tri_model_init`` param tree (image, visual and text
    towers, logit scale) into the port's ``TriModel``."""
    return load_params(model, params)


def load_coca_params(model: nn.Module, params: Any, state: Any = None) -> nn.Module:
    """Copy a JAX ``coca_init`` (params, state) pair into the port's
    ``models.coca.CoCa``: the stacked ``resblocks.blocks`` and
    ``cross_attn.blocks`` unstack into its blocks; the state tree holds no
    leaf (the image adapter keeps no statistics)."""
    load_params(model, params)
    return model if state is None else load_state(model, state)


def load_state(module: nn.Module, tree: Any) -> nn.Module:
    """Copy the JAX state tree ``tree`` (e.g. ``{"adapter": {"encoder":
    {"bn1": {"mean", "var"}, ...}}}``) into ``module``'s buffers in place."""
    quant = _quant_buffers(module)
    targets = {n: b for n, b in module.named_buffers() if n not in quant}
    return _copy_into(module, tree, targets, "state")


def read_state(module: nn.Module, like: Any) -> Any:
    """The module's buffers as a tree of fp32 numpy arrays with the structure
    of the JAX state tree ``like`` (dicts and lists; its leaves only name
    the buffers)."""
    buffers = dict(module.named_buffers())

    def build(tree, prefix):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}{k}.") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [build(v, f"{prefix}{i}.") for i, v in enumerate(tree)]
        return buffers[prefix[:-1]].detach().float().cpu().numpy()

    return build(like, "")


def merge_params(module: nn.Module, params: Any, state: Any = None) -> nn.Module:
    """Non-strict load (the JAX factory's ``_merge`` of a converted
    checkpoint over the initial tree): copy every leaf of ``params`` and
    ``state`` into the parameter or buffer of the same name. Parameters the
    trees lack keep their values; a leaf the module lacks, or of another
    shape, raises."""
    _copy_into(module, params, dict(module.named_parameters()), "params",
               strict=False)
    if state is not None:
        _copy_into(module, state, dict(module.named_buffers()), "state",
                   strict=False)
    return module
