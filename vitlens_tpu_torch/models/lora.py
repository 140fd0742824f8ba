"""LoRA factors of a tower's trunk and their merge (the model side of
``train/lora.py``).

A target W [in, out] of trunk block i gets ``a`` [in, r] and ``b`` [r, out]
at ``lora.trunk.blocks.<i>.<target path>`` of the :class:`LoRA` module a
tower carries as ``tower.lora``, beside ``lora.scale`` = alpha / r: the names
``weights/from_jax.py`` gives JAX's ``"lora"`` subtree. The merge
W + scale * a @ b (:func:`merged_block_weights`) is model arithmetic, run
inside each block's own forward (``ResBlock.forward`` with ``lora=``, in
``models/layers.py``) under autograd: under FSDP2 that is after the block's
pre-forward hook has gathered its weights, and under remat inside the
block's checkpoint. The block runs on the merged tensors put in its
weights' places (:func:`swapped_weights`), not through
``torch.func.functional_call``, which would call the block (and FSDP2's
hooks on it) a second time.
"""

from __future__ import annotations

import logging
from contextlib import contextmanager
from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn

from vitlens_tpu_torch.parallel.mesh import model_copy
from vitlens_tpu_torch.parallel.tp import TRUNK_SPECS, local_part

# dotted paths within one trunk block (models/layers.py ResBlock): every
# matmul of the block
DEFAULT_TARGETS: Tuple[str, ...] = (
    "attn.qkv_w", "attn.out_w", "mlp.fc.w", "mlp.proj.w",
)


class Factors(nn.Module):
    """a [in, r] and b [r, out] of one adapted weight."""

    def __init__(self, fan_in: int, fan_out: int, rank: int, device=None):
        super().__init__()
        self.a = nn.Parameter(torch.empty(fan_in, rank, device=device),
                              requires_grad=False)
        self.b = nn.Parameter(torch.zeros(rank, fan_out, device=device),
                              requires_grad=False)


def _get(module: nn.Module, path: Sequence[str]):
    for k in path:
        module = getattr(module, k, None)
        if module is None:
            return None
    return module


class LoRA(nn.Module):
    """The ``"lora"`` subtree of one tower: ``scale`` and, per trunk block,
    a nested ModuleDict of :class:`Factors` along each target's path."""

    def __init__(self, trunk: nn.Module, rank: int, alpha=None,
                 targets: Sequence[str] = DEFAULT_TARGETS, device=None):
        super().__init__()
        if rank <= 0:
            raise ValueError(f"lora rank must be positive, got {rank}")
        self.rank = rank
        scale = (alpha if alpha is not None else float(rank)) / float(rank)
        self.scale = nn.Parameter(torch.tensor(scale, device=device),
                                  requires_grad=False)
        self.targets = []
        unmatched = []
        for t in targets:
            path = t.strip().split(".")
            w = _get(trunk.blocks[0], path)
            if not isinstance(w, torch.Tensor):
                # tolerated so that one target list serves every arch, but
                # said: a typo would silently train fewer adapters
                unmatched.append(t.strip())
                continue
            if w.dim() != 2:
                raise ValueError(f"lora target {t} has ndim {w.dim()}; "
                                 "expected [in, out]")
            self.targets.append(tuple(path))
        if not self.targets:
            raise ValueError(f"no lora target in {tuple(targets)!r} matched "
                             "this tower")
        if unmatched:
            logging.warning(f"lora_init: targets {unmatched} matched nothing "
                            "in this tower's trunk blocks and were skipped")
        self.trunk = nn.Module()
        self.trunk.blocks = nn.ModuleList()
        for block in trunk.blocks:
            node = nn.ModuleDict()
            for path in self.targets:
                w = _get(block, path)
                d = node
                for k in path[:-1]:
                    if k not in d:
                        d[k] = nn.ModuleDict()
                    d = d[k]
                d[path[-1]] = Factors(w.shape[0], w.shape[1], rank, device)
            self.trunk.blocks.append(node)

    def init_(self, g: torch.Generator) -> None:
        """a ~ N(0, 1/r), b = 0, block by block, target by target."""
        with torch.no_grad():
            for node in self.trunk.blocks:
                for path in self.targets:
                    f = _get(node, path)
                    f.a.normal_(0.0, self.rank ** -0.5, generator=g)
                    f.b.zero_()

    def factors(self, i: int):
        """[(target path, Factors)] of trunk block ``i``."""
        node = self.trunk.blocks[i]
        return [(path, _get(node, path)) for path in self.targets]


def merged_block_weights(lora: LoRA, i: int,
                         block: nn.Module) -> Dict[str, torch.Tensor]:
    """{dotted name in ``block``: W + scale * a @ b} of trunk block ``i``,
    in W's dtype (JAX ``_merge_into``).

    In a block split over a model axis (``block.tp``, ``parallel.tp``) W is
    the rank's slice, and so is the delta: the factor on W's split axis is
    cut as :func:`parallel.tp.local_part` cuts W (``b``'s columns, head by
    head for the packed qkv, for a column-parallel W; ``a``'s rows for a
    row-parallel one), the other stays whole; (a @ b)'s slice is the
    product of those. The factors are whole on every model rank and each
    rank's gradient covers its slice alone, so both pass Megatron's f
    (``model_copy``) first, whose backward sums them over the model
    axis."""
    tp = getattr(block, "tp", None)
    out = {}
    for path, f in lora.factors(i):
        name = ".".join(path)
        w = _get(block, path)
        a, b = f.a, f.b
        if tp is not None:
            a, b = model_copy(a, tp), model_copy(b, tp)
            if TRUNK_SPECS[name] == 0:
                a = local_part(name, a, block.attn.heads, tp.model,
                               tp.model_rank)
            else:
                b = local_part(name, b, block.attn.heads, tp.model,
                               tp.model_rank)
        delta = lora.scale.to(w.dtype) * (a.to(w.dtype) @ b.to(w.dtype))
        out[name] = w + delta
    return out


@contextmanager
def swapped_weights(module: nn.Module, weights: Dict[str, torch.Tensor]):
    """Inside, each parameter of ``module`` named in ``weights`` (dotted
    names) reads as the given tensor, which takes its slot as
    ``torch.func.functional_call`` puts it; the parameters are back on
    exit."""
    saved = []
    try:
        for name, t in weights.items():
            owner = module.get_submodule(name.rpartition(".")[0])
            leaf = name.rpartition(".")[2]
            saved.append((owner, leaf, owner._parameters[leaf]))
            owner._parameters[leaf] = t
        yield
    finally:
        for owner, leaf, p in reversed(saved):
            owner._parameters[leaf] = p
