"""LoRA factors of a tower's trunk and their merge (the model side of
``train/lora.py``).

A target W [in, out] of trunk block i gets ``a`` [in, r] and ``b`` [r, out]
at ``lora.trunk.blocks.<i>.<target path>`` of the :class:`LoRA` module a
tower carries as ``tower.lora``, beside ``lora.scale`` = alpha / r: the names
``weights/from_jax.py`` gives JAX's ``"lora"`` subtree. The merge
W + scale * a @ b (:func:`merged_block_weights`) is model arithmetic, run
block by block inside ``Transformer.forward`` (``models/layers.py``) under
autograd.
"""

from __future__ import annotations

import logging
from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn

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
    in W's dtype (JAX ``_merge_into``)."""
    out = {}
    for path, f in lora.factors(i):
        w = _get(block, path)
        delta = lora.scale.to(w.dtype) * (f.a.to(w.dtype) @ f.b.to(w.dtype))
        out[".".join(path)] = w + delta
    return out
