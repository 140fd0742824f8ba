"""Megatron tensor parallelism of a tower's trunk (port of
vitlens_tpu/parallel/tp.py).

JAX expresses it as NamedShardings on the parameter pytree and lets GSPMD
insert the collectives. The port runs one process a rank: each model rank
keeps its slice of each trunk block's weights, and the block itself knows it
is split (``ResBlock.tp``) and runs ``ResBlock.model_axis_forward``, whose
collectives over the mesh's model axis are Megatron's f and g
(``parallel.mesh.model_copy``, ``model_sum``).

The split, per trunk block, is JAX's (:data:`TRUNK_SPECS`): the packed qkv
and the MLP's ``fc`` split their output (column parallel), ``out_w`` and the
MLP's ``proj`` their input (row parallel); everything else (the LayerNorms,
``out_b``, ``proj.b``, layer-scale, the embeddings, the Lens, ``ln_post``,
the projection) stays whole on every rank.

The packed qkv [D, 3D] is cut otherwise than in JAX. JAX gives device r the
contiguous columns [r * 3D / tp, (r + 1) * 3D / tp) of [q|k|v] and lets GSPMD
gather the activations before attention. Here model rank r holds the heads
[r * H / tp, (r + 1) * H / tp) of q, of k and of v alike (:func:`local_part`),
so attention runs on the rank's own heads with no gather of activations: the
same function. Where tp does not divide the heads (JAX allows it while it
divides 3D), the rank holds JAX's contiguous columns and the block gathers
them (``model_axis_forward``). The head-wise order is made at placement and
undone by :func:`whole` (checkpoints are written in JAX's layout).

JAX turns the fused-MLP kernel off process-wide under TP; the port's gate
is the block's own (a split block's MLP takes the plain composition, and
its LN + qkv too: kernel 6, the opt-in, runs in unsplit blocks alone).
Kernel 5 (the point encoder) sits in the pc tokenizer, which TP leaves
whole, and runs as it does without TP.

A tower's LoRA factors (``tower.lora``, ``train/lora.py``) stay whole on
every model rank, as JAX's specs leave everything outside ``trunk.blocks``
replicated; a split block merges its slice of the delta
(``models.lora.merged_block_weights``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from vitlens_tpu_torch.parallel.mesh import Mesh

# {parameter path within a trunk block: the axis it splits} (JAX's
# ``_trunk_blocks_specs`` less the stacked layer axis); a block's other
# parameters stay whole
TRUNK_SPECS = {
    "attn.qkv_w": 1,   # [D, 3D] column parallel
    "attn.qkv_b": 0,
    "attn.out_w": 0,   # [D, D] row parallel
    "mlp.fc.w": 1,     # [D, H] column parallel
    "mlp.fc.b": 0,
    "mlp.proj.w": 0,   # [H, D] row parallel
}


def vision_tower_specs(tower: nn.Module) -> Dict[str, Optional[int]]:
    """{parameter name of ``tower``: the axis TP splits, or None}: the
    trunk's blocks' :data:`TRUNK_SPECS`, every other parameter whole."""
    out = {}
    for name, _ in tower.named_parameters():
        parts = name.split(".")
        spec = None
        if parts[:2] == ["trunk", "blocks"] and len(parts) > 3:
            spec = TRUNK_SPECS.get(".".join(parts[3:]))
        out[name] = spec
    return out


def _headwise(suffix: str, heads: int, tp: int) -> bool:
    """True where ``suffix`` (a TRUNK_SPECS key) is cut head by head."""
    return suffix in ("attn.qkv_w", "attn.qkv_b") and heads % tp == 0


def local_part(suffix: str, whole_t: torch.Tensor, heads: int, tp: int,
               rank: int) -> torch.Tensor:
    """Model rank ``rank``'s slice of a trunk block's parameter (or AdamW
    moment) ``suffix`` from its whole, JAX-layout tensor: the heads of q, k
    and v alike for the packed qkv where ``tp`` divides the heads, else the
    rank's contiguous share of the split axis."""
    axis = TRUNK_SPECS[suffix]
    if _headwise(suffix, heads, tp):
        lead = whole_t.shape[:-1]
        t = whole_t.reshape(lead + (3, tp, -1))
        return t[..., rank, :].reshape(lead + (-1,))
    n = whole_t.shape[axis] // tp
    return whole_t.narrow(axis, rank * n, n)


def whole(suffix: str, parts: List[torch.Tensor], heads: int) -> torch.Tensor:
    """The whole, JAX-layout tensor from every model rank's
    :func:`local_part`, in rank order."""
    tp = len(parts)
    if _headwise(suffix, heads, tp):
        lead = parts[0].shape[:-1]
        t = torch.stack([p.reshape(lead + (3, -1)) for p in parts], -2)
        return t.reshape(lead + (-1,))
    return torch.cat(parts, TRUNK_SPECS[suffix])


def _check_block(block, tp: int) -> None:
    heads, d = block.attn.heads, block.attn.out_w.shape[0]
    hidden = block.mlp.fc.w.shape[1]
    if block.quantized:
        raise NotImplementedError("a quantized trunk is not split over a "
                                  "model axis")
    if heads % tp and (3 * d) % tp:
        raise ValueError(f"tp={tp} divides neither the {heads} heads nor the "
                         f"packed qkv width {3 * d}")
    if d % tp or hidden % tp:
        raise ValueError(f"tp={tp} does not divide the width {d} or the MLP "
                         f"width {hidden}")


def shard_vision_tower(tower: nn.Module, mesh: Mesh) -> nn.Module:
    """Split ``tower``'s trunk over ``mesh``'s model axis in place and
    return it: each block keeps this model rank's slice of its
    :data:`TRUNK_SPECS` parameters (:func:`local_part`) and runs split
    (``ResBlock.tp``). Every rank must hold the same whole weights
    (``parallel.mesh.replicate``)."""
    if mesh.model_group is None:
        raise ValueError("tensor parallelism needs a mesh with a model axis "
                         "over processes: make_mesh(n_model=tp)")
    tp, rank = mesh.model, mesh.model_rank
    with torch.no_grad():
        for block in tower.trunk.blocks:
            if block.tp is not None:
                raise ValueError("the tower is already split")
            _check_block(block, tp)
            for suffix in TRUNK_SPECS:
                p = block.get_parameter(suffix)
                p.data = local_part(suffix, p.data, block.attn.heads, tp,
                                    rank).contiguous().clone()
            block.tp = mesh
    return tower


def split_params(model: nn.Module) -> Dict[str, nn.Module]:
    """{parameter name: its block} of every parameter that a split block
    of ``model`` holds a model rank's slice of."""
    from vitlens_tpu_torch.models.layers import ResBlock

    out = {}
    for name, m in model.named_modules():
        if isinstance(m, ResBlock) and m.tp is not None:
            for suffix in TRUNK_SPECS:
                out[f"{name}.{suffix}" if name else suffix] = m
    return out


def gather_whole(name: str, t: torch.Tensor, block) -> torch.Tensor:
    """The whole, JAX-layout tensor of the split parameter (or moment)
    ``name`` of ``block``, from this rank's slice ``t``: every model rank
    calls it (a collective over the model axis, through c10d)."""
    mesh = block.tp
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.model)]
    dist.all_gather(parts, t, group=mesh.model_group)
    return whole(_suffix(name), parts, block.attn.heads)


def _suffix(name: str) -> str:
    for suffix in TRUNK_SPECS:
        if name == suffix or name.endswith("." + suffix):
            return suffix
    raise KeyError(name)


def split_axis(name: str) -> int:
    """The axis the split parameter ``name`` (a key of
    :func:`split_params`) is cut on."""
    return TRUNK_SPECS[_suffix(name)]


def local_of(name: str, whole_t: torch.Tensor, block) -> torch.Tensor:
    """This model rank's slice of the whole tensor of the split parameter
    (or moment) ``name`` of ``block``."""
    return local_part(_suffix(name), whole_t, block.attn.heads,
                      block.tp.model, block.tp.model_rank)
