"""FSDP: the train state's parameters and AdamW moments stored sharded over
the data axis (port of vitlens_tpu/parallel/fsdp.py), with PyTorch's FSDP2
(``torch.distributed.fsdp.fully_shard``).

JAX jits the step as one global-batch computation over sharded arrays and
lets GSPMD insert the all-gathers and reduce-scatters. The port runs one
process a rank (``parallel.mesh``): :func:`fsdp_place` calls ``fully_shard``
on each block of every ``Transformer``, on each layer of a Perceiver Lens
and on each tower of the model, never on the root, whose own parameter (the
logit scale) stays a plain tensor and whose towers the step calls one by
one. A call of a wrapped module all-gathers its parameters before its
forward and reduce-scatters their gradients (averaged over the ranks) after
its backward; ``train.step`` builds the step of ``partition="fsdp"`` on it.

The rule is JAX's (:func:`fsdp_spec`): shard the largest axis that the
number of ranks divides; tensors under ``min_elems`` and shapes with no such
axis stay whole. A block's parameter is one row of JAX's stacked leaf
([layers, ...]), so the rule is taken on the stacked shape and the port
shards the same axis of the row. Every parameter the rule keeps whole goes
into ``ignored_params``: it stays a plain tensor on every rank and the step
averages its gradient with ``parallel.mesh.average_gradients_``. The AdamW
moments follow their parameters: each becomes a ``DTensor`` of its
parameter's placement, so the update is elementwise on the local shards.
Buffers (the BatchNorm running statistics) stay whole on every rank.

No mixed-precision policy: FSDP2 gathers the stored dtype, as JAX does (fp32
masters, the frozen matmul weights in the compute dtype after
``factory.cast_matmul_weights_``).

JAX turns its fused Pallas kernels off under FSDP (``set_fused_mlp_enabled``
and ``set_point_encoder_enabled``): GSPMD cannot propagate shardings
through an opaque TPU custom call. The port keeps them on. A wrapped
module's kernels take the gathered, unsharded weights; the wrappers refuse a
weight that is not contiguous or not 16-byte aligned, and launch on the
current stream, which FSDP2's stream events order. So the FSDP step
launches exactly the kernels the data-parallel step launches.

Over a ``[data, model]`` mesh FSDP2 shards over the data axis alone (a
``DeviceMesh`` of the mesh's data group), and the ranks of one model column
hold the same shards. The 2D state (:func:`fsdp_tp_place`, JAX's
``fsdp_tp_place``) first splits the named towers' trunks over the model axis
(``parallel.tp``): those slices stay whole over the data axis, ignored by
FSDP2, their gradients averaged over the data group and their AdamW moments
cut alike; everything else is FSDP over the data axis. The TP slices are
plain tensors, not ``DTensor``s over a 2D device mesh: a DTensor
redistribution waits on functional collectives, which crash a gloo group on
CUDA tensors (torch 2.11; :func:`full_tensor`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

from vitlens_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh

MIN_ELEMS = 4096  # below this, replication is cheaper than the collectives


def fsdp_spec(shape: Sequence[int], n: int,
              min_elems: int = MIN_ELEMS) -> Optional[int]:
    """The axis of ``shape`` to shard over ``n`` ranks: the largest one that
    ``n`` divides (the first of equals), or None for a tensor under
    ``min_elems`` elements or with no such axis (JAX's ``fsdp_spec``)."""
    shape = tuple(int(s) for s in shape)
    if not shape or math.prod(shape) < min_elems:
        return None
    best = None
    for i, s in enumerate(shape):
        if s % n == 0 and (best is None or s > shape[best]):
            best = i
    return best


def _stacked(model: nn.Module) -> Dict[str, int]:
    """{module name: layers} of every ``blocks`` ModuleList: JAX stacks its
    blocks' leaves on a leading [layers] axis (``weights.from_jax``)."""
    return {name: len(m) for name, m in model.named_modules()
            if name.split(".")[-1] == "blocks" and isinstance(m, nn.ModuleList)}


def param_axes(model: nn.Module, n: int,
               min_elems: int = MIN_ELEMS) -> Dict[str, Optional[int]]:
    """{parameter name: the axis it shards on, or None}. A parameter of
    ``...blocks.<i>`` takes the rule on its stacked shape ([layers] +
    shape), less the layer axis; where the rule picks the layer axis itself
    (whole layers a rank, which per-block tensors cannot hold) the row's
    largest axis that ``n`` divides."""
    stacks = _stacked(model)
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        layers = None
        for i in range(len(parts) - 2, 0, -1):
            if parts[i].isdigit() and ".".join(parts[:i]) in stacks:
                layers = stacks[".".join(parts[:i])]
                break
        if layers is None:
            out[name] = fsdp_spec(p.shape, n, min_elems)
            continue
        axis = fsdp_spec((layers,) + tuple(p.shape), n, min_elems)
        if axis == 0:
            axis = fsdp_spec(p.shape, n, min_elems=0)
            out[name] = axis
        else:
            out[name] = None if axis is None else axis - 1
    return out


def _units(model: nn.Module) -> List[nn.Module]:
    """The modules ``fully_shard`` wraps, innermost first: each block of every
    Transformer, each layer of a Perceiver Lens, then each tower (a child of
    the root that holds parameters)."""
    from vitlens_tpu_torch.models.layers import Transformer
    from vitlens_tpu_torch.models.perceiver import Perceiver

    inner = []
    for m in model.modules():
        if isinstance(m, Transformer):
            inner.extend(m.blocks)
        elif isinstance(m, Perceiver):
            inner.extend(m.layers)
    towers = [m for m in model.children()
              if any(True for _ in m.parameters())]
    return inner + towers


def fsdp_units(model: nn.Module) -> List[nn.Module]:
    """The modules of ``model`` that :func:`fsdp_place` wrapped (empty when
    the model is not placed)."""
    from torch.distributed.fsdp import FSDPModule

    return [m for m in model.modules() if isinstance(m, FSDPModule)]


def reshard_(model: nn.Module) -> None:
    """Free every wrapped module's gathered parameters and register the
    sharded ones again. FSDP2 keeps a root module's (a tower's) parameters
    gathered after its forward, for the backward; a tower that no backward
    reaches (frozen, or called without autograd) would keep them, and the
    model's ``named_parameters`` would give the gathered ones."""
    for m in fsdp_units(model):
        m.reshard()


def _device_mesh(mesh: Mesh):
    """The FSDP2 device mesh of a :class:`Mesh` that spans processes."""
    from torch.distributed.device_mesh import DeviceMesh

    if not mesh.spans_processes:
        raise ValueError("FSDP runs one process a rank: pass make_mesh() of "
                         "the process group")
    return DeviceMesh.from_group(mesh.group, mesh.device.type)


def fsdp_place(state, mesh: Mesh, *, min_elems: int = MIN_ELEMS):
    """Shard ``state`` (a ``train.step.TrainState`` whose model sits on the
    mesh's device) over ``mesh``'s data axis in place, and return it: the
    parameters the rule shards become ``DTensor``s (``Shard(axis)``), the
    others stay plain and are ignored by FSDP2; each AdamW moment becomes a
    ``DTensor`` of its parameter's placement, its local shard cut from the
    whole moment every rank holds (zeros, or a resumed unsharded state).
    Every rank must hold the same state (``parallel.mesh.replicate``).
    The entry point before the first step of ``partition="fsdp"``."""
    return _fsdp_place(state, mesh, min_elems, keep=())


def _fsdp_place(state, mesh: Mesh, min_elems: int, keep):
    """:func:`fsdp_place`, the parameters named in ``keep`` left as they
    are (ignored by FSDP2)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import DTensor, Shard

    model = state.model
    if fsdp_units(model):
        raise ValueError("the state is already placed")
    if any(getattr(m, "lora", None) is not None for m in model.modules()):
        raise NotImplementedError(
            "LoRA under FSDP is not ported: the merge reads a block's "
            "weights outside its forward")
    dmesh = _device_mesh(mesh)
    axes = param_axes(model, mesh.data, min_elems)
    axes.update(dict.fromkeys(keep))
    params = dict(model.named_parameters())
    by_id = {id(p): axes[n] for n, p in params.items()}
    ignored = {p for n, p in params.items() if axes[n] is None}
    for unit in _units(model):
        fully_shard(unit, mesh=dmesh, ignored_params=ignored,
                    shard_placement_fn=lambda p: Shard(by_id[id(p)]))
    placed = dict(model.named_parameters())
    with torch.no_grad():
        for moment in ("mu", "nu"):
            tree = state.opt_state[moment]
            for name, t in list(tree.items()):
                p, axis = placed[name], shard_axis(placed[name])
                if axis is None:
                    continue
                local = t.chunk(mesh.data, dim=axis)[mesh.rank]
                tree[name] = DTensor.from_local(
                    local.to(p.device).contiguous(), p.device_mesh,
                    p.placements, run_check=False, shape=p.shape,
                    stride=p.stride())
    return state


def placements_of(state) -> Dict[str, Dict[str, Any]]:
    """The counterpart of JAX's ``shardings_of``: ``{"params": {name:
    placement}, "mu": {...}, "nu": {...}}`` of a placed (or unplaced: every
    entry None) state, a placement being ``Shard(axis)`` (FSDP over the data
    axis), ``("model", axis)`` (a TP slice, whole over data) or None. The
    model's wrapped modules must be resharded (:func:`reshard_`; the step
    leaves them so): a gathered module's parameters read as plain
    tensors."""
    from torch.distributed.tensor import Shard

    from vitlens_tpu_torch.parallel.tp import split_axis, split_params

    split = split_params(state.model)

    def of(n, t):
        if n in split:
            return (MODEL_AXIS, split_axis(n))
        axis = shard_axis(t)
        return None if axis is None else Shard(axis)

    out = {"params": {n: of(n, p) for n, p in state.model.named_parameters()}}
    for moment in ("mu", "nu"):
        out[moment] = {n: of(n, t) for n, t in state.opt_state[moment].items()}
    return out


def shard_axis(t: torch.Tensor) -> Optional[int]:
    """The axis a ``DTensor`` is sharded on; None for a plain tensor."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        return None
    (pl,) = t.placements
    return pl.dim if isinstance(pl, Shard) else None


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a ``DTensor`` (the storage itself: in-place
    updates reach the sharded parameter), a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """A sharded ``DTensor`` gathered whole on every rank (a collective: the
    ranks' equal shards all-gathered and concatenated along the sharded
    axis); a plain tensor as it is. Through ``dist.all_gather``, not
    ``DTensor.full_tensor``: the functional collectives that the latter
    waits on crash a gloo group on CUDA tensors (torch 2.11), which the
    c10d ones and FSDP2's own carry."""
    axis = shard_axis(t)
    if axis is None:
        return t
    local = t.to_local().contiguous()
    group = t.device_mesh.get_group()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts, dim=axis)


def sharded_norm(grads: Dict[str, torch.Tensor], mesh: Mesh,
                 split=()) -> torch.Tensor:
    """The global L2 norm of gradients some of which are sharded over the
    data axis (``DTensor``s, each data rank its shard, the same on every
    model rank), some split over the model axis (the names in ``split``,
    each model rank its slice, the same on every data rank) and the others
    replicated: each tensor's sum of squares counted once, on the ranks
    that hold a distinct part of it, all-reduced once over the mesh."""
    sq = None
    for n, g in grads.items():
        if shard_axis(g) is not None:
            if mesh.model_rank:
                continue
            s = g.to_local().float().square().sum()
        elif n in split:
            if mesh.rank:
                continue
            s = g.float().square().sum()
        elif mesh.rank == 0 and mesh.model_rank == 0:
            s = g.float().square().sum()
        else:
            continue
        sq = s if sq is None else sq + s
    if sq is None:
        sq = torch.zeros((), device=mesh.device)
    sq = sq.detach().clone()
    dist.all_reduce(sq)  # the mesh spans the process group
    return sq.sqrt()


def _towers(model: nn.Module, names: Sequence[str]) -> Dict[str, nn.Module]:
    """{module name: module} of every module whose own name (the last
    component) is one of ``names``: the boundary-aware match of JAX's
    suffix rule (``audio_visual`` is not ``visual``)."""
    return {n: m for n, m in model.named_modules()
            if n and n.split(".")[-1] in names and hasattr(m, "trunk")}


def fsdp_tp_shardings(model: nn.Module, mesh: Mesh, *,
                      tp_towers=("visual",), min_elems: int = MIN_ELEMS
                      ) -> Dict[str, Any]:
    """{parameter name: placement} of the 2D state (JAX's
    ``fsdp_tp_shardings``): ``("model", axis)`` for the TP-split trunk
    weights of the ``tp_towers`` (whole over data), else the FSDP rule's
    ``("data", axis)`` over the data axis, or None (whole). Read on an
    unplaced model; the AdamW moments follow their parameters."""
    from vitlens_tpu_torch.parallel.tp import vision_tower_specs

    out = {n: None if a is None else (DATA_AXIS, a)
           for n, a in param_axes(model, mesh.data, min_elems).items()}
    for name, tower in _towers(model, tp_towers).items():
        for n, a in vision_tower_specs(tower).items():
            if a is not None:
                out[f"{name}.{n}"] = (MODEL_AXIS, a)
    return out


def fsdp_tp_place(state, mesh: Mesh, *, tp_towers=("visual",),
                  min_elems: int = MIN_ELEMS):
    """Place ``state`` in the 2D layout of :func:`fsdp_tp_shardings`, in
    place, and return it: the ``tp_towers``' trunks split over the model
    axis (``parallel.tp.shard_vision_tower``; their AdamW moments cut to
    the same slices), then FSDP2 over the data axis for every other
    parameter. Every rank must hold the same state. The entry point before
    the first step of ``partition="fsdp"`` over a model axis."""
    from vitlens_tpu_torch.parallel.tp import (local_of, shard_vision_tower,
                                               split_params)

    if mesh.model_group is None:
        raise ValueError("fsdp_tp_place needs a mesh with a model axis over "
                         "processes: make_mesh(n_model=tp)")
    towers = _towers(state.model, tp_towers)
    if not towers:
        raise ValueError(f"no tower named {tp_towers} to split")
    for tower in towers.values():
        shard_vision_tower(tower, mesh)
    split = split_params(state.model)
    with torch.no_grad():
        for moment in ("mu", "nu"):
            tree = state.opt_state[moment]
            for n in [n for n in tree if n in split]:
                tree[n] = local_of(n, tree[n], split[n]).contiguous().clone()
    return _fsdp_place(state, mesh, min_elems, keep=split)
