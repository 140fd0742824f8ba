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

FSDP over a model axis (``fsdp_tp_shardings``, ``fsdp_tp_place``) waits for
tensor parallelism, ROADMAP Queue 1 item 12c.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

from vitlens_tpu_torch.parallel.mesh import Mesh

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
    if mesh.model != 1:
        raise NotImplementedError("FSDP over a model axis is not yet ported: "
                                  "ROADMAP Queue 1, item 12c")
    return DeviceMesh.from_group(mesh.group, mesh.device.type)


def fsdp_place(state, mesh: Mesh, *, min_elems: int = MIN_ELEMS):
    """Shard ``state`` (a ``train.step.TrainState`` whose model sits on the
    mesh's device) over ``mesh``'s ranks in place, and return it: the
    parameters the rule shards become ``DTensor``s (``Shard(axis)``), the
    others stay plain and are ignored by FSDP2; each AdamW moment becomes a
    ``DTensor`` of its parameter's placement, its local shard cut from the
    whole moment every rank holds (zeros, or a resumed unsharded state).
    Every rank must hold the same state (``parallel.mesh.replicate``).
    The entry point before the first step of ``partition="fsdp"``."""
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
    Shard(axis) or None}, "mu": {...}, "nu": {...}}`` of a placed (or
    unplaced: every entry None) state. The model's wrapped modules must be
    resharded (:func:`reshard_`; the step leaves them so): a gathered
    module's parameters read as plain tensors."""
    from torch.distributed.tensor import Shard

    def of(t):
        axis = shard_axis(t)
        return None if axis is None else Shard(axis)

    out = {"params": {n: of(p) for n, p in state.model.named_parameters()}}
    for moment in ("mu", "nu"):
        out[moment] = {n: of(t) for n, t in state.opt_state[moment].items()}
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


def sharded_norm(grads: Dict[str, torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The global L2 norm of gradients some of which are sharded
    (``DTensor``s, each rank its shard) and the others replicated (the same
    on every rank): the local sums of squares of the shards, plus the
    replicated ones' on rank 0 alone, all-reduced once."""
    sq = None
    for g in grads.values():
        if shard_axis(g) is not None:
            s = g.to_local().float().square().sum()
        elif mesh.rank == 0:
            s = g.float().square().sum()
        else:
            continue
        sq = s if sq is None else sq + s
    if sq is None:
        sq = torch.zeros((), device=mesh.device)
    sq = sq.detach().clone()
    dist.all_reduce(sq, group=mesh.group)
    return sq.sqrt()


def fsdp_tp_shardings(*_a, **_k):
    raise NotImplementedError("FSDP x tensor parallelism is not yet ported: "
                              "ROADMAP Queue 1, item 12c")


fsdp_tp_place = fsdp_tp_shardings
