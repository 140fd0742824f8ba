"""Data-parallel runtime (port of vitlens_tpu/parallel/mesh.py).

JAX's mesh is single-controller: one process drives every local device and
``shard_map`` splits the batch. The port maps it onto PyTorch's idiom in two
ways, both behind one :class:`Mesh`:

- Training runs one process per rank (``torch.distributed``).
  :func:`init_distributed` reads the torchrun or SLURM environment and joins
  the process group (NCCL for a rank on the card, gloo on the CPU);
  ``make_mesh()`` is then that group: ``data`` is the world size, the device
  is this rank's, and each rank feeds its own slice of the global batch.
  The collectives of the losses and BatchNorm are autograd-aware
  (:func:`all_gather`, :func:`all_reduce_mean`), and
  :func:`average_gradients_` all-reduces the trainable gradients in buckets.
- Serving and ``infer`` run one process with a replica of each tower on each
  device of the mesh: ``make_mesh(devices=[...])`` lists them. Rows pad to a
  multiple of ``data``, split into contiguous chunks, one a device, and the
  results gather on the first device (``api.ViTLens(mesh=)``).

A process group may also carry a ``model`` axis: ``make_mesh(n_data,
n_model)`` lays the ranks out as JAX reshapes its devices, ``[n_data,
n_model]`` with ``model`` innermost, so rank r is data row r // n_model and
model column r % n_model. Every collective of the data axis (the losses'
gathers, synced BatchNorm, the gradient average, the loader's and the
eval's slices) runs over the ranks of one model column, ``Mesh.group``; the
ranks of one data row see the same rows and share the model axis,
``Mesh.model_group``, over which tensor and sequence parallelism
(``parallel.tp``, ``parallel.sp``) split a tower. FSDP (the train state
sharded over the data axis) is ``parallel.fsdp``. ``make_pipe_mesh(n_stages,
n_data)`` lays the ranks out ``[n_data, n_stages]`` with a ``pipe`` axis
innermost instead (JAX's ``parallel/pp.py::make_pipe_mesh``): the ranks of
one data row are the stages of one pipeline (``Mesh.pipe_group``), over
which ``parallel.pp`` runs a trunk's blocks stage by stage.
"""

from __future__ import annotations

import datetime
import os
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
DEFAULT_PORT = 29500   # torchrun's
DEFAULT_TIMEOUT_S = 600.0
BUCKET_ELEMS = 1 << 24  # fp32 elements of one gradient all-reduce (64 MB)


# ---------------------------------------------------------------------------
# process bootstrap
# ---------------------------------------------------------------------------


def slurm_first_host(nodelist: str) -> str:
    """The first host of a SLURM compressed node list, the rank-0 node that
    JAX's SlurmCluster plugin takes as coordinator: ``node[03-06,09]`` ->
    ``node03``, ``a1,b2`` -> ``a1``, ``gpu-[7,9]-x`` -> ``gpu-7-x``."""
    nodelist = nodelist.strip()
    if not nodelist:
        raise ValueError("empty SLURM node list")
    depth, end = 0, len(nodelist)
    for i, c in enumerate(nodelist):  # the first entry: up to a top-level ","
        depth += (c == "[") - (c == "]")
        if c == "," and depth == 0:
            end = i
            break
    first = nodelist[:end]
    m = re.match(r"^(.*?)\[([^\]]*)\](.*)$", first)
    if m is None:
        return first
    prefix, ranges, rest = m.groups()
    lo = ranges.split(",")[0].split("-")[0]
    return slurm_first_host(prefix + lo + rest) if "[" in rest else prefix + lo + rest


class DistEnv(NamedTuple):
    """What the environment says of this process's place in a run."""
    address: str      # host:port of rank 0's store
    world_size: int
    rank: int
    local_rank: int


def distributed_env(env: Optional[Mapping[str, str]] = None) -> Optional[DistEnv]:
    """The run the environment describes, or None for one process (the
    discovery order of JAX's ``init_distributed``):

    - torchrun-style ``WORLD_SIZE`` > 1 with ``RANK`` and ``MASTER_ADDR``
      (``MASTER_PORT``, default 29500) or ``COORDINATOR_ADDRESS``
      (host:port); the local device index from ``LOCAL_RANK``;
    - SLURM's ``SLURM_NTASKS`` > 1 with ``SLURM_PROCID`` and
      ``SLURM_LOCALID``; the address from ``COORDINATOR_ADDRESS`` or
      ``MASTER_ADDR``, else the first host of ``SLURM_STEP_NODELIST`` (or
      ``SLURM_JOB_NODELIST``) at ``MASTER_PORT``.

    ``WORLD_SIZE`` > 1 with no address or no ``RANK`` raises: N independent
    single-process jobs would duplicate the data and clobber each other's
    checkpoints."""
    env = os.environ if env is None else env
    addr = env.get("COORDINATOR_ADDRESS") or None
    port = env.get("MASTER_PORT") or str(DEFAULT_PORT)
    if env.get("WORLD_SIZE", "1") not in ("", "1"):
        if not (addr or env.get("MASTER_ADDR")):
            raise RuntimeError(
                f"WORLD_SIZE={env['WORLD_SIZE']} but neither MASTER_ADDR nor "
                "COORDINATOR_ADDRESS is set: cannot join the process group")
        if "RANK" not in env:
            raise RuntimeError(
                f"WORLD_SIZE={env['WORLD_SIZE']} but RANK is not set: every "
                "process needs its torchrun-style rank")
        return DistEnv(addr or f"{env['MASTER_ADDR']}:{port}",
                       int(env["WORLD_SIZE"]), int(env["RANK"]),
                       int(env.get("LOCAL_RANK", "0")))
    if env.get("SLURM_NTASKS", "1") not in ("", "1"):
        if not addr and env.get("MASTER_ADDR"):
            addr = f"{env['MASTER_ADDR']}:{port}"
        if not addr:
            nodes = env.get("SLURM_STEP_NODELIST") or env.get("SLURM_JOB_NODELIST")
            if not nodes:
                raise RuntimeError(
                    f"SLURM_NTASKS={env['SLURM_NTASKS']} but no "
                    "COORDINATOR_ADDRESS, MASTER_ADDR or SLURM_STEP_NODELIST "
                    "names rank 0's host: export COORDINATOR_ADDRESS "
                    "(host:port of rank 0) in the sbatch script")
            addr = f"{slurm_first_host(nodes)}:{port}"
        return DistEnv(addr, int(env["SLURM_NTASKS"]), int(env["SLURM_PROCID"]),
                       int(env.get("SLURM_LOCALID", "0")))
    return None


def rank_device(local_rank: int, device=None) -> torch.device:
    """This rank's device: ``cuda:<local_rank>`` unless ``device`` names the
    CPU (or another device). A local index past the visible cards raises."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for this rank; pass device='cpu' "
                           "to train on the host")
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(
            f"local rank {local_rank} has no device: {torch.cuda.device_count()} "
            "CUDA device(s) visible")
    return torch.device("cuda", local_rank)


def init_distributed(device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Join the process group the environment describes
    (:func:`distributed_env`) and return this process's rank: NCCL when the
    rank's device (:func:`rank_device`) is CUDA, gloo on the CPU; a CUDA
    rank's device becomes the current one. A no-op returning the rank when
    a group is already initialised (the caller set it up), and returning 0
    for one process."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    de = distributed_env()
    if de is None:
        return 0
    dev = rank_device(de.local_rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{de.address}", world_size=de.world_size,
        rank=de.rank, timeout=datetime.timedelta(seconds=timeout_s))
    return de.rank


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return (dist.get_world_size() if dist.is_available() and dist.is_initialized()
            else 1)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Mesh:
    """A ``data`` axis of ``data`` replicas by a ``model`` axis of ``model``
    ranks.

    A mesh that spans processes (``group`` set, from :func:`make_mesh` after
    :func:`init_distributed`) is one process a rank: ``rank`` is this
    process's index on the data axis and ``group`` the ranks of its model
    column (the data axis's collectives), ``model_rank`` its index on the
    model axis and ``model_group`` the ranks of its data row (None while
    ``model`` is 1); ``devices`` holds its one device. A local mesh
    (``group`` None) lists every device of the data axis in this process; a
    device may repeat, and then its replicas share that device. A pipe mesh
    (:func:`make_pipe_mesh`) has ``pipe`` stages in place of the model
    axis: ``stage`` is this rank's and ``pipe_group`` the ranks of its data
    row, one a stage."""
    devices: Tuple[torch.device, ...]
    data: int
    rank: int = 0
    group: Any = None
    model: int = 1
    model_rank: int = 0
    model_group: Any = None
    pipe: int = 1
    stage: int = 0
    pipe_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        shape = {DATA_AXIS: self.data, MODEL_AXIS: self.model}
        if self.pipe > 1:
            shape[PIPE_AXIS] = self.pipe
        return shape

    @property
    def device(self) -> torch.device:
        """This rank's device (the first device of a local mesh)."""
        return self.devices[0]

    @property
    def spans_processes(self) -> bool:
        return self.group is not None

    @property
    def backend(self) -> Optional[str]:
        return dist.get_backend(self.group) if self.group is not None else None


# {(world size, n_model): (one group a model column, one a data row)}: c10d
# subgroups are made collectively, so each layout's are made once (a pipe
# mesh's stages are laid out as a model axis's ranks and share its groups)
_AXIS_GROUPS: Dict[Tuple[int, int], Tuple[list, list]] = {}


def _axis_groups(world: int, n_model: int) -> Tuple[list, list]:
    """The subgroups of a ``[world / n_model, n_model]`` layout: for each
    model column m the ranks m, m + n_model, ... (a data axis), for each
    data row d the ranks d * n_model ... (d + 1) * n_model - 1 (a model
    axis). Every rank creates every group, in this order."""
    key = (world, n_model)
    if key not in _AXIS_GROUPS:
        n_data = world // n_model
        columns = [dist.new_group([m + i * n_model for i in range(n_data)])
                   for m in range(n_model)]
        rows = [dist.new_group(list(range(d * n_model, (d + 1) * n_model)))
                for d in range(n_data)]
        _AXIS_GROUPS[key] = (columns, rows)
    return _AXIS_GROUPS[key]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence[Any]] = None, device=None) -> Mesh:
    """The ``[data, model]`` mesh. With ``devices`` (e.g. ``["cuda:0",
    "cuda:1"]``, or ``["cpu", "cpu"]``): a local mesh over the first
    ``n_data`` of them (no model axis: it needs one process a rank).
    Without, in an initialised process group: the group, one rank a process,
    laid out ``[world / n_model, n_model]`` with the model axis innermost
    (``n_data``, when given, must be that quotient), on ``device`` (by
    default the current CUDA device under NCCL, the CPU otherwise; ``cuda``
    without an index is the current one). Without either: a local mesh over
    the visible CUDA devices."""
    if n_model < 1:
        raise ValueError(f"n_model={n_model}")
    if devices is None and dist.is_available() and dist.is_initialized():
        world, rank = _group_layout(n_data, n_model, "model")
        dev = _group_device(device)
        if n_model == 1:
            return Mesh(devices=(dev,), data=world, rank=rank,
                        group=dist.group.WORLD)
        columns, rows = _axis_groups(world, n_model)
        return Mesh(devices=(dev,), data=world // n_model,
                    rank=rank // n_model, group=columns[rank % n_model],
                    model=n_model, model_rank=rank % n_model,
                    model_group=rows[rank // n_model])
    if n_model != 1:
        raise ValueError("a model axis needs one process a rank: "
                         "make_mesh() after init_distributed")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the mesh; pass devices="
                               "['cpu', ...] for the host")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices) if n_data is None else n_data
    if not 1 <= n <= len(devices):
        raise ValueError(f"n_data={n_data} with {len(devices)} devices")
    for d in devices[:n]:
        if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
            raise RuntimeError(f"{d}: {torch.cuda.device_count()} CUDA "
                               "device(s) visible")
    return Mesh(devices=tuple(devices[:n]), data=n)


def _group_layout(n_data: Optional[int], inner: int, axis: str) -> Tuple[int, int]:
    """(world size, rank) of the process group, checked to lay out as
    ``[n_data, inner]``."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % inner:
        raise ValueError(f"n_{axis}={inner} does not divide the {world} "
                         "ranks of the process group")
    if n_data not in (None, world // inner):
        raise ValueError(f"n_data={n_data} but the process group has {world} "
                         f"ranks: one rank a replica of {inner} {axis} "
                         "rank(s)")
    return world, rank


def _group_device(device) -> torch.device:
    """This rank's device: ``device``, by default the current CUDA device
    under NCCL and the CPU otherwise (``cuda`` without an index is the
    current one)."""
    dev = torch.device(device if device is not None else
                       "cuda" if dist.get_backend() == "nccl" else "cpu")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_pipe_mesh(n_stages: int, n_data: int = 1, device=None) -> Mesh:
    """The ``[data, pipe]`` mesh over the initialised process group, the pipe
    axis innermost as in JAX's ``make_pipe_mesh``: rank r is data row
    r // n_stages and stage r % n_stages. The data axis's collectives run
    over the ranks of one stage (``group``), the pipeline's over the stages
    of one data row (``pipe_group``); ``n_data * n_stages`` must be the
    world size. ``device`` as :func:`make_mesh`'s."""
    if n_stages < 1:
        raise ValueError(f"n_stages={n_stages}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a pipe mesh needs one process a rank: "
                           "make_pipe_mesh() after init_distributed")
    world, rank = _group_layout(n_data, n_stages, "stages")
    columns, rows = _axis_groups(world, n_stages)
    return Mesh(devices=(_group_device(device),), data=world // n_stages,
                rank=rank // n_stages, group=columns[rank % n_stages],
                pipe=n_stages, stage=rank % n_stages,
                pipe_group=rows[rank // n_stages])


def data_axis(axis) -> Optional[Mesh]:
    """The mesh a loss or BatchNorm reduces over: None (one device), a
    :class:`Mesh`, or the axis name ``"data"``, which is the process group
    (as JAX's name is bound by ``shard_map``; unbound, it raises)."""
    if axis is None or isinstance(axis, Mesh):
        return axis
    if axis == DATA_AXIS:
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "axis 'data' is unbound: no process group is initialised "
                "(init_distributed, or pass the Mesh itself)")
        return make_mesh()
    raise TypeError(f"not a data axis: {axis!r}")


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _local(mesh: Mesh) -> bool:
    """True where a collective over ``mesh`` is the identity: a local mesh
    of one device. A mesh that spans processes runs its collectives even
    at world size 1; a local mesh of several devices has none."""
    if mesh.group is not None:
        return False
    if mesh.data == 1:
        return True
    raise ValueError("a collective needs a mesh that spans processes "
                     "(make_mesh() after init_distributed), one rank a "
                     "process; a local mesh of several devices only serves")


class _AllGather(torch.autograd.Function):
    """Rows of every rank, in rank order; the backward sums the cotangents
    of every rank and keeps this rank's rows (JAX: ``all_gather``, whose
    transpose is ``psum_scatter``)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.data)]
        dist.all_gather(parts, x, group=mesh.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = g.contiguous()
        b = g.shape[0] // mesh.data
        if mesh.backend == "nccl":
            out = g.new_empty((b,) + tuple(g.shape[1:]))
            dist.reduce_scatter(out, list(g.chunk(mesh.data)), group=mesh.group)
            return out, None
        g = g.clone()
        dist.all_reduce(g, group=mesh.group)
        return g[mesh.rank * b:(mesh.rank + 1) * b], None


class _AllReduceMean(torch.autograd.Function):
    """The mean over ranks; the backward is the mean of the cotangents, as
    ``lax.pmean``'s is."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        y = x.detach().clone().contiguous()
        dist.all_reduce(y, group=mesh.group)
        return y / mesh.data

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = g.detach().clone().contiguous()
        dist.all_reduce(g, group=mesh.group)
        return g / mesh.data, None


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[B, ...] on each rank -> [data * B, ...], differentiable."""
    if _local(mesh):
        return x
    return _AllGather.apply(x, mesh)


def all_reduce_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of ``x`` over ranks, differentiable."""
    if _local(mesh):
        return x
    return _AllReduceMean.apply(x, mesh)


# -- the model axis: Megatron's operators and the sequence's ---------------------
#
# Every tensor these take is replicated over the model axis or split along
# ``dim`` into equal parts, part r on model rank r; the computation after
# each is the same on every model rank (the ranks of a data row compute one
# loss), so an operator's backward is the transpose of its forward under
# that view. Reduce-scatter is NCCL's where the group runs NCCL; gloo has
# none, and there it is an all-reduce and a slice. Megatron's f and g
# (:class:`_AxisCopy`, :class:`_AxisSum`) take the group of their axis: the
# model axis's here, the pipe axis's in ``parallel.pp``.


def _group_sum_(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, group=group)
    return t


def _model_cat(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.model)]
    dist.all_gather(parts, x, group=mesh.model_group)
    return torch.cat(parts, dim)


def _model_part(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    n = x.shape[dim] // mesh.model
    return x.narrow(dim, mesh.model_rank * n, n)


def _model_reduce_scatter(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    if dist.get_backend(mesh.model_group) == "nccl":
        parts = [c.contiguous() for c in x.chunk(mesh.model, dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=mesh.model_group)
        return out
    return _model_part(_group_sum_(x.contiguous().clone(), mesh.model_group),
                       mesh, dim).contiguous()


class _AxisCopy(torch.autograd.Function):
    """Megatron's f over the ranks of ``group``: the identity, whose backward
    sums the ranks' partial cotangents (in front of a column-parallel
    product, on a replicated parameter that each model rank uses on its
    part of the rows, and on a pipelined trunk's input, which the first
    stage alone reads)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _group_sum_(g.contiguous().clone(), ctx.group), None


class _AxisSum(torch.autograd.Function):
    """Megatron's g over the ranks of ``group``: the sum of the ranks'
    partial results (after a row-parallel product; a pipeline's banked
    output, zeros on all but the last stage); the backward is the
    identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _group_sum_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ModelGather(torch.autograd.Function):
    """The parts of every model rank, concatenated along ``dim``; each rank
    computes something else from the whole, so the backward sums the ranks'
    cotangents and keeps this rank's part (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _model_cat(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _model_reduce_scatter(g, ctx.mesh, ctx.dim), None, None


class _ModelReduceScatter(torch.autograd.Function):
    """The sum of the model ranks' partial products, this rank's part along
    ``dim`` (Megatron-SP's reduce-scatter after a row-parallel product);
    the backward all-gathers the parts' cotangents."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _model_reduce_scatter(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _model_cat(g, ctx.mesh, ctx.dim), None, None


class _ModelSplit(torch.autograd.Function):
    """This rank's part of a replicated tensor along ``dim``; the backward
    all-gathers the parts' cotangents."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _model_part(x, mesh, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return _model_cat(g, ctx.mesh, ctx.dim), None, None


class _ModelUnsplit(torch.autograd.Function):
    """The parts of every model rank, concatenated along ``dim``, where what
    follows is replicated: the backward keeps this rank's part of the
    (equal) cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _model_cat(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _model_part(g, ctx.mesh, ctx.dim).contiguous(), None, None


def axis_copy(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f over the ranks of ``group`` (:class:`_AxisCopy`); ``x``
    itself where no gradient is recorded for it."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _AxisCopy.apply(x, group)


def axis_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g over the ranks of ``group`` (:class:`_AxisSum`)."""
    return _AxisSum.apply(x, group)


def model_copy(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Megatron's f over ``mesh``'s model axis."""
    return axis_copy(x, mesh.model_group)


def model_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Megatron's g over ``mesh``'s model axis."""
    return axis_sum(x, mesh.model_group)


def model_gather(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """Every model rank's part along ``dim`` (:class:`_ModelGather`)."""
    return _ModelGather.apply(x, mesh, dim)


def model_reduce_scatter(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The model ranks' sum, this rank's part along ``dim``
    (:class:`_ModelReduceScatter`)."""
    return _ModelReduceScatter.apply(x, mesh, dim)


def model_split(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """This model rank's part of a replicated ``x`` (:class:`_ModelSplit`)."""
    return _ModelSplit.apply(x, mesh, dim)


def model_unsplit(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The model ranks' parts, whole, before replicated work
    (:class:`_ModelUnsplit`)."""
    return _ModelUnsplit.apply(x, mesh, dim)


def average_gradients_(grads: Dict[str, torch.Tensor],
                       mesh: Mesh) -> Dict[str, torch.Tensor]:
    """All-reduce-mean the gradients in place, packed into flat fp32 buckets
    of at most ``BUCKET_ELEMS`` elements (a gradient larger than that goes on
    its own, unpacked): a few collectives a step, and never a second copy
    of every gradient."""
    if _local(mesh):
        return grads
    bucket: List[torch.Tensor] = []

    def flush():
        if not bucket:
            return
        if len(bucket) == 1 and bucket[0].dtype == torch.float32 \
                and bucket[0].is_contiguous():
            dist.all_reduce(bucket[0], group=mesh.group)
            bucket[0].div_(mesh.data)
        else:
            flat = torch.cat([g.reshape(-1).float() for g in bucket])
            dist.all_reduce(flat, group=mesh.group)
            flat.div_(mesh.data)
            o = 0
            for g in bucket:
                g.copy_(flat[o:o + g.numel()].view_as(g))
                o += g.numel()
        bucket.clear()

    size = 0
    for g in grads.values():
        if bucket and size + g.numel() > BUCKET_ELEMS:
            flush()
            size = 0
        bucket.append(g)
        size += g.numel()
    flush()
    return grads


def mean_over_ranks(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The mean of a metric over ranks, without autograd."""
    if mesh is None or _local(mesh):
        return x
    y = x.detach().float().clone()
    dist.all_reduce(y, group=mesh.group)
    return y / mesh.data


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def shard_batch(mesh: Mesh, batch):
    """This rank's slice of the global batch on its device (the loader
    already split the data by rank): a dict of arrays or tensors. A local
    mesh of one device takes the whole batch; a local mesh of several splits
    rows with :func:`split_rows`."""
    if mesh.spans_processes or mesh.data == 1:
        return {k: torch.as_tensor(v).to(mesh.device) for k, v in batch.items()}
    raise ValueError("a local mesh of several devices splits rows with "
                     "split_rows; a train batch needs a mesh that spans "
                     "processes")


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with zero rows appended up to a multiple of ``n`` rows."""
    pad = (-x.shape[0]) % n
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def split_rows(mesh: Mesh, x: torch.Tensor) -> Tuple[List[torch.Tensor], int]:
    """(chunks, rows) on a local mesh: ``x`` padded with zero rows to a
    multiple of ``data`` and cut into ``data`` contiguous chunks, chunk i on
    the mesh's i-th device."""
    chunks = _pad_rows(x, mesh.data).chunk(mesh.data)
    return [c.to(d) for c, d in zip(chunks, mesh.devices)], x.shape[0]


def map_rank_rows(mesh: Optional[Mesh], fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` (rows in, rows out) over the ranks of a mesh that spans
    processes, each rank holding the same ``x``: padded as
    :func:`split_rows` pads, this rank's contiguous chunk through ``fn``,
    the outputs (fp32) gathered on every rank and trimmed to ``x``'s rows.
    Without a mesh, ``fn(x)``."""
    if mesh is None:
        return fn(x)
    b = -(-x.shape[0] // mesh.data)
    mine = _pad_rows(x, mesh.data)[mesh.rank * b:(mesh.rank + 1) * b]
    return all_gather(fn(mine).float(), mesh)[:x.shape[0]]


def replicate(mesh: Mesh, tree):
    """Make ``tree`` (a tensor, a dict or list of them, or a module) equal
    on every rank of the mesh, both axes: broadcast from rank 0, in place,
    and return it. A local mesh's replicas are ``api.ViTLens``'s (one a
    device)."""
    if _local(mesh):
        return tree
    group = (mesh.group if mesh.model == 1 and mesh.pipe == 1
             else dist.group.WORLD)
    with torch.no_grad():
        for t in _tensors(tree):
            dist.broadcast(t.data if isinstance(t, torch.nn.Parameter) else t,
                           src=0, group=group)
    return tree


def _tensors(tree):
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def local_batch_size(mesh: Mesh, global_batch: int) -> int:
    n = mesh.shape[DATA_AXIS]
    assert global_batch % n == 0, (global_batch, n)
    return global_batch // n


def broadcast_object(obj, root: int = 0):
    """A picklable object from the ``root`` process to every process (the
    reference's broadcast_object: e.g. the run name). One process:
    identity."""
    if process_count() == 1:
        return obj
    box = [obj if process_index() == root else None]
    dist.broadcast_object_list(box, src=root)
    return box[0]


def all_gather_object(obj) -> list:
    """Every process's picklable object, in rank order. One process:
    ``[obj]``."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()
