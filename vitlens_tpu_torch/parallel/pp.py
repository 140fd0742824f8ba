"""Pipeline parallelism of a trunk's blocks, the GPipe schedule (port of
vitlens_tpu/parallel/pp.py).

JAX runs one SPMD program on every stage of a ``pipe`` mesh axis: each
stage holds L / S of the stacked layers, M microbatches stream through the
S stages in M + S - 1 ticks, activations hop stage to stage by ``ppermute``
and a closing ``psum`` gives every stage the last stage's banked outputs;
``jax.grad`` transposes it all. The port runs one process a rank on a
``[data, pipe]`` mesh of c10d subgroups (``parallel.mesh.make_pipe_mesh``):

- Stage s runs the trunk blocks ``first + s (L - first) / S`` to ``first +
  (s + 1) (L - first) / S`` (:func:`stage_blocks`; ``first`` is the
  trunk's ``skip_first_n``): ownership follows the blocks that run, not the
  L stored. :func:`pipeline_place` keeps only those on the rank; blocks
  keep their absolute index, which LoRA's per-block merge reads.
- :func:`pipeline_transformer` splits this data rank's rows into M
  microbatches; stage s runs microbatch j at tick s + j and computes only
  the ticks that carry one (JAX computes the bubble on zeros and drops it).
  After each tick the stages hop (:class:`_PipeHop`, JAX's ``ppermute``):
  a stage's output goes to the next stage, the previous one's arrives. The
  last stage banks ``tail_fn`` of each output; the bank is summed over the
  pipe (``parallel.mesh.axis_sum``, Megatron's g: JAX's closing ``psum``,
  zeros from the other stages), so every stage returns it. The input goes
  through ``axis_copy`` (Megatron's f), whose backward sums its cotangent
  over the stages: only stage 0 reads it (JAX: the transpose of the
  replicated ``in_spec``).
- The backward. Autograd runs a Function's backward only where its output
  reaches the loss: a hop that only sends (all of stage 0's) or f on a
  stage > 0 would never run, and the ranks waiting on them would hang. A
  0-d token, zero in value, threads every hop of a rank in tick order, is
  tied to f's output (:class:`_Tie`) and added to the bank before g: every
  rank then runs its hops' backward in reverse tick order and f's after
  them, the same collectives in the same order on every stage. Whether
  the pipeline records a graph at all is agreed over the pipe (one flag
  all-reduced), so that a stage whose blocks are frozen still answers its
  neighbours.
- A hop's route is fixed by the pipe group's backend: NCCL sends and
  receives the tensors themselves; gloo's ``send``/``recv`` read host
  memory only (on a CUDA tensor its TCP transport fails with ``writev:
  Bad address``; ``tools/dp_first_call.py --pp`` probes it), so on gloo a
  hop is staged through host copies, a no-op for CPU tensors. Each hop
  posts its send and its receive before it waits on either.

As in JAX, nothing composes the pipe with tensor or sequence parallelism or
FSDP: :func:`pipeline_place` refuses a TP-split or FSDP-placed tower, and a
pipelined trunk takes precedence over the SP hook. Two pipelined trunks in
one backward are ordered by their data flow (a transformer Lens feeds its
trunk); two trained towers' trunks, whose backward passes autograd may
interleave otherwise on each stage, are not pipelined in one graph.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from vitlens_tpu_torch.models.layers import (Transformer, remat_policy,
                                             run_block, set_trunk_pipeline)
from vitlens_tpu_torch.parallel.fsdp import fsdp_units
from vitlens_tpu_torch.parallel.mesh import (PIPE_AXIS, Mesh, axis_copy,  # noqa: F401
                                             axis_sum, make_pipe_mesh)


def stage_blocks(layers: int, first: int, n_stages: int, stage: int) -> range:
    """The absolute indices of the trunk blocks ``stage`` runs, of a trunk
    of ``layers`` blocks whose first ``first`` are skipped; the depth
    that runs must divide the stages (JAX asserts the same)."""
    if (layers - first) % n_stages:
        raise ValueError(f"trunk depth {layers - first} (of {layers}, "
                         f"{first} skipped) is not divisible by {n_stages} "
                         "pipeline stages")
    per = (layers - first) // n_stages
    return range(first + stage * per, first + (stage + 1) * per)


class OtherStage(nn.Module):
    """Stands in for trunk block ``index`` on a rank that does not run it
    (another stage's, or one that ``skip_first_n`` skips); holds nothing."""

    def __init__(self, index: int):
        super().__init__()
        self.index = index

    def forward(self, *args, **kwargs):
        raise RuntimeError(
            f"trunk block {self.index} is not on this rank (pipeline_place): "
            "run the trunk inside pipelined_trunks on the mesh it was placed "
            "for")


def _check_pipe(mesh: Mesh) -> None:
    if mesh.pipe_group is None:
        raise ValueError("pipelining needs a pipe mesh over processes: "
                         "make_pipe_mesh(n_stages, n_data)")


def shard_trunk_pipeline(trunk: nn.Module, mesh: Mesh,
                         skip_first_n: Optional[int] = None) -> nn.Module:
    """Keep in ``trunk`` (a ``models.layers.Transformer``) only the blocks
    this rank's stage runs (:func:`stage_blocks`), each other block an
    :class:`OtherStage`, in place; return it. The depth after
    ``skip_first_n`` must divide the stages."""
    _check_pipe(mesh)
    layers = len(trunk.blocks)
    keep = stage_blocks(layers, skip_first_n or 0, mesh.pipe, mesh.stage)
    for i in range(layers):
        if i not in keep and not isinstance(trunk.blocks[i], OtherStage):
            trunk.blocks[i] = OtherStage(i)
    return trunk


def pipeline_place(tower: nn.Module, mesh: Mesh) -> nn.Module:
    """Place a tower for pipelining, in place, and return it: its trunk
    keeps the blocks of this rank's stage (:func:`shard_trunk_pipeline`)
    where its depth after the tower config's ``skip_first_n_layers``
    divides the stages, and stays whole otherwise;
    everything else stays whole; all on the mesh's device. A tower split
    by tensor parallelism or placed by FSDP is refused (JAX wires neither
    with the pipe)."""
    _check_pipe(mesh)
    if any(getattr(m, "tp", None) is not None for m in tower.modules()):
        raise ValueError("a tower split over a model axis is not pipelined")
    if fsdp_units(tower):
        raise ValueError("an FSDP-placed tower is not pipelined")
    first = getattr(getattr(tower, "cfg", None), "skip_first_n_layers", None) or 0
    trunk = getattr(tower, "trunk", None)
    if (isinstance(trunk, Transformer)
            and (len(trunk.blocks) - first) % mesh.pipe == 0):
        shard_trunk_pipeline(trunk, mesh, first)
    return tower.to(mesh.device)


class _Hop:
    """One tick's exchange on this rank: the global ranks it sends to and
    receives from (None where it does neither) and the received tensor's
    shape, dtype and device. ``staged``: the gloo route, through host
    copies."""

    def __init__(self, mesh: Mesh, send: bool, recv: bool, like: torch.Tensor):
        group = mesh.pipe_group
        self.group = group
        self.staged = dist.get_backend(group) != "nccl"
        self.next = dist.get_global_rank(group, mesh.stage + 1) if send else None
        self.prev = dist.get_global_rank(group, mesh.stage - 1) if recv else None
        self.shape, self.dtype, self.device = like.shape, like.dtype, like.device

    def exchange(self, send: Optional[torch.Tensor], dst: Optional[int],
                 src: Optional[int]) -> Optional[torch.Tensor]:
        """Send ``send`` to ``dst`` and receive from ``src``, both posted
        before either is waited on; the received tensor, or None."""
        works, got, host = [], None, None
        if dst is not None:
            t = send.detach().contiguous()
            if self.staged:
                t = t.cpu()
            works.append(dist.isend(t, dst, group=self.group))
        if src is not None:
            got = torch.empty(self.shape, dtype=self.dtype, device=self.device)
            host = (got if not self.staged or got.is_cpu else
                    torch.empty(self.shape, dtype=self.dtype))
            works.append(dist.irecv(host, src, group=self.group))
        for w in works:
            w.wait()
        if host is not None and host is not got:
            got.copy_(host)
        return got


class _PipeHop(torch.autograd.Function):
    """JAX's ``ppermute([(i, i + 1) for i in range(S - 1)])`` for one tick
    on this rank: ``out`` (None where the stage sends nothing) goes to the
    next stage and the previous stage's output arrives (zeros where nothing
    arrives, as on stage 0); ``token`` passes through. The backward is the
    reverse hop: the arrival's cotangent goes back to the previous stage,
    and the next stage's cotangent of ``out`` arrives."""

    @staticmethod
    def forward(ctx, out, token, hop: _Hop):
        ctx.hop = hop
        got = hop.exchange(out, hop.next, hop.prev)
        if got is None:
            got = torch.zeros(hop.shape, dtype=hop.dtype, device=hop.device)
        return got, token.view_as(token)

    @staticmethod
    def backward(ctx, g, g_token):
        hop = ctx.hop
        return hop.exchange(g, hop.prev, hop.next), g_token, None


class _Tie(torch.autograd.Function):
    """``token``, made to depend on ``anchor``: the backward gives
    ``anchor`` no cotangent but runs, and so lets the node that made
    ``anchor`` run, once the token's cotangent is back."""

    @staticmethod
    def forward(ctx, anchor, token):
        return token.view_as(token)

    @staticmethod
    def backward(ctx, g):
        return None, g


def _pipe_any(flag: bool, mesh: Mesh) -> bool:
    t = torch.tensor([int(flag)], dtype=torch.int32, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.pipe_group)
    return bool(t.item())


def pipeline_transformer(x: torch.Tensor, trunk: nn.Module,
                         mask: Optional[torch.Tensor] = None, *, mesh: Mesh,
                         n_microbatches: int, remat=False,
                         tail_fn: Optional[Callable] = None,
                         skip_first_n: Optional[int] = None,
                         lora=None) -> torch.Tensor:
    """``trunk(x, mask, skip_first_n, remat, lora)`` (a
    ``models.layers.Transformer``) over ``mesh``'s pipe axis, GPipe's
    schedule. ``x``: this data rank's rows [B, ...], the same on every stage
    of its pipe; B must divide into ``n_microbatches``. Each stage runs its
    blocks (:func:`stage_blocks`; placed or whole); ``remat`` recomputes
    each block in the backward pass (any setting means full remat, as
    JAX's ``bool(remat)``). ``tail_fn`` maps each microbatch's output on the
    last stage before banking ([mb, N, D] -> [mb, ...], JAX's memory
    relief). Returns ``tail_fn(trunk(x))`` (or ``trunk(x)``) per microbatch,
    the same on every stage."""
    _check_pipe(mesh)
    S, s, M = mesh.pipe, mesh.stage, n_microbatches
    if M < 1 or x.shape[0] % M:
        raise ValueError(f"batch {x.shape[0]} not divisible by {M} microbatches")
    mb = x.shape[0] // M
    mine = [(i, trunk.blocks[i])
            for i in stage_blocks(len(trunk.blocks), skip_first_n or 0, S, s)]
    policy = "full" if remat_policy(remat) is not None else None
    grad = torch.is_grad_enabled() and _pipe_any(
        x.requires_grad or any(p.requires_grad for _, b in mine
                               for p in b.parameters()), mesh)
    with torch.set_grad_enabled(grad):
        xf = axis_copy(x, mesh.pipe_group)                      # f
        token = torch.zeros((), dtype=x.dtype, device=x.device,
                            requires_grad=grad)
        if xf.requires_grad:
            token = _Tie.apply(xf, token)
        feed, like = xf.split(mb), x[:mb]
        recv, bank = None, []
        for t in range(M + S - 1):
            out = None
            if 0 <= t - s < M:
                h = feed[t - s] if s == 0 else recv
                for i, block in mine:
                    h = run_block(block, i, h, mask, policy, lora)
                out = h
                if s == S - 1:
                    bank.append(tail_fn(out) if tail_fn is not None else out)
            sends = out is not None and s < S - 1
            recvs = s > 0 and 0 <= t - s + 1 < M
            if sends or recvs:
                recv, token = _PipeHop.apply(out if sends else None, token,
                                             _Hop(mesh, sends, recvs, like))
        if s == S - 1:
            bank = torch.cat(bank)
        else:  # zeros of what the last stage banks (JAX: eval_shape)
            if tail_fn is not None:
                with torch.no_grad():
                    like = tail_fn(torch.zeros_like(like))
            bank = like.new_zeros((x.shape[0],) + tuple(like.shape[1:]))
        if grad:
            bank = bank + token.to(bank.dtype)
        return axis_sum(bank, mesh.pipe_group)                  # g


@contextmanager
def pipelined_trunks(mesh: Mesh, n_microbatches: int):
    """Every ``models.layers.Transformer`` run inside whose depth after
    ``skip_first_n`` divides the pipe's stages and whose batch divides
    ``n_microbatches`` runs :func:`pipeline_transformer` over ``mesh``; the
    others (e.g. a 3-caption text batch under 4 microbatches) run plainly,
    as in JAX. Place the tower first (:func:`pipeline_place`) so that each
    rank holds only its stage's blocks. The hook is always reset::

        pipeline_place(tower, mesh)
        with pipelined_trunks(mesh, n_microbatches=4):
            feats = tower(x)
    """
    _check_pipe(mesh)
    set_trunk_pipeline((mesh, n_microbatches))
    try:
        yield
    finally:
        set_trunk_pipeline(None)
