"""Training step (port of vitlens_tpu/train/step.py): AdamW with the
reference's weight-decay exclusion, frozen towers, trainable-only gradients,
the accum-freq cached-negative replay, the logit-scale clamp.

The optimizer reproduces the JAX package's ``optax.masked(optax.chain(
clip_by_global_norm, adamw(schedule, mask=wd_mask)), trainable)``: the lr of
an update is ``schedule(count)`` with count starting at 0, weight decay is
decoupled and masked by :func:`wd_mask`, frozen parameters get no optimizer
state, and the clip is ``g / norm * max_norm`` only where ``norm >=
max_norm``. Unlike JAX's pure step, the port updates the parameters and the
optimizer state in place (it keeps one copy of each), and returns the same
``TrainState`` with its step advanced.

Every objective of the JAX package's single-device step trains here: the
tri loss (``n_tower=3``), the dual loss anchored to text, images, video
frames (``align_to`` image or video: the frozen image tower, frames
averaged) or the classic CLIP pair (``align_to="clip"``: image against
text, no Lens tower), and the video distill-tokens step
(``video_distill``). A point-cloud tower trains with batch BatchNorm and
random FPS starts: the step draws one start a cloud for each micro-batch,
once, from the generator it is given (JAX folds ``fps_key`` with the
micro-batch's index), and both passes of that micro-batch use them. The
running statistics move once a micro-batch, in the cached pass when
``accum_freq`` > 1 (JAX keeps the state of its no-grad pass and drops the
grad pass's).

With a mesh (``parallel.mesh.make_mesh()`` in a process group, one process a
rank) the step is JAX's ``shard_map`` DDP step: each rank computes the loss
of its rows with the embeddings gathered over the ranks (``local_loss``: its
``[B_local, B_global]`` block), its BatchNorms share their moments
(``sync_bn``), and the trainable gradients and the loss are averaged over
the ranks before the update, so every rank applies the same one.

``partition="fsdp"`` over such a mesh is JAX's FSDP step, which JAX runs as
one global-batch computation on sharded arrays: the state is placed first
(``parallel.fsdp.fsdp_place``: FSDP2 over the blocks and towers), and the
step computes what that global computation does. The loss gathers the
features as the DP step's does; BatchNorm takes its moments over every
rank's rows whatever ``sync_bn`` says; the FPS starts and the patch dropout
are drawn for the global batch from a generator seeded alike on every rank,
and each rank takes its rows. With ``accum_freq`` A > 1, JAX's micro-batch
i is the i-th of A contiguous slices of the global batch, so the ranks
first trade rows (:func:`jax_micro_rows`): rank r's i-th micro-batch is its
share of that slice. Every step takes its gradients with
``loss.backward()``: FSDP2 reduce-scatters (averages) the sharded ones into
their ``.grad`` (``autograd.grad`` against a sharded parameter, which is
not in the graph, since FSDP2 runs the forward on gathered copies, would
give nothing). The replicated ones are averaged as the DP step averages
them; ``grad_norm`` is the one global norm (``parallel.fsdp.
sharded_norm``), and the clip and AdamW run elementwise on each rank's
shards.

A mesh with a model axis (``make_mesh(n_model=tp)``) runs either step over
its data axis; a tower split over the model axis (``parallel.tp``, placed
by ``parallel.fsdp.fsdp_tp_place``) computes the same features on every
model rank of a data row, so every model rank computes the same loss. Its
TP slices' gradients are averaged over the data axis like a replicated
one's, and ``grad_norm`` counts each slice once and each whole tensor once.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from vitlens_tpu_torch.adapters.tokenizers import BatchNorm, batch_norm_synced
from vitlens_tpu_torch.models import tri
from vitlens_tpu_torch.models.vit import draw_patch_keep
from vitlens_tpu_torch.parallel.fsdp import (fsdp_units, local_tensor,
                                             reshard_, shard_axis,
                                             sharded_norm)
from vitlens_tpu_torch.parallel.mesh import (Mesh, all_gather,
                                             average_gradients_,
                                             mean_over_ranks)
from vitlens_tpu_torch.parallel.tp import split_params
from vitlens_tpu_torch.train import losses as losses_lib
from vitlens_tpu_torch.train.freeze import Mask
from vitlens_tpu_torch.train.schedules import get_schedule

MAX_LOGIT_SCALE = math.log(100.0)

_NO_DECAY_LEAF_NAMES = {
    "b", "bias", "scale", "qkv_b", "out_b", "gamma",
    "class_embedding", "logit_scale",
}


def wd_mask(model: nn.Module) -> Mask:
    """True where weight decay applies, by the parameter's leaf name: the
    reference excludes biases, LN/BN parameters, the class embedding and
    the logit scale (audio_main.py:368-393)."""
    return {name: name.rsplit(".", 1)[-1] not in _NO_DECAY_LEAF_NAMES
            for name, _ in model.named_parameters()}


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 5e-4
    beta1: float = 0.9
    beta2: float = 0.98  # reference default for ViT runs (params.py)
    eps: float = 1e-6
    weight_decay: float = 0.2
    grad_clip_norm: Optional[float] = None
    warmup: int = 10000
    total_steps: int = 100000
    schedule: str = "cosine"


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum() for g in grads.values()))


class AdamW:
    """``optax.masked(chain(clip_by_global_norm?, adamw), trainable)`` over
    named parameters. State: ``{"count": int, "mu": {name: t}, "nu": {name:
    t}}`` for the trainable names only.

    ``lr_scale`` ({name: scale}, every trainable name) multiplies each
    parameter's whole update, weight decay included, after AdamW, and leaves
    the moments as they are: the OpenShape trainer's ``updates * lr_scale``
    (vitlens_tpu/cli/train_openshape.py), so ``p -= lr_t * scale * (adam +
    wd * p)``."""

    def __init__(self, cfg: OptimizerConfig, trainable: Mask, decay: Mask,
                 lr_scale: Optional[Dict[str, float]] = None):
        self.cfg = cfg
        self.schedule = get_schedule(cfg.schedule, cfg.lr, cfg.warmup,
                                     cfg.total_steps)
        self.names = [n for n, t in trainable.items() if t]
        self.decay = decay
        self.lr_scale = lr_scale

    def init(self, model: nn.Module) -> Dict[str, Any]:
        params = dict(model.named_parameters())
        zeros = lambda: {n: torch.zeros_like(params[n]) for n in self.names}  # noqa: E731
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update_(self, params: Dict[str, torch.Tensor],
                grads: Dict[str, torch.Tensor], state: Dict[str, Any],
                norm: Optional[torch.Tensor] = None) -> None:
        """Apply one update to ``params`` (the trainable ones) in place. The
        clip takes ``norm``, the gradients' global norm, when given (the
        FSDP step's, over the ranks' shards), else computes it. Sharded
        parameters, gradients and moments (``DTensor``s) update on their
        local shards."""
        cfg = self.cfg
        grads = {n: local_tensor(g) for n, g in grads.items()}
        if cfg.grad_clip_norm:
            norm = global_norm(grads) if norm is None else norm
            keep = norm < cfg.grad_clip_norm
            grads = {n: torch.where(keep, g, g / norm * cfg.grad_clip_norm)
                     for n, g in grads.items()}
        count = state["count"]
        lr = self.schedule(count)
        t = count + 1
        bc1, bc2 = 1 - cfg.beta1 ** t, 1 - cfg.beta2 ** t
        for name in self.names:
            p, g = local_tensor(params[name]), grads[name]
            mu = local_tensor(state["mu"][name])
            nu = local_tensor(state["nu"][name])
            mu.mul_(cfg.beta1).add_(g, alpha=1 - cfg.beta1)
            nu.mul_(cfg.beta2).addcmul_(g, g, value=1 - cfg.beta2)
            u = (mu / bc1) / ((nu / bc2).sqrt() + cfg.eps)
            if self.decay[name]:
                u = u + cfg.weight_decay * p
            scale = 1.0 if self.lr_scale is None else self.lr_scale[name]
            p.add_(u, alpha=-lr * scale)
        state["count"] = t


def make_openshape_optimizer(model: nn.Module, *, lr: float, warmup: int,
                             total_steps: int, weight_decay: float,
                             decay: Mask, lr_scale: Dict[str, float]) -> AdamW:
    """The OpenShape trainer's optimizer, as JAX's CLI builds it
    (vitlens_tpu/cli/train_openshape.py): ``chain(clip_by_global_norm(1.0),
    adamw(cosine schedule, weight_decay, mask=decay))`` with optax's
    defaults (b1 0.9, b2 0.999, eps 1e-8), every parameter trained, each
    update times ``lr_scale``. ``decay`` is JAX's ``ndim >= 2`` mask
    (``train.openshape.ndim_wd_mask``)."""
    cfg = OptimizerConfig(lr=lr, beta1=0.9, beta2=0.999, eps=1e-8,
                          weight_decay=weight_decay, grad_clip_norm=1.0,
                          warmup=warmup, total_steps=total_steps,
                          schedule="cosine")
    return AdamW(cfg, {n: True for n, _ in model.named_parameters()}, decay,
                 lr_scale)


def make_optimizer(model: nn.Module, cfg: OptimizerConfig,
                   trainable_mask: Optional[Mask] = None) -> Tuple[AdamW, Mask]:
    if trainable_mask is None:
        trainable_mask = {name: True for name, _ in model.named_parameters()}
    return AdamW(cfg, trainable_mask, wd_mask(model)), trainable_mask


@dataclass
class TrainState:
    model: nn.Module
    opt_state: Dict[str, Any]
    step: int = 0


def init_train_state(model: nn.Module, tx: AdamW) -> TrainState:
    """The optimizer state of ``model``, whose trainable parameters (those
    ``factory.make_trainable_`` marked) must be exactly the optimizer's, and
    fp32 masters."""
    for name, p in model.named_parameters():
        if p.requires_grad != (name in tx.names):
            raise ValueError(f"{name}: requires_grad={p.requires_grad} does not "
                             "match the mask; call factory.make_trainable_ first")
        if p.requires_grad and p.dtype != torch.float32:
            raise ValueError(f"{name}: a trainable parameter must be an fp32 "
                             f"master, got {p.dtype}")
    return TrainState(model=model, opt_state=tx.init(model))


@torch.no_grad()
def clamp_logit_scale(model: nn.Module) -> None:
    model.logit_scale.clamp_(0.0, MAX_LOGIT_SCALE)


@dataclass(frozen=True)
class StepConfig:
    n_tower: int = 3                  # 3 = tri loss, 2 = dual (align_to)
    align_to: str = "image"           # dual anchor: image | text; or "clip"
    contra_loss_type: str = "general"  # general | label_mask | sim_mask
    # over a mesh: this rank's [B_local, B_global] logit block
    local_loss: bool = True
    sim_thres: float = 0.9
    accum_freq: int = 1
    compute_dtype: torch.dtype = torch.bfloat16
    # True or "full": recompute each trunk block; "dots": save its 2-D
    # products, recompute the rest (models.layers.remat_policy)
    remat: Any = False
    # over a mesh: BatchNorm moments averaged over the ranks (SyncBatchNorm)
    sync_bn: bool = True
    # the video distill-tokens step (reference vid_distill_tokens,
    # model.py:545-585): the frame-mean image tower over the clip as the
    # anchor, plus token distillation into the video Lens tower
    video_distill: bool = False

    def __post_init__(self):
        # only the video-distill forward gives the tokens that the
        # distill-token loss reads
        if self.contra_loss_type == "distill_token" and not self.video_distill:
            raise ValueError(
                "contra_loss_type='distill_token' needs the video-distill "
                "forward (it is the only one emitting visual_tokens/"
                "image_tokens): set video_distill=True "
                f"(got n_tower={self.n_tower}, video_distill=False)")


def _forward_features(model, batch, sc: StepConfig,
                      fps_start: Optional[torch.Tensor] = None,
                      patch_keep: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
    """Encode the towers the step's objective reads: ``batch["image"]``
    (images, or frames [B, T, 3, H, W]) through the image tower,
    ``batch["text"]`` through the text tower and ``batch["visual"]``
    through the Lens tower (a point cloud's FPS from ``fps_start``, the
    train-time patch dropout's kept patches ``patch_keep``)."""
    kw = dict(normalize=True, compute_dtype=sc.compute_dtype, remat=sc.remat)
    if sc.video_distill:
        return tri.tri_forward_video_distill(
            model, video_frames=batch["image"], text=batch["text"],
            visual_x=batch["visual"], train=True,
            compute_dtype=sc.compute_dtype, remat=sc.remat)
    out = {"logit_scale": model.logit_scale.exp().float()}
    if sc.n_tower == 2 and sc.align_to == "clip":
        # the classic CLIP pair: images against text, no Lens tower
        out["anchor_features"] = tri.encode_image(model, batch["image"], **kw)
        out["visual_features"] = tri.encode_text(model, batch["text"], **kw)
        return out
    if sc.n_tower == 3:
        out["image_features"] = tri.encode_image(model, batch["image"], **kw)
        out["text_features"] = tri.encode_text(model, batch["text"], **kw)
    elif sc.align_to in ("image", "video"):
        out["anchor_features"] = tri.encode_image(model, batch["image"], **kw)
    else:
        out["anchor_features"] = tri.encode_text(model, batch["text"], **kw)
    out["visual_features"] = tri.encode_visual(
        model, batch["visual"], train=True, fps_start=fps_start,
        patch_keep=patch_keep, **kw)
    return out


def _grads(loss, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``autograd.grad`` of ``loss`` for ``params`` (the OpenShape step's):
    blind to FSDP2's sharded parameters, which are not in the graph."""
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(params.items(), got)}


def _backward_grads(loss, params: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """The gradients ``loss.backward()`` leaves in the ``params``' ``.grad``,
    taken out (the fields cleared, so that the next pass starts from none):
    under FSDP2 a sharded parameter's is its reduce-scattered shard. Only
    the trainable parameters may require grad (``factory.make_trainable_``):
    the backward fills the ``.grad`` of every one that does."""
    loss.backward()
    out = {}
    for n, p in params.items():
        out[n] = torch.zeros_like(p) if p.grad is None else p.grad
        p.grad = None
    return out


@contextlib.contextmanager
def running_stats_kept(model: nn.Module):
    """Restores every BatchNorm's running statistics on exit: the passes
    inside run in train mode, and their updates are dropped."""
    saved = [(bn, bn.mean.clone(), bn.var.clone()) for bn in model.modules()
             if isinstance(bn, BatchNorm)]
    try:
        yield
    finally:
        with torch.no_grad():
            for bn, mean, var in saved:
                bn.mean.copy_(mean)
                bn.var.copy_(var)


def micro_grads(model, batch, sc: StepConfig, params, loss_fn,
                fps_start: Optional[torch.Tensor] = None,
                patch_keep: Optional[torch.Tensor] = None):
    """(loss, {name: grad}) of one pass over the whole batch, for the
    trainable ``params`` only."""
    loss = loss_fn(_forward_features(model, batch, sc, fps_start, patch_keep),
                   batch.get("label"))
    return loss.detach(), _backward_grads(loss, params)


def accum_grads(model, batch, sc: StepConfig, params, loss_fn,
                fps_starts: Optional[Sequence[torch.Tensor]] = None,
                patch_keeps: Optional[Sequence[torch.Tensor]] = None):
    """--accum-freq replay (reference train.py:154-210): features of every
    micro-batch cached without grad, then per micro-batch a pass with grad,
    with the cached features of the others spliced in as negatives. The sum
    of the pass gradients is the full-batch gradient (no 1/accum scaling);
    the loss is averaged for logging. Micro-batch i's two passes take
    ``fps_starts[i]`` and ``patch_keeps[i]``; the BatchNorm running
    statistics move in the cached passes only."""
    A = sc.accum_freq
    b = next(iter(batch.values())).shape[0]
    if b % A:
        raise ValueError(f"batch {b} is not divisible by accum_freq {A}")
    micro = [{k: v[i * (b // A):(i + 1) * (b // A)] for k, v in batch.items()}
             for i in range(A)]
    starts = list(fps_starts) if fps_starts is not None else [None] * A
    keeps = list(patch_keeps) if patch_keeps is not None else [None] * A
    with torch.no_grad():
        cached = [_forward_features(model, mb, sc, st, kp)
                  for mb, st, kp in zip(micro, starts, keeps)]
    # the tokens too: the distill-token loss is a mean over samples, so
    # splicing the other micro-batches' cached tokens is exact
    keys = [k for k in cached[0] if k.endswith(("_features", "_tokens"))]
    loss_total, grads_total = 0.0, None
    with running_stats_kept(model):
        for i, mb in enumerate(micro):
            out_i = _forward_features(model, mb, sc, starts[i], keeps[i])
            merged = {"logit_scale": out_i["logit_scale"]}
            for k in keys:
                merged[k] = torch.cat([out_i[k] if j == i else cached[j][k]
                                       for j in range(A)])
            loss = loss_fn(merged, batch.get("label"))
            grads = _backward_grads(loss, params)
            loss_total = loss_total + loss.detach()
            grads_total = grads if grads_total is None else {
                n: grads_total[n] + g for n, g in grads.items()}
    return loss_total / A, grads_total


def _rank_rows(x: torch.Tensor, world: int, rank: int) -> torch.Tensor:
    b = x.shape[0] // world
    return x[rank * b:(rank + 1) * b]


def jax_micro_rows(batch: Dict[str, torch.Tensor], mesh: Mesh,
                   accum_freq: int) -> Dict[str, torch.Tensor]:
    """This rank's rows of the global batch (every rank's, in rank order)
    in JAX's micro-batch order: the i-th of its ``accum_freq`` equal slices
    is its share of the i-th contiguous slice of the global batch, which
    JAX's global step takes as micro-batch i. The ranks all-gather the
    batch, each keeps its rows."""
    W, r, A = mesh.data, mesh.rank, accum_freq
    out = {}
    with torch.no_grad():
        for k, v in batch.items():
            if v.shape[0] % A:
                raise ValueError(f"batch {v.shape[0]} is not divisible by "
                                 f"accum_freq {A}")
            g, m = all_gather(v, mesh), v.shape[0] // A
            out[k] = torch.cat([g[(i * W + r) * m:(i * W + r + 1) * m]
                                for i in range(A)])
    return out


def draw_fps_starts(model, batch, accum_freq: int,
                    generator: Optional[torch.Generator], world: int = 1,
                    rank: int = 0):
    """One FPS start a cloud for each of the ``accum_freq`` micro-batches,
    uniform in [0, N) from ``generator``, on its device; None where the Lens
    tower is no point-cloud tower or no generator is given (FPS then starts
    at point 0, as JAX's does without ``fps_key``). With ``world`` > 1 the
    starts are drawn for the micro-batches of the global batch, ``world``
    times this rank's rows, and ``rank``'s share of each (the ``rank``-th
    of ``world`` equal slices) is kept."""
    if generator is None or model.visual.cfg.modality != "pc":
        return None
    b, n = batch["visual"].shape[:2]
    return [_rank_rows(torch.randint(
        0, n, (world * b // accum_freq,), generator=generator,
        device=generator.device, dtype=torch.int32), world, rank)
        for _ in range(accum_freq)]


def draw_patch_keeps(model, batch, sc: StepConfig,
                     generator: Optional[torch.Generator], world: int = 1,
                     rank: int = 0):
    """The Lens tower's train-time patch dropout, drawn once for each of the
    ``accum_freq`` micro-batches from ``generator`` (after the FPS starts),
    shared by both passes of a micro-batch (JAX folds ``fps_key`` with the
    micro-batch's index); None where the tower has no patch dropout, no
    generator is given or the step is the video distill one (JAX gives that
    forward no ``fps_key``). ``world`` and ``rank``: as
    :func:`draw_fps_starts`."""
    cfg = model.visual.cfg
    if generator is None or cfg.patch_dropout <= 0 or sc.video_distill:
        return None
    b = world * batch["visual"].shape[0] // sc.accum_freq
    return [_rank_rows(draw_patch_keep(cfg, b, generator), world, rank)
            for _ in range(sc.accum_freq)]


def _step_mesh(mesh, partition: str) -> Optional[Mesh]:
    """The mesh the step reduces over (None: one device; then
    ``partition="fsdp"`` is the one-device step, as in JAX)."""
    if partition not in ("ddp", "fsdp"):
        raise ValueError(f"unknown partition style: {partition!r}")
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh)!r}")
    if not mesh.spans_processes:
        if mesh.data > 1:
            raise ValueError(
                f"the {'FSDP' if partition == 'fsdp' else 'data-parallel'} "
                "step runs one process a rank: launch it "
                "with torchrun and pass make_mesh() of the process group (a "
                "local mesh of several devices serves, it does not train)")
        return None
    return mesh


def make_train_step(model_cfg, tx: AdamW, trainable_mask: Mask,
                    sc: StepConfig = StepConfig(), mesh=None,
                    partition: str = "ddp"):
    """Build the step: ``step(state, batch, fps_generator=None,
    fps_starts=None) -> (state, metrics)`` with batch ``{"text": [B, 77] ids,
    "visual": the Lens tower's input, "image": images [B, 3, H, W] or frames
    [B, T, 3, H, W], optional "label"}`` (the keys the objective reads) and
    metrics ``loss``, ``logit_scale`` (after the update) and ``grad_norm``
    (before the clip), 0-dim tensors. A point-cloud Lens tower's FPS starts
    are drawn from ``fps_generator`` (:func:`draw_fps_starts`), or given as
    ``fps_starts``, one int tensor [B / accum_freq] a micro-batch; with
    neither, FPS starts at point 0. ``fps_generator`` is the step's
    generator, as JAX's ``fps_key`` is its key: the Lens tower's train-time
    patch dropout is drawn from it too (:func:`draw_patch_keeps`), and
    without it no patch is dropped. The towers come from the state's model;
    ``model_cfg`` is the JAX signature's and is not read.

    ``mesh``: the data-parallel step (module docstring). Each rank passes its
    own rows, and its own ``fps_generator`` (the reference seeds each rank
    with seed + rank) or ``fps_starts``; ``loss`` is the mean over the ranks
    and ``grad_norm`` the norm of the averaged gradient. With
    ``partition="fsdp"`` the state must be placed (``parallel.fsdp.
    fsdp_place``); each rank passes its own rows and a generator seeded as
    every other rank's, or the global batch's ``fps_starts`` (one [world *
    B / accum_freq] a micro-batch: JAX's micro-batch i, the i-th contiguous
    slice of the global batch), and the metrics are those of the
    data-parallel step."""
    mesh = _step_mesh(mesh, partition)
    fsdp = mesh is not None and partition == "fsdp"
    if sc.n_tower not in (2, 3) or sc.align_to not in ("text", "image",
                                                       "video", "clip"):
        raise ValueError(f"unknown step: n_tower={sc.n_tower}, "
                         f"align_to={sc.align_to!r}")
    loss_fn = losses_lib.make_loss_fn(sc.n_tower, sc.contra_loss_type,
                                      axis_name=mesh, local_loss=sc.local_loss,
                                      sim_thres=sc.sim_thres)
    # the global computation's BatchNorm takes every rank's rows
    bn_mesh = mesh if (sc.sync_bn or fsdp) else None
    names = [n for n, t in trainable_mask.items() if t]
    A = sc.accum_freq
    world, rank = (mesh.data, mesh.rank) if fsdp else (1, 0)

    def step(state: TrainState, batch,
             fps_generator: Optional[torch.Generator] = None,
             fps_starts: Optional[Sequence[torch.Tensor]] = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model = state.model
        if fsdp:
            if not fsdp_units(model):
                raise ValueError("partition='fsdp': place the state with "
                                 "parallel.fsdp.fsdp_place first")
            reshard_(model)  # an eval may have left a tower gathered
        dev = model.logit_scale.device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        batch["text"] = batch["text"].long()
        if fsdp and A > 1:
            batch = jax_micro_rows(batch, mesh, A)
        if fps_starts is None:
            fps_starts = draw_fps_starts(model, batch, A, fps_generator,
                                         world, rank)
        elif fsdp:  # the global batch's: this rank's rows
            fps_starts = [_rank_rows(torch.as_tensor(s), world, rank)
                          for s in fps_starts]
        if fps_starts is not None:
            if len(fps_starts) != A:
                raise ValueError(f"{len(fps_starts)} sets of FPS starts for "
                                 f"accum_freq {A}")
            fps_starts = [torch.as_tensor(s).to(dev) for s in fps_starts]
        patch_keeps = draw_patch_keeps(model, batch, sc, fps_generator,
                                       world, rank)
        all_params = dict(model.named_parameters())
        params = {n: all_params[n] for n in names}
        with batch_norm_synced(model, bn_mesh):
            if A > 1:
                loss, grads = accum_grads(model, batch, sc, params, loss_fn,
                                          fps_starts, patch_keeps)
            else:
                loss, grads = micro_grads(
                    model, batch, sc, params, loss_fn,
                    None if fps_starts is None else fps_starts[0],
                    None if patch_keeps is None else patch_keeps[0])
        if fsdp:
            reshard_(model)
        if mesh is not None:
            # the DDP all-reduce; FSDP2 averaged the sharded gradients, the
            # others and the loss are averaged as the DDP step averages them
            average_gradients_({n: g for n, g in grads.items()
                                if shard_axis(g) is None}, mesh)
            loss = mean_over_ranks(loss, mesh)
        if fsdp or (mesh is not None and mesh.model > 1):
            grad_norm = sharded_norm(grads, mesh, split_params(model))
            tx.update_(params, grads, state.opt_state, norm=grad_norm)
        else:
            grad_norm = global_norm(grads)
            tx.update_(params, grads, state.opt_state)
        clamp_logit_scale(model)
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm,
                       "logit_scale": model.logit_scale.detach().exp()}

    return step
