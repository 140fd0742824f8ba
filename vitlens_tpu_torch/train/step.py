"""Training step, single device (port of vitlens_tpu/train/step.py with
``mesh=None``): AdamW with the reference's weight-decay exclusion, frozen
towers, trainable-only gradients, the accum-freq cached-negative replay, the
logit-scale clamp.

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
grad pass's). A mesh needs the parallelism work (ROADMAP Queue 1, item 12).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from vitlens_tpu_torch.adapters.tokenizers import BatchNorm
from vitlens_tpu_torch.models import tri
from vitlens_tpu_torch.models.vit import draw_patch_keep
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
    t}}`` for the trainable names only."""

    def __init__(self, cfg: OptimizerConfig, trainable: Mask, decay: Mask):
        self.cfg = cfg
        self.schedule = get_schedule(cfg.schedule, cfg.lr, cfg.warmup,
                                     cfg.total_steps)
        self.names = [n for n, t in trainable.items() if t]
        self.decay = decay

    def init(self, model: nn.Module) -> Dict[str, Any]:
        params = dict(model.named_parameters())
        zeros = lambda: {n: torch.zeros_like(params[n]) for n in self.names}  # noqa: E731
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update_(self, params: Dict[str, torch.Tensor],
                grads: Dict[str, torch.Tensor], state: Dict[str, Any]) -> None:
        """Apply one update to ``params`` (the trainable ones) in place."""
        cfg = self.cfg
        if cfg.grad_clip_norm:
            norm = global_norm(grads)
            keep = norm < cfg.grad_clip_norm
            grads = {n: torch.where(keep, g, g / norm * cfg.grad_clip_norm)
                     for n, g in grads.items()}
        count = state["count"]
        lr = self.schedule(count)
        t = count + 1
        bc1, bc2 = 1 - cfg.beta1 ** t, 1 - cfg.beta2 ** t
        for name in self.names:
            p, g = params[name], grads[name]
            mu, nu = state["mu"][name], state["nu"][name]
            mu.mul_(cfg.beta1).add_(g, alpha=1 - cfg.beta1)
            nu.mul_(cfg.beta2).addcmul_(g, g, value=1 - cfg.beta2)
            u = (mu / bc1) / ((nu / bc2).sqrt() + cfg.eps)
            if self.decay[name]:
                u = u + cfg.weight_decay * p
            p.add_(u, alpha=-lr)
        state["count"] = t


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
    sim_thres: float = 0.9
    accum_freq: int = 1
    compute_dtype: torch.dtype = torch.bfloat16
    # True or "full": recompute each trunk block; "dots": save its 2-D
    # products, recompute the rest (models.layers.remat_policy)
    remat: Any = False
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
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(params.items(), got)}


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
    return loss.detach(), _grads(loss, params)


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
            grads = _grads(loss, params)
            loss_total = loss_total + loss.detach()
            grads_total = grads if grads_total is None else {
                n: grads_total[n] + g for n, g in grads.items()}
    return loss_total / A, grads_total


def draw_fps_starts(model, batch, accum_freq: int,
                    generator: Optional[torch.Generator]):
    """One FPS start a cloud for each of the ``accum_freq`` micro-batches,
    uniform in [0, N) from ``generator``, on its device; None where the Lens
    tower is no point-cloud tower or no generator is given (FPS then starts
    at point 0, as JAX's does without ``fps_key``)."""
    if generator is None or model.visual.cfg.modality != "pc":
        return None
    b, n = batch["visual"].shape[:2]
    return [torch.randint(0, n, (b // accum_freq,), generator=generator,
                          device=generator.device, dtype=torch.int32)
            for _ in range(accum_freq)]


def draw_patch_keeps(model, batch, sc: StepConfig,
                     generator: Optional[torch.Generator]):
    """The Lens tower's train-time patch dropout, drawn once for each of the
    ``accum_freq`` micro-batches from ``generator`` (after the FPS starts),
    shared by both passes of a micro-batch (JAX folds ``fps_key`` with the
    micro-batch's index); None where the tower has no patch dropout, no
    generator is given or the step is the video distill one (JAX gives that
    forward no ``fps_key``)."""
    cfg = model.visual.cfg
    if generator is None or cfg.patch_dropout <= 0 or sc.video_distill:
        return None
    b = batch["visual"].shape[0] // sc.accum_freq
    return [draw_patch_keep(cfg, b, generator) for _ in range(sc.accum_freq)]


def make_train_step(model_cfg, tx: AdamW, trainable_mask: Mask,
                    sc: StepConfig = StepConfig(), mesh=None,
                    partition: str = "ddp"):
    """Build the single-device step: ``step(state, batch, fps_generator=None,
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
    ``model_cfg`` is the JAX signature's and is not read."""
    if mesh is not None or partition != "ddp":
        raise NotImplementedError(
            "the data-parallel and FSDP train steps (mesh, partition) are not "
            "yet ported: ROADMAP Queue 1, item 12 (parallelism)")
    if sc.n_tower not in (2, 3) or sc.align_to not in ("text", "image",
                                                       "video", "clip"):
        raise ValueError(f"unknown step: n_tower={sc.n_tower}, "
                         f"align_to={sc.align_to!r}")
    loss_fn = losses_lib.make_loss_fn(sc.n_tower, sc.contra_loss_type,
                                      sim_thres=sc.sim_thres)
    names = [n for n, t in trainable_mask.items() if t]
    A = sc.accum_freq

    def step(state: TrainState, batch,
             fps_generator: Optional[torch.Generator] = None,
             fps_starts: Optional[Sequence[torch.Tensor]] = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model = state.model
        dev = model.logit_scale.device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        batch["text"] = batch["text"].long()
        if fps_starts is None:
            fps_starts = draw_fps_starts(model, batch, A, fps_generator)
        if fps_starts is not None:
            if len(fps_starts) != A:
                raise ValueError(f"{len(fps_starts)} sets of FPS starts for "
                                 f"accum_freq {A}")
            fps_starts = [torch.as_tensor(s).to(dev) for s in fps_starts]
        patch_keeps = draw_patch_keeps(model, batch, sc, fps_generator)
        all_params = dict(model.named_parameters())
        params = {n: all_params[n] for n in names}
        if A > 1:
            loss, grads = accum_grads(model, batch, sc, params, loss_fn,
                                      fps_starts, patch_keeps)
        else:
            loss, grads = micro_grads(
                model, batch, sc, params, loss_fn,
                None if fps_starts is None else fps_starts[0],
                None if patch_keeps is None else patch_keeps[0])
        grad_norm = global_norm(grads)
        tx.update_(params, grads, state.opt_state)
        clamp_logit_scale(model)
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm,
                       "logit_scale": model.logit_scale.detach().exp()}

    return step
