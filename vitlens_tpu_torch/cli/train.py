"""The trainer (port of vitlens_tpu/cli/train.py).

One entry point for every modality and objective of the train step:
build the model, the data and the step, run epochs, evaluate zero-shot at
each epoch end, checkpoint epoch_N / epoch_latest / checkpoint_best, resume.
Eval-only mode when --train-data is absent (reference audio_main.py:525-535).
The model runs on the card unless --device names another device (``cpu``).

Usage:
  python -m vitlens_tpu_torch.cli.train --modality audio --n-tower 2 \\
      --align-to text --unlock-cls --precision bf16 \\
      --pretrained vitlensL_audio.pt --train-data audioset@train \\
      --val-data esc50@fold-1::audiocaps@test
  python -m vitlens_tpu_torch.cli.train --modality pc --val-data modelnet40

Data parallel over N cards, one process a card (the reference's DDP):
  python -m torch.distributed.run --nproc-per-node N \
      -m vitlens_tpu_torch.cli.train ... --batch-size 64
joins the process group first (``parallel.mesh.init_distributed``: torchrun's
or SLURM's variables; NCCL on the cards, gloo with --device cpu). --batch-size
stays per replica; each rank loads its slice of the data, the step gathers
the embeddings and averages the gradients over the ranks, the eval encodes a
slice of each batch on each rank and gathers the features, rank 0 writes the
logs, results and checkpoints (the others log to out.rank{r}.log), and a
SIGTERM is agreed over the ranks. --n-devices, when given, must equal the
number of ranks.

--tp N splits the ranks into a [ranks / N, N] mesh (``parallel.mesh.
make_mesh(n_model=N)``; N must divide the ranks): the ranks of one data row
load the same rows and split the Lens tower's trunk over the model axis
(Megatron TP, ``parallel.tp``), and the state is placed by
``parallel.fsdp.fsdp_tp_place`` (FSDP over the data axis for the rest) for
the step of ``partition="fsdp"``, as in JAX. --batch-size stays per data
replica; the throughput meter counts every rank.

--fsdp over several ranks shards the train state (``parallel.fsdp``: FSDP2
over the blocks and towers) and runs JAX's global-batch FSDP step
(``make_train_step(partition="fsdp")``). Its checkpoints are collective
(``checkpoint.save_checkpoint_sharded``): every rank writes its shards,
synchronously, at each epoch save, best save and preemption save; a resume
from one is deferred until after the placement ("resumed (sharded) from").
Its eval calls every tower the same number of times on every rank (each
call gathers the tower's weights).

The step's randomness (FPS starts, train-time patch dropout) comes from one
``torch.Generator`` on the device, seeded with --seed + the rank (the
reference seeds each rank so); under --fsdp with --seed on every rank, as
the draws are the global batch's. --lora-rank > 0 trains
rank-r factors on the --lora-towers' trunks alone (train/lora.py); a
--pretrained tag that is no file resolves through the local cache
(utils/hub.py).
"""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from vitlens_tpu_torch.cli.args import TrainArgs, parse_args
from vitlens_tpu_torch.config import make_model_config
from vitlens_tpu_torch.data.loader import DataInfo, SyntheticDataset, build_loader
from vitlens_tpu_torch.models import tri
from vitlens_tpu_torch.parallel.mesh import map_rank_rows
from vitlens_tpu_torch.train import checkpoint as C
from vitlens_tpu_torch.train.freeze import tri_model_mask
from vitlens_tpu_torch.train.step import (
    OptimizerConfig, StepConfig, init_train_state, make_optimizer,
    make_train_step,
)
from vitlens_tpu_torch.utils.logging import (
    MetricsWriter, ThroughputMeter, dump_params, log_param_census, setup_logging,
    start_trace, stop_trace,
)

MODALITY_BATCH_KEY = {"pc": "pc", "audio": "audio", "depth": "depth",
                      "tactile": "tactile", "eeg": "eeg", "video": "video"}


def build_train_data(args: TrainArgs, tokenizer, n_shards: int,
                     cfg=None, proc_id: int = 0,
                     n_procs: int = 1) -> Optional[DataInfo]:
    """n_shards = the global data-parallel replicas; the loader of this
    process's 1/n_procs slice of the global batch (reference
    DistributedSampler semantics: shard_id = rank)."""
    if not args.train_data:
        return None
    batch = args.batch_size * n_shards // n_procs
    if args.dataset_type == "synthetic":
        spec = _synthetic_spec(args, cfg)
        ds = SyntheticDataset(spec, n=args.train_num_samples or 1024,
                              seed=args.seed)
        return build_loader(ds, batch_size=batch, shard_id=proc_id,
                            n_shards=n_procs, shuffle=True, seed=args.seed,
                            num_workers=args.workers)
    ds = _build_real_dataset(args, args.train_data, train=True, cfg=cfg)
    return build_loader(ds, batch_size=batch, shard_id=proc_id,
                        n_shards=n_procs, shuffle=True, seed=args.seed,
                        num_workers=args.workers)


def _synthetic_spec(args: TrainArgs, cfg=None) -> Dict[str, tuple]:
    hw = cfg.vision.image_size if cfg is not None else 224
    ctx = cfg.text.context_length if cfg is not None else 77
    tower = cfg.tower if cfg is not None else None
    n_frames = (tower.video.n_frames if tower is not None
                and tower.video is not None else 3)
    vis_shapes = {
        "pc": ((tower.point.npoints if tower and tower.point else 8192), 3),
        "audio": ((tower.audio.target_length if tower and tower.audio else 512),
                  (tower.audio.mel_bins if tower and tower.audio else 128)),
        "depth": (1, hw, hw),
        "tactile": (3, hw, hw),
        "eeg": ((tower.eeg.chans if tower and tower.eeg else 128),
                (tower.eeg.time_len if tower and tower.eeg else 512)),
        "video": (n_frames, 3, hw, hw),
    }
    # the video anchor is the video itself through the frame-mean image
    # tower (reference 5-D image input, model.py:542-621)
    img_shape = (n_frames, 3, hw, hw) if args.modality == "video" else (3, hw, hw)
    return {
        "image": (img_shape, "f"),
        "text": ((ctx,), "i"),
        "visual": (vis_shapes[args.modality], "f"),
    }


def _build_real_dataset(args: TrainArgs, spec: str, train: bool,
                        cfg=None):
    from vitlens_tpu_torch.data import datasets as D

    if args.dataset_type == "csv":
        # classic image-text CSV training (reference data.py:150-170)
        from vitlens_tpu_torch.data.loader import CsvDataset
        from vitlens_tpu_torch.data.processors import (
            ImageProcessor,
            TextProcessor,
            TrainImageProcessor,
        )

        size = args.force_image_size or 224
        img_proc = (TrainImageProcessor(image_size=size,
                                        aug_cfg=args.aug_cfg,
                                        seed=args.seed)
                    if train else ImageProcessor(image_size=size))
        return CsvDataset(spec, img_key=args.csv_img_key,
                          caption_key=args.csv_caption_key,
                          sep=args.csv_separator,
                          image_processor=img_proc,
                          text_processor=TextProcessor(
                              tokenizer=_tokenizer(cfg)))
    m = args.modality
    if m == "audio":
        pk = None
        if cfg is not None and cfg.tower.audio is not None:
            a = cfg.tower.audio
            # the fbank geometry follows the model config (2-sec variant etc.)
            pk = dict(sampling_rate=a.sampling_rate,
                      clip_duration=a.clip_duration,
                      target_length=a.target_length, mel_bins=a.mel_bins)
        ak = {}
        if args.audio_freqm is not None:
            ak["freq_mask"] = args.audio_freqm
        if args.audio_timem is not None:
            ak["time_mask"] = args.audio_timem
        if args.audio_noise_aug is not None:
            ak["noise_aug"] = args.audio_noise_aug
        if args.audio_mix_up is not None:
            ak["mixup_prob"] = 0.5 if args.audio_mix_up else 0.0
        return D.create_audio_datasets(spec, train=train, proc_kwargs=pk,
                                       aug_kwargs=ak or None)[0]
    # paired-image processors must match the model's resolution (the image
    # tower pos-emb is sized by it)
    hw = cfg.vision.image_size if cfg is not None else 224
    if m == "depth":
        return D.create_rgbd_datasets(spec, image_size=hw)[0]
    if m == "tactile":
        return D.TAGDataset(split=spec, image_size=hw)
    if m == "eeg":
        return D.EEGDataset(split=spec, image_size=hw)
    if m == "video":
        # spec = path to an annotation json ([{video_path, text|caption,
        # label?}], frame-dir sources)
        n_frames = (cfg.tower.video.n_frames
                    if cfg is not None and cfg.tower.video is not None else 8)
        return D.VideoDataset(anno_path=spec, n_frames=n_frames,
                              image_size=hw, train=train,
                              rand_aug=args.vid_rand_aug,
                              rand_aug_n=args.vid_rand_aug_n,
                              rand_aug_m=args.vid_rand_aug_m)
    if m == "pc":
        npoints = (cfg.tower.point.npoints
                   if cfg is not None and cfg.tower.point is not None
                   else 8192)
        if spec.startswith("modelnet"):
            return D.ModelNetDataset()
        if spec.startswith("scanobjectnn"):
            return D.ScanObjectNNDataset()
        if spec.startswith("objaverse"):
            _, _, root = spec.partition("@")
            return D.ObjaverseDataset(root=root or None, augment=train)
        return D.PCTripletDataset(anno_path=spec, augment=train,
                                  npoints=npoints, image_size=hw)
    raise ValueError(m)


def _tokenizer(cfg=None):
    """The CLIP BPE tokenizer; hf-text archs (roberta-ViT-B-32 etc.)
    tokenize with their HF tokenizer."""
    from vitlens_tpu_torch.text.tokenizer import get_tokenizer

    return get_tokenizer(hf_tokenizer_name=(
        cfg.text.hf_tokenizer_name if cfg is not None else None))


def _prep_batch(raw: Dict[str, Any], args: TrainArgs, tokenizer) -> Dict[str, Any]:
    """Map dataset keys -> train-step keys; tokenize captions host-side."""
    batch: Dict[str, Any] = {}
    vk = MODALITY_BATCH_KEY.get(args.modality, "visual")
    vis = raw.get("visual", raw.get(vk))
    if vis is not None:  # absent in classic-CLIP (csv) mode
        batch["visual"] = np.asarray(vis)
        if args.modality == "audio" and batch["visual"].ndim == 4:
            batch["visual"] = batch["visual"][:, 0]  # train uses 1 clip
    if "image" in raw:
        batch["image"] = np.asarray(raw["image"])
    elif (args.modality == "video" and "visual" in batch
          and (args.n_tower == 3 or args.video_distill)):
        # the video anchor IS the video: frames go through the frozen image
        # tower's frame-mean path (reference TriCLIP 5-D image handling,
        # model.py:542-621)
        batch["image"] = batch["visual"]
    if "text" in raw:
        batch["text"] = np.asarray(raw["text"])
    elif "caption_str" in raw:
        batch["text"] = tokenizer(list(raw["caption_str"]))
    if "label" in raw:
        batch["label"] = np.asarray(raw["label"])
    return batch


def eval_encoders(args: TrainArgs, model, mesh=None):
    """(encode_visual, encode_text) of the eval loops: numpy in, fp32 numpy
    features (not normalised) out, through the model's towers on its device
    in the --precision compute dtype, without autograd. Over a mesh each
    rank encodes its slice of the visual rows and the features gather
    (``parallel.mesh.map_rank_rows``); the text encodes run whole on every
    rank."""
    dt, dev = _dtype(args), model.logit_scale.device

    @torch.no_grad()
    def encode_visual(x):
        x = torch.as_tensor(np.asarray(x), dtype=torch.float32).to(dev)
        return map_rank_rows(mesh, lambda v: tri.encode_visual(
            model, v, compute_dtype=dt), x).float().cpu().numpy()

    @torch.no_grad()
    def encode_text(toks):
        toks = torch.as_tensor(np.asarray(toks)).to(dev).long()
        return tri.encode_text(model, toks, compute_dtype=dt).float().cpu().numpy()

    return encode_visual, encode_text


def evaluate(args: TrainArgs, model, cfg, tokenizer,
             mesh=None) -> Dict[str, float]:
    """Zero-shot eval on --val-data (dispatch on dataset.eval_metric), on the
    model's device. Over a mesh every rank iterates the whole val set, each
    encodes its slice of every visual (or image) batch and the features
    gather (the reference shards eval over its ranks, zero_shot.py:709-788);
    the metrics, computed alike on every rank from the gathered features,
    do not merge again (``distributed=False``), and equal one device's."""
    if not args.val_data:
        return {}
    from vitlens_tpu_torch.eval.zero_shot import (
        build_zero_shot_classifier, classification_eval, map_eval,
        retrieval_eval,
    )

    encode_visual, encode_text = eval_encoders(args, model, mesh)
    dt, dev = _dtype(args), model.logit_scale.device
    results = {}
    for spec in args.val_data.split("::"):
        if args.dataset_type == "csv":
            # paired image-text val: contrastive val loss + rank metrics
            # (reference evaluate + get_clip_metrics, train.py:766-874)
            from vitlens_tpu_torch.eval.metrics import clip_val_metrics

            ds = _build_real_dataset(args, spec, train=False, cfg=cfg)
            info = build_loader(ds, batch_size=args.batch_size, shuffle=False,
                                num_workers=args.workers, drop_last=False)
            img_feats, txt_feats = [], []
            with torch.no_grad():
                for b in info.dataloader:
                    img = torch.as_tensor(np.asarray(b["image"])).to(dev)
                    img_feats.append(map_rank_rows(mesh, lambda v: tri.encode_image(
                        model, v, normalize=True, compute_dtype=dt),
                        img).float().cpu().numpy())
                    txt_feats.append(encode_text(b["text"]))
            tf = np.concatenate(txt_feats)
            tf /= np.maximum(np.linalg.norm(tf, axis=1, keepdims=True), 1e-12)
            # the model's LEARNED scale, not a constant (reference scales
            # val logits with logit_scale.exp(), train.py:790)
            ls = float(model.logit_scale.detach().float().exp())
            out = clip_val_metrics(np.concatenate(img_feats), tf,
                                   logit_scale=ls)
            results[spec] = out
            logging.info(f"eval[{spec}]: " + ", ".join(
                f"{k}={v:.4f}" for k, v in out.items()))
            continue
        ds = _build_real_dataset(args, spec, train=False, cfg=cfg)
        vk = MODALITY_BATCH_KEY.get(args.modality, "visual")
        metric = getattr(ds, "eval_metric", "acc")
        clip_mean = args.modality == "audio"

        def batches():
            info = build_loader(ds, batch_size=args.batch_size, shuffle=False,
                                num_workers=args.workers, drop_last=False)
            for b in info.dataloader:
                tgt = (b.get("label") if metric == "acc" else
                       b.get("targets", b.get("label")))
                yield np.asarray(b["id"]), np.asarray(b[vk]), np.asarray(tgt)

        if metric == "recall":
            out = retrieval_eval(
                encode_visual, encode_text, tokenizer,
                ((i, x) for i, x, _ in batches()),
                texts=ds.texts, text_ids=ds.text_ids, clip_mean=clip_mean,
                distributed=False,
            )
        else:
            classifier = build_zero_shot_classifier(
                encode_text, tokenizer, ds.classnames, ds.templates)
            runner = classification_eval if metric == "acc" else map_eval
            out = runner(encode_visual, batches(), classifier,
                         clip_mean=clip_mean, distributed=False)
        results[spec] = out
        logging.info(f"eval[{spec}]: " + ", ".join(
            f"{k}={v:.4f}" for k, v in out.items()
            if isinstance(v, (int, float))))
    return results


def _apply_tower_overrides(cfg, args: TrainArgs):
    """Per-modality hyperparameter flags (reference params.py:645-935
    audio/pc/eeg/perceiver sections). A flag left at None keeps the vitlensL
    preset; set flags are grafted onto the tower's sub-configs."""
    import dataclasses
    from dataclasses import replace as _r

    tower = cfg.tower
    changed = {}
    for prefix, attr in (("audio", "audio"), ("pc", "point"),
                         ("eeg", "eeg"), ("vid", "video"),
                         ("perceiver", "perceiver")):
        sub = getattr(tower, attr)
        if sub is None:
            continue
        upd = {}
        for f in dataclasses.fields(sub):
            v = getattr(args, f"{prefix}_{f.name}", None)
            if v is not None:
                upd[f.name] = v
        if upd:
            changed[attr] = _r(sub, **upd)
    # the pc preset derives the perceiver's input dim from the tokenizer's
    # trans_dim — keep them in sync unless the user pinned it explicitly
    if (args.pc_trans_dim is not None and args.perceiver_input_dim is None
            and tower.perceiver is not None):
        pcv = changed.get("perceiver", tower.perceiver)
        changed["perceiver"] = _r(pcv, input_dim=args.pc_trans_dim)
    if changed:
        cfg = _r(cfg, tower=_r(tower, **changed))
    return cfg


def _dtype(args: TrainArgs):
    return {"bf16": torch.bfloat16, "pure_bf16": torch.bfloat16,
            "fp32": torch.float32}[args.precision]


def _primary_metric(results: Dict[str, Dict]) -> float:
    """Summed primary metric for save-best (reference keys summed val acc1,
    audio_main.py:599-611)."""
    total = 0.0
    for out in results.values():
        for key in ("accuracy", "map", "r_mean", "image_to_text_R@1"):
            if key in out:
                total += float(out[key])
                break
    return total


def _flatten_results(results: Dict[str, Dict]) -> Dict[str, float]:
    """Flatten per-dataset metric dicts into writer keys (the reference logs
    every val metric to tensorboard/wandb, train.py:861-874). File-path specs
    (csv mode) are reduced to their basename."""
    flat = {}
    for spec, out in results.items():
        name = os.path.basename(spec) if os.path.sep in spec else spec
        for k, v in out.items():
            if isinstance(v, (int, float)):
                flat[f"{name}/{k}"] = float(v)
    return flat


def check_supported(args: TrainArgs, world: Optional[int] = None) -> None:
    """Raise on an --n-devices that is not the ``world`` of ranks and on a
    --tp that does not divide it (when given; JAX's SystemExit)."""
    if world is not None and args.tp > 1 and world % args.tp:
        raise SystemExit(f"--tp {args.tp} does not divide {world} rank(s)")
    if world is not None and args.n_devices not in (None, world):
        raise ValueError(
            f"--n-devices {args.n_devices} but the run has {world} rank(s): "
            "data parallelism runs one process a card; launch with python -m "
            f"torch.distributed.run --nproc-per-node {args.n_devices}")


def build_model(args: TrainArgs, device):
    """(cfg, tokenizer, model, mask): the TriModel of --model/--modality in
    fp32 on ``device``, drawn from --seed, the --pretrained reference-layout
    file merged over it (non-strict, as in JAX), and its trainability mask
    from the lock flags."""
    from dataclasses import replace as _replace

    from vitlens_tpu_torch.factory import make_generator
    from vitlens_tpu_torch.models.tri import TriModel

    cfg = make_model_config(
        args.model, args.modality, quick_gelu=args.force_quick_gelu,
        force_image_size=args.force_image_size,
        skip_first_n_layers=args.skip_trans_first_n_layers,
    )
    tokenizer = _tokenizer(cfg)
    cfg = _apply_tower_overrides(cfg, args)
    if args.force_patch_dropout is not None:
        cfg = _replace(cfg, tower=_replace(
            cfg.tower, patch_dropout=args.force_patch_dropout))
    model = TriModel(cfg, device=device)
    model.init_(make_generator(args.seed, device))
    if args.pretrained:
        from vitlens_tpu_torch.weights.from_jax import merge_params
        from vitlens_tpu_torch.weights.torch_convert import (
            convert_tri_state_dict, load_torch_checkpoint)

        path = args.pretrained
        if not os.path.exists(path):  # a pretrained tag: the local cache
            from vitlens_tpu_torch.utils.hub import resolve_pretrained

            path = resolve_pretrained(args.model, args.pretrained)
        params, state = convert_tri_state_dict(load_torch_checkpoint(path), cfg)
        merge_params(model, params, state)
        logging.info(f"loaded pretrained {args.pretrained}")
    mask = tri_model_mask(
        model, cfg,
        lock_image=args.lock_image, lock_text=args.lock_text,
        lock_visual=args.lock_visual,
        visual_unlocked_groups=args.lock_visual_unlocked_groups,
        unlock_from_head=args.unlock_from_head, unlock_cls=args.unlock_cls,
        unlock_pos_emb=args.unlock_pos_emb,
        unlock_trans_first_n_layers=args.unlock_trans_first_n_layers,
    )
    if args.lora_rank > 0:
        mask = attach_lora(args, model, mask)
    return cfg, tokenizer, model, mask


def attach_lora(args: TrainArgs, model, mask):
    """--lora-rank > 0: rank-r factors on the trunks of the --lora-towers,
    each drawn from --seed + 17 + its index; those towers train their
    factors alone (the mask overrides their lock flags), as in JAX."""
    from vitlens_tpu_torch.factory import make_generator
    from vitlens_tpu_torch.train.lora import lora_init, lora_mask

    mask = dict(mask)
    towers = list(dict.fromkeys(  # strip + dedup, order-preserving
        t.strip() for t in args.lora_towers.split(",") if t.strip()))
    targets = tuple(t.strip() for t in args.lora_targets.split(",") if t.strip())
    device = next(model.parameters()).device
    for i, tower in enumerate(towers):
        if tower not in ("visual", "text"):
            raise SystemExit(f"--lora-towers: unknown tower {tower!r}")
        module = getattr(model, tower)
        lora_init(module, args.lora_rank,
                  make_generator(args.seed + 17 + i, device),
                  alpha=args.lora_alpha, targets=targets)
        for k in [k for k in mask if k.startswith(tower + ".")]:
            del mask[k]
        mask.update({f"{tower}.{k}": v for k, v in lora_mask(module).items()})
    # the model's parameter order: the optimizer and the step walk it
    return {n: mask[n] for n, _ in model.named_parameters()}


def build_step(args: TrainArgs, model, cfg, mask, total_steps: int, mesh=None,
               partition: str = "ddp"):
    """(step, state): the optimizer and the step of the recipe's flags (over
    ``mesh``, the data-parallel one, or the FSDP one with
    ``partition="fsdp"``); the model's trainable parameters become fp32
    masters and its frozen matmul weights are cast to the compute dtype."""
    from vitlens_tpu_torch.factory import make_trainable_

    tx, mask = make_optimizer(
        model,
        OptimizerConfig(lr=args.lr, beta1=args.beta1, beta2=args.beta2,
                        eps=args.eps, weight_decay=args.wd,
                        grad_clip_norm=args.grad_clip_norm,
                        warmup=args.warmup, total_steps=total_steps,
                        schedule=args.lr_scheduler),
        mask,
    )
    make_trainable_(model, mask, _dtype(args))
    sc = StepConfig(
        n_tower=args.n_tower, align_to=args.align_to,
        # the video distill branch pairs with TriClipDistillTokenLoss
        # (reference create_loss keyed on exp_args, factory.py:750-851)
        contra_loss_type=("distill_token" if args.video_distill
                          else args.contra_loss_type),
        local_loss=args.local_loss,
        sim_thres=args.sim_thres, accum_freq=args.accum_freq,
        video_distill=args.video_distill,
        compute_dtype=_dtype(args),
        remat=(args.remat_policy if args.grad_checkpointing
               and args.remat_policy != "full" else args.grad_checkpointing),
        sync_bn=args.use_bn_sync and mesh is not None,
    )
    return (make_train_step(cfg, tx, mask, sc, mesh=mesh, partition=partition),
            init_train_state(model, tx))


def main(argv=None) -> int:
    """CLI entry point. Wraps the trainer so the process-global SIGTERM
    handler the preemption path installs is always restored — in-process
    callers (pytest, embedding apps) must not lose graceful-shutdown-by-
    SIGTERM after a train run returns."""
    import signal

    prev_sigterm = signal.getsignal(signal.SIGTERM)
    try:
        return _main(argv)
    finally:
        try:  # signal() is main-thread-only; elsewhere nothing was installed
            if signal.getsignal(signal.SIGTERM) is not prev_sigterm:
                signal.signal(signal.SIGTERM, prev_sigterm)
        except (ValueError, TypeError):
            pass


def _main(argv=None) -> int:
    import torch.distributed as dist

    from vitlens_tpu_torch.factory import cast_matmul_weights_, resolve_device
    from vitlens_tpu_torch.parallel import mesh as PM

    args = parse_args(argv)
    check_supported(args)
    # join the process group before anything touches the device (torchrun's
    # or SLURM's variables; a no-op for one process or a group already up)
    owns_group = not (dist.is_available() and dist.is_initialized())
    rank = PM.init_distributed(device=args.device)
    owns_group = owns_group and dist.is_initialized()
    try:
        return _train(args, rank, resolve_device, cast_matmul_weights_, PM)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _train(args: TrainArgs, rank: int, resolve_device, cast_matmul_weights_,
           PM) -> int:
    world = PM.process_count()
    check_supported(args, world)
    mesh = (PM.make_mesh(n_model=args.tp, device=args.device) if world > 1
            else None)
    # data-parallel replicas (the per-replica batch); under --tp world / tp
    n_data, data_rank = (mesh.data, mesh.rank) if mesh is not None else (1, 0)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    is_rank0 = rank == 0
    name = args.name or f"{args.modality}_{args.model}_{time.strftime('%Y%m%d_%H%M%S')}"
    if not args.name and world > 1:
        # the timestamp is each rank's own: agree on rank 0's, or the run
        # splits over several log and checkpoint directories
        name = PM.broadcast_object(name)
    log_dir = os.path.join(args.logs, name)
    # rank 0 owns out.log and params.txt (reference is_master gating); the
    # others log to their own file so that a shared directory never
    # interleaves
    setup_logging(os.path.join(log_dir, "out.log" if is_rank0
                               else f"out.rank{rank}.log"))
    if is_rank0:
        dump_params(log_dir, vars(args))

    cfg, tokenizer, model, mask = build_model(args, device)
    if mesh is not None:  # the same weights on every rank, rank 0's
        PM.replicate(mesh, model)
    log_param_census(model, mask)

    if args.visual_stat_flops:
        # flops-stat-and-exit smoke (reference --visual_stat_flops,
        # audio_tri_main.py:349-371 counts ptflops over model.visual)
        import json as _json

        from vitlens_tpu_torch.utils.flops import model_flops_report

        if args.modality == "image":
            hw = cfg.vision.image_size
            shape = (3, hw, hw)
        else:
            shape = _synthetic_spec(args, cfg)["visual"][0]
        rep = model_flops_report(model, torch.zeros((1,) + tuple(shape)))
        out = {"params_M": round(rep["params_total"] / 1e6, 2),
               "gflops_per_sample": round(rep["gflops_per_sample"], 2)}
        logging.info(f"visual tower stats: {out}")
        print(_json.dumps(out))
        return 0

    train_info = build_train_data(args, tokenizer, n_data, cfg,
                                  proc_id=data_rank, n_procs=n_data)
    if train_info is None:
        cast_matmul_weights_(model, _dtype(args))
        results = evaluate(args, model, cfg, tokenizer, mesh=mesh)
        flat = {(os.path.basename(k) if os.path.sep in k else k):
                _primary_metric({k: v}) for k, v in results.items()}
        flat.update(_flatten_results(results))
        if is_rank0:  # one appender to the shared results.jsonl
            MetricsWriter(log_dir).log(flat, 0, "val")
        return 0

    steps_per_epoch = train_info.num_batches
    # the sharded state's checkpoints are collective, every rank writing
    sharded = (args.fsdp or args.tp > 1) and mesh is not None
    step, ts = build_step(args, model, cfg, mask,
                          total_steps=steps_per_epoch * args.epochs, mesh=mesh,
                          partition="fsdp" if sharded else "ddp")

    ckpt_dir = os.path.join(log_dir, "checkpoints")
    start_epoch = 0
    resume_sharded = None
    if args.resume:
        path = (C.get_latest_checkpoint(ckpt_dir) if args.resume == "latest"
                else args.resume)
        if world > 1:  # every rank resumes from rank 0's choice
            path = PM.broadcast_object(path)
        if path and C.load_meta(path).get("sharded"):
            # a collective checkpoint restores onto the placed state
            resume_sharded = path
        elif path:
            ts = C.load_checkpoint(path, ts, ckpt_only=args.resume_ckpt_only)
            start_epoch = C.load_meta(path).get("epoch", 0)
            logging.info(f"resumed from {path} (epoch {start_epoch})")
    if sharded:
        from vitlens_tpu_torch.parallel.fsdp import fsdp_place, fsdp_tp_place

        ts = fsdp_tp_place(ts, mesh) if args.tp > 1 else fsdp_place(ts, mesh)
    if resume_sharded:
        ts = C.load_checkpoint_sharded(resume_sharded, ts,
                                       ckpt_only=args.resume_ckpt_only)
        start_epoch = C.load_meta(resume_sharded).get("epoch", 0)
        logging.info(f"resumed (sharded) from {resume_sharded} "
                     f"(epoch {start_epoch})")
    writer = (MetricsWriter(log_dir, use_tensorboard="tensorboard" in args.report_to)
              if is_rank0 else None)
    meter = ThroughputMeter(n_chips=world)
    saver = C.AsyncSaver() if is_rank0 and not sharded else None
    sync_stop = None
    if args.remote_sync and is_rank0:
        sync_stop = C.start_remote_sync(ckpt_dir, args.remote_sync,
                                        args.remote_sync_frequency)

    # preemption-safe training: on SIGTERM checkpoint at the next step
    # boundary and exit cleanly so --resume latest continues the run
    got_sigterm = {"flag": False}
    if args.preempt_sync_every > 0:
        import signal

        def _on_sigterm(signum, frame):
            got_sigterm["flag"] = True

        try:  # only valid in the main thread; no-op elsewhere
            signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:
            pass

    def preempt_agreed() -> bool:
        if world == 1:
            return got_sigterm["flag"]
        # the ranks may get SIGTERM at different steps (or only some of
        # them): agree, so that every rank stops at the same step or none
        return any(PM.all_gather_object(got_sigterm["flag"]))

    gen = torch.Generator(device=device).manual_seed(
        args.seed + (0 if sharded else rank))
    global_step = int(ts.step)
    trace = None
    preempted = False
    for epoch in range(start_epoch, args.epochs):
        train_info.set_epoch(epoch)
        if args.input_prefetch:
            # batch N+1's prep + H2D copy overlaps batch N's compute on a
            # staging thread (reference PrefetchLoader, training/data.py:42-107)
            from vitlens_tpu_torch.data.loader import DevicePrefetcher

            batches = DevicePrefetcher(
                train_info.dataloader, mesh=mesh,
                device=None if mesh is not None else device,
                map_fn=lambda raw: _prep_batch(raw, args, tokenizer))
        else:
            batches = (_prep_batch(raw, args, tokenizer)
                       for raw in train_info.dataloader)
        for batch in batches:
            if (args.profile_steps and global_step == 2 and trace is None
                    and is_rank0):
                # steady state: step 0 builds the kernels, step 1 warms caches
                trace = start_trace()
            ts, metrics = step(ts, batch, fps_generator=gen)
            global_step += 1
            if trace is not None and global_step == 2 + args.profile_steps:
                logging.info("profiler trace written to "
                             + stop_trace(trace, os.path.join(log_dir, "trace")))
                trace = None
            if global_step % args.log_every_n_steps == 0:
                sps, spsc = meter.tick_step(
                    args.batch_size * n_data * args.log_every_n_steps)
                m = {k: float(v) for k, v in metrics.items()}
                m.update({"samples_per_s": sps, "samples_per_s_chip": spsc,
                          "epoch": epoch})
                if is_rank0:
                    writer.log(m, global_step, "train")
                logging.info(
                    f"epoch {epoch} step {global_step}: "
                    + ", ".join(f"{k}={v:.4f}" for k, v in m.items()))
            # one process: the flag is free to read every step; several:
            # the agreement is a collective, every preempt_sync_every steps
            if (args.preempt_sync_every > 0
                    and (world == 1 or global_step % args.preempt_sync_every == 0)
                    and preempt_agreed()):
                logging.info(f"SIGTERM: checkpointing at step {global_step} "
                             f"(epoch {epoch} incomplete) and exiting")
                if sharded:  # COLLECTIVE: every rank writes its shards
                    C.save_checkpoint_sharded(
                        ckpt_dir, ts, epoch, is_latest=True,
                        extra={"preempt_step": global_step},
                        tag=f"preempt_step_{global_step}")
                elif is_rank0:
                    tag = f"preempt_step_{global_step}"
                    extra = {"preempt_step": global_step}
                    # meta epoch = completed epochs -> resume restarts this
                    # one; through the saver queue: an epoch-end save may be
                    # in flight
                    host = C.snapshot(ts)
                    saver.submit(lambda s=host, e=epoch:
                                 C.save_checkpoint(ckpt_dir, s, e, is_latest=True,
                                                   extra=extra, tag=tag))
                preempted = True
                break
        if preempted:
            break
        # end epoch: eval + ckpt; rank 0's host snapshot is synchronous (the
        # next step updates the parameters in place), the disk write happens
        # on the saver worker so the next epoch starts immediately
        host_ts = C.snapshot(ts) if is_rank0 and not sharded else None
        if args.val_data and (epoch + 1) % args.val_frequency == 0:
            results = evaluate(args, model, cfg, tokenizer, mesh=mesh)
            metric = _primary_metric(results)
            if is_rank0:
                writer.log({"primary": metric, **_flatten_results(results)},
                           global_step, "val")
            if sharded:  # COLLECTIVE: every rank enters it, or none
                C.save_best_sharded(ckpt_dir, ts, epoch + 1, metric)
            elif is_rank0:
                saver.submit(lambda s=host_ts, e=epoch + 1, m=metric:
                             C.save_best(ckpt_dir, s, e, m))
        if (epoch + 1) % args.save_frequency == 0 or args.save_most_recent:
            if sharded:  # COLLECTIVE and synchronous
                C.save_checkpoint_sharded(ckpt_dir, ts, epoch + 1,
                                          is_latest=args.save_most_recent)
            elif is_rank0:
                saver.submit(lambda s=host_ts, e=epoch + 1:
                             C.save_checkpoint(ckpt_dir, s, e,
                                               is_latest=args.save_most_recent))
    if trace is not None:  # --profile-steps exceeded the run length
        stop_trace(trace, os.path.join(log_dir, "trace"))
    if saver is not None:
        saver.close()  # drain pending writes; re-raises a failed save
    PM.barrier()  # rank 0's checkpoints are on disk before any rank goes on
    if sync_stop is not None:
        sync_stop.set()
    return 0


if __name__ == "__main__":
    sys.exit(main())
