"""OpenShape/vitlensG trainer (port of vitlens_tpu/cli/train_openshape.py).

Trains the bigG PNSA Lens (``train.openshape.CLIPBind``), or a comparison
baseline (``--pc-model PointBERT|DGCNN|PointNet``), against precomputed CLIP
text and image embeddings, on the card unless --device names another
device (``cpu``):

  python -m vitlens_tpu_torch.cli.train_openshape \\
      --train-files '/data/openshape/*.npy' --epochs 10 --batch-size 16 \\
      --eval-feats /data/mn40_text_feats.npy --eval-labels /data/mn40_labels.npy \\
      --eval-files '/data/mn40/*.npy'

Each epoch ends with a checkpoint (``{"params", "state"}``, no optimizer
state, ``meta.json`` ``epoch``; epoch_N and epoch_latest) and, with
--eval-feats/--eval-labels/--eval-files, cosine retrieval against the
per-class text embeddings. ``--resume latest|PATH`` loads the weights and
starts at the saved epoch; the optimizer and its schedule count restart at
0, as in JAX. Without --train-files the run is eval-only (``--resume`` then
names the checkpoint to evaluate). Every FPS start comes from one
``torch.Generator`` on the device, seeded with --seed + the rank.
``--use-mask`` with ``--negative-sample-num > 1`` raises, as in JAX.

Over N cards, one process a card (JAX shards its step over every device):
  python -m torch.distributed.run --nproc-per-node N \
      -m vitlens_tpu_torch.cli.train_openshape --train-files ... --batch-size 16
each rank loads its --batch-size objects of a global batch of --batch-size x
N, the contrastive loss gathers the features over the ranks, BatchNorm
syncs its moments and the gradients are averaged; rank 0 logs, evaluates
and writes the checkpoints.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import sys
import time
from dataclasses import replace

import numpy as np
import torch

from vitlens_tpu_torch.data.loader import DevicePrefetcher, build_loader
from vitlens_tpu_torch.train import checkpoint as C
from vitlens_tpu_torch.train import openshape as OS
from vitlens_tpu_torch.train.step import make_openshape_optimizer
from vitlens_tpu_torch.utils.logging import (MetricsWriter, ThroughputMeter,
                                             setup_logging)

BATCH_KEYS = ("xyz_features", "text_feat", "img_feat")


def build_args(argv=None):
    p = argparse.ArgumentParser("vitlens-tpu-torch openshape trainer")
    p.add_argument("--train-files", type=str, required=False, default=None,
                   help="glob of per-object npy triplet blobs")
    p.add_argument("--out-channel", type=int, default=1280)
    p.add_argument("--skip-first-n-layers", type=int, default=16)
    p.add_argument("--npoints", type=int, default=10000)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--trunk-lr-scale", type=float, default=0.1)
    p.add_argument("--warmup", type=int, default=1000)
    p.add_argument("--text-weight", type=float, default=1.0)
    p.add_argument("--image-weight", type=float, default=1.0)
    p.add_argument("--use-mask", action="store_true")
    p.add_argument("--mask-threshold", type=float, default=0.1)
    p.add_argument("--negative-sample-num", type=int, default=1)
    p.add_argument("--wd", type=float, default=0.2,
                   help="AdamW weight decay on tensors of rank >= 2 in the "
                        "JAX layout (the trunk's stacked blocks whole)")
    p.add_argument("--use-text-proj", action="store_true")
    p.add_argument("--use-image-proj", action="store_true")
    p.add_argument("--pc-model", default="clipbind",
                   choices=["clipbind", "PointBERT", "DGCNN", "PointNet"])
    p.add_argument("--pc-scaling", type=int, default=3)
    p.add_argument("--pc-in-channel", type=int, default=6)
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--logs", default="./logs")
    p.add_argument("--name", default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-feats", default=None,
                   help="npy of precomputed per-class text embeddings")
    p.add_argument("--eval-labels", default=None)
    p.add_argument("--eval-files", default=None)
    p.add_argument("--log-every-n-steps", type=int, default=50)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    p.add_argument("--tiny", action="store_true", help="tiny tower (tests)")
    return p.parse_args(argv)


def tower_config(args):
    if not args.tiny:
        return OS.vitlensG_tower_config(args.out_channel,
                                        args.skip_first_n_layers)
    from vitlens_tpu_torch.config import (PerceiverConfig, PointAdapterConfig,
                                          VisionArch)

    base = OS.vitlensG_tower_config(args.out_channel, 1)
    return replace(
        base,
        arch=VisionArch(image_size=28, patch_size=14, width=32, layers=2,
                        head_width=16),
        embed_dim=16, skip_first_n_layers=None,
        point=PointAdapterConfig(tokenizer="pnsa", num_group=8, group_size=4,
                                 encoder_dims=16, trans_dim=16, in_channel=6,
                                 npoints=args.npoints),
        perceiver=PerceiverConfig(depth=1, num_latents=4, latent_dim=32,
                                  input_dim=16, cross_heads=1,
                                  cross_dim_head=8, latent_heads=2,
                                  latent_dim_head=8),
    )


def build_model(args, tower, device) -> torch.nn.Module:
    """The bind of --pc-model on ``device``, fp32 masters drawn from a
    generator seeded with --seed."""
    if args.pc_model == "clipbind":
        model = OS.CLIPBind(tower, args.out_channel, device=device)
    else:
        model = OS.BaselineBind(args.pc_model, in_channel=args.pc_in_channel,
                                out_channel=args.out_channel,
                                scaling=args.pc_scaling, device=device)
    model.init_(torch.Generator(device=device).manual_seed(args.seed))
    return model


def build_optimizer(args, model, total_steps: int, mesh=None):
    """(tx, opt_state, step): JAX's chain of clip_by_global_norm(1.0) and
    adamw(cosine, --wd, the ndim >= 2 mask), with --trunk-lr-scale on
    CLIPBind's trunk; every parameter trains. Over ``mesh`` the step is the
    data-parallel one."""
    model.requires_grad_(True)
    lr_scale = (OS.trunk_lr_scale(model, args.trunk_lr_scale)
                if args.pc_model == "clipbind"
                else {n: 1.0 for n, _ in model.named_parameters()})
    tx = make_openshape_optimizer(
        model, lr=args.lr, warmup=args.warmup, total_steps=total_steps,
        weight_decay=args.wd, decay=OS.ndim_wd_mask(model), lr_scale=lr_scale)
    step = OS.make_openshape_step(
        tx, text_weight=args.text_weight, image_weight=args.image_weight,
        use_text_proj=args.use_text_proj, use_image_proj=args.use_image_proj,
        compute_dtype=_dtype(args), mesh=mesh)
    return tx, tx.init(model), step


def _dtype(args):
    return torch.bfloat16 if args.precision == "bf16" else torch.float32


def check_supported(args) -> None:
    """Raise on what neither package runs: the kNN-grouped sampler that
    --use-mask with k > 1 needs."""
    if args.use_mask and args.negative_sample_num > 1:
        raise NotImplementedError(
            "--use-mask with --negative-sample-num > 1 needs kNN-"
            "grouped batch sampling, which OpenShapeTripletDataset "
            "does not provide; the reference draws k neighbors per "
            "object from its kNN metadata")


def main(argv=None) -> int:
    import torch.distributed as dist

    from vitlens_tpu_torch.parallel import mesh as PM

    args = build_args(argv)
    owns_group = not (dist.is_available() and dist.is_initialized())
    rank = PM.init_distributed(device=args.device)
    owns_group = owns_group and dist.is_initialized()
    try:
        return _run(args, rank, PM)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _run(args, rank: int, PM) -> int:
    from vitlens_tpu_torch.factory import resolve_device

    world = PM.process_count()
    mesh = PM.make_mesh(device=args.device) if world > 1 else None
    device = mesh.device if mesh is not None else resolve_device(args.device)
    is_rank0 = rank == 0
    name = args.name or f"openshape_{time.strftime('%Y%m%d_%H%M%S')}"
    if not args.name and world > 1:
        name = PM.broadcast_object(name)
    log_dir = os.path.join(args.logs, name)
    setup_logging(os.path.join(log_dir, "out.log" if is_rank0
                               else f"out.rank{rank}.log"))

    tower = tower_config(args)
    model = build_model(args, tower, device)
    if mesh is not None:  # the same weights on every rank, rank 0's
        PM.replicate(mesh, model)
    files = sorted(glob.glob(args.train_files)) if args.train_files else []
    if not files:
        # eval-only mode (reference inference.py:77-230)
        if args.resume:
            C.load_checkpoint(args.resume, model)
            logging.info(f"loaded {args.resume}")
        if args.eval_feats and args.eval_files and args.eval_labels:
            if is_rank0:
                _run_eval(args, model, MetricsWriter(log_dir), 0)
            return 0
        logging.info("no training files and no eval spec; nothing to do")
        return 0
    check_supported(args)
    ckpt_dir = os.path.join(log_dir, "checkpoints")
    start_epoch = 0
    if args.resume:
        # the weights and BatchNorm statistics; the checkpoint holds no
        # optimizer state, so the optimizer and its schedule restart
        path = (C.get_latest_checkpoint(ckpt_dir) if args.resume == "latest"
                else args.resume)
        if world > 1:
            path = PM.broadcast_object(path)
        if path:
            C.load_checkpoint(path, model)
            start_epoch = int(C.load_meta(path).get("epoch", 0))
            logging.info(f"resumed openshape weights from {path} (epoch "
                         f"{start_epoch}); optimizer state restarts fresh")
        elif args.resume != "latest":
            raise FileNotFoundError(args.resume)
    ds = OS.OpenShapeTripletDataset(files, npoints=args.npoints, seed=args.seed)
    info = build_loader(ds, batch_size=args.batch_size, shuffle=True,
                        seed=args.seed, shard_id=rank, n_shards=world)
    tx, opt_state, step = build_optimizer(args, model,
                                          info.num_batches * args.epochs, mesh)
    if args.use_mask:
        logging.info("--use-mask with negative-sample-num=1 is a no-op "
                     "(reference mask_other = eye|~kron is all-ones at "
                     "k=1); continuing unmasked")

    writer = MetricsWriter(log_dir) if is_rank0 else None
    meter = ThroughputMeter(n_chips=world)
    gen = torch.Generator(device=device).manual_seed(args.seed + rank)
    gstep = start_epoch * info.num_batches
    for epoch in range(start_epoch, args.epochs):
        info.set_epoch(epoch)
        batches = DevicePrefetcher(
            info.dataloader, mesh=mesh,
            device=None if mesh is not None else device,
            map_fn=lambda raw: {k: raw[k] for k in BATCH_KEYS})
        for batch in batches:
            metrics = step(model, opt_state, batch, fps_generator=gen)
            gstep += 1
            if gstep % args.log_every_n_steps == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["samples_per_s"], _ = meter.tick_step(
                    args.batch_size * world * args.log_every_n_steps)
                if is_rank0:
                    writer.log(m, gstep)
                logging.info(f"epoch {epoch} step {gstep}: " + ", ".join(
                    f"{k}={v:.4f}" for k, v in m.items()))
        if is_rank0:
            C.save_checkpoint(ckpt_dir, C.snapshot(
                {"params": dict(model.named_parameters()),
                 "state": dict(model.named_buffers())}), epoch + 1)
            if args.eval_feats and args.eval_files and args.eval_labels:
                _run_eval(args, model, writer, gstep)
        PM.barrier()  # rank 0's checkpoint is on disk before any rank goes on
    return 0


@torch.no_grad()
def _run_eval(args, model, writer, gstep):
    cls_feats = np.load(args.eval_feats)
    labels = np.load(args.eval_labels)
    files = sorted(glob.glob(args.eval_files))
    ds = OS.OpenShapeTripletDataset(files, npoints=args.npoints, augment=False)
    info = build_loader(ds, batch_size=args.batch_size, shuffle=False,
                        drop_last=False)
    device = model.logit_scale.device
    preds = []
    for raw in info.dataloader:
        x = torch.as_tensor(np.asarray(raw["xyz_features"])).to(device)
        preds.append(model(x, _dtype(args)).float().cpu().numpy())
    out = OS.precomputed_text_eval(np.concatenate(preds), labels, cls_feats)
    writer.log(out, gstep, "val")
    logging.info("openshape eval: " + ", ".join(
        f"{k}={v:.4f}" for k, v in out.items()))
    return out


if __name__ == "__main__":
    sys.exit(main())
