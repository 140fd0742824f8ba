"""Linear-probe trainer (port of vitlens_tpu/cli/train_linprobe.py).

A frozen Lens backbone and a trainable head (models/linear_probe.py), LARS
on the head (or AdamW), per-epoch accuracy on the val split:

  python -m vitlens_tpu_torch.cli.train_linprobe --modality tactile \\
      --train-split train_rough --val-split test_rough \\
      --lp-ckpt /ckpt/vitlensL_tactile.pt --num-classes 2

The JAX CLI's flags, plus ``--device`` (default: the CUDA device; ``cpu``
runs on the host) and ``--log-every-n-steps`` (50, JAX's fixed period; each
logged step gives its host-timed seconds).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np
import torch

from vitlens_tpu_torch.config import make_model_config
from vitlens_tpu_torch.data.loader import build_loader
from vitlens_tpu_torch.models.linear_probe import (LinearProbe, lars_for_head,
                                                   softmax_cross_entropy_loss)
from vitlens_tpu_torch.train.schedules import get_schedule
from vitlens_tpu_torch.utils.logging import MetricsWriter, setup_logging


def build_args(argv=None):
    p = argparse.ArgumentParser("vitlens-tpu linear probe")
    p.add_argument("--model", default="ViT-L-14")
    p.add_argument("--force-image-size", type=int, default=None)
    p.add_argument("--modality", default="tactile")
    p.add_argument("--train-split", default=None)
    p.add_argument("--val-split", default=None)
    p.add_argument("--num-classes", type=int, required=True)
    p.add_argument("--lp-ckpt", default=None,
                   help="pretrain ckpt; loads the visual.* subtree")
    p.add_argument("--lp-enable-vit-proj", action="store_true")
    p.add_argument("--lp-dropout-rate", type=float, default=0.0)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--opt", default="lars", choices=["lars", "adamw"],
                   help="LARS is the reference linprobe optimizer")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--logs", default="./logs")
    p.add_argument("--name", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    p.add_argument("--log-every-n-steps", type=int, default=50)
    return p.parse_args(argv)


def _dataset(args, split, image_size):
    from vitlens_tpu_torch.data import datasets as D

    m = args.modality
    if m == "tactile":
        return D.TAGDataset(split=split, image_size=image_size)
    if m == "eeg":
        return D.EEGDataset(split=split, image_size=image_size)
    if m == "audio":
        return D.create_audio_datasets(split, train="train" in split)[0]
    if m == "depth":
        return D.create_rgbd_datasets(split, image_size=image_size)[0]
    if m == "pc":
        return D.ModelNetDataset(split="train" if "train" in split else "test")
    raise ValueError(m)


def load_backbone(model: LinearProbe, path: str) -> None:
    """The ``visual.*`` subtree of a reference-layout checkpoint (or the
    whole file) into the probe's backbone; its projection only where the
    probe keeps it."""
    from vitlens_tpu_torch.weights.from_jax import load_params, load_state
    from vitlens_tpu_torch.weights.torch_convert import (convert_vision_tower,
                                                         load_torch_checkpoint,
                                                         strip_prefixes, sub)

    sd = strip_prefixes(load_torch_checkpoint(path))
    vis_sd = sub(sd, "visual.") if any(k.startswith("visual.") for k in sd) else sd
    params, state = convert_vision_tower(vis_sd, model.backbone.cfg)
    if not model.enable_vit_proj:
        params.pop("proj")
    load_params(model.backbone, params)
    load_state(model.backbone, state)


def _inputs(raw, key, modality, device):
    x = torch.as_tensor(np.asarray(raw[key]), dtype=torch.float32)
    if modality == "audio" and x.dim() == 4:
        x = x[:, 0]
    return x.to(device)


def main(argv=None) -> int:
    from vitlens_tpu_torch.factory import (cast_matmul_weights_, make_generator,
                                           resolve_device)

    args = build_args(argv)
    device = resolve_device(args.device)
    name = args.name or f"lp_{args.modality}_{time.strftime('%Y%m%d_%H%M%S')}"
    log_dir = os.path.join(args.logs, name)
    setup_logging(os.path.join(log_dir, "out.log"))
    dt = torch.bfloat16 if args.precision == "bf16" else torch.float32

    cfg = make_model_config(args.model, args.modality,
                            force_image_size=args.force_image_size)
    model = LinearProbe(cfg.tower, args.num_classes,
                        enable_vit_proj=args.lp_enable_vit_proj, device=device)
    model.init_(make_generator(args.seed, device))
    if args.lp_ckpt:
        load_backbone(model, args.lp_ckpt)
        logging.info(f"loaded backbone from {args.lp_ckpt}")
    cast_matmul_weights_(model.backbone, dt)
    for p in model.lp_head.parameters():
        p.requires_grad_(True)

    hw = cfg.tower.arch.image_size
    train_ds = _dataset(args, args.train_split, hw)
    info = build_loader(train_ds, batch_size=args.batch_size, shuffle=True,
                        seed=args.seed, num_workers=args.workers)
    total_steps = info.num_batches * args.epochs
    sched = get_schedule("cosine", args.lr, args.warmup, total_steps)
    head = dict(model.lp_head.named_parameters())
    if args.opt == "lars":
        opt = lars_for_head(model, sched, args.wd)
    else:
        from vitlens_tpu_torch.train.step import AdamW, OptimizerConfig

        opt = AdamW(OptimizerConfig(lr=args.lr, beta1=0.9, beta2=0.999, eps=1e-8,
                                    weight_decay=args.wd, warmup=args.warmup,
                                    total_steps=total_steps),
                    {n: True for n in head}, {n: True for n in head})

    def step(x, y, gen):
        logits = model(x, dt, train=True, dropout_rate=args.lp_dropout_rate,
                       dropout_generator=gen)
        loss = softmax_cross_entropy_loss(logits, y)
        grads = torch.autograd.grad(loss, list(head.values()))
        if args.opt == "lars":
            opt.step(dict(zip(head, grads)))
        else:
            opt.update_(head, dict(zip(head, grads)), opt_state)
        return loss.detach()

    opt_state = None if args.opt == "lars" else opt.init(model.lp_head)
    vk = args.modality
    writer = MetricsWriter(log_dir)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.val_split:  # built once: dataset construction lists the files
        vinfo = build_loader(_dataset(args, args.val_split, hw),
                             batch_size=args.batch_size, shuffle=False,
                             drop_last=False, num_workers=args.workers)
    gstep = 0
    for epoch in range(args.epochs):
        info.set_epoch(epoch)
        for raw in info.dataloader:
            x = _inputs(raw, vk, args.modality, device)
            y = torch.as_tensor(np.asarray(raw["label"])).to(device)
            t0 = time.perf_counter()
            loss = step(x, y, gen)
            gstep += 1
            if gstep % args.log_every_n_steps == 0 or gstep == 1:
                logging.info(f"epoch {epoch} step {gstep}: loss "
                             f"{loss.item():.4f} ({time.perf_counter() - t0:.4f} s)")
        if args.val_split:
            correct = n = 0
            with torch.no_grad():
                for raw in vinfo.dataloader:
                    logits = model(_inputs(raw, vk, args.modality, device), dt)
                    pred = logits.argmax(-1).cpu().numpy()
                    correct += int((pred == np.asarray(raw["label"])).sum())
                    n += len(pred)
            acc = correct / max(n, 1)
            writer.log({"accuracy": acc}, gstep, "val")
            logging.info(f"epoch {epoch}: val acc {acc:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
