"""Training CLI arguments (port of vitlens_tpu/cli/args.py: the same fields,
flags and validation, plus ``--device``).

One typed surface replacing the reference's ~170-flag argparse
(training/params.py:1-1013). Flags keep the reference names where they
exist so recipes translate 1:1; defaults follow params.py. The parallel
flags (``--fsdp``, ``--tp`` > 1, ``--n-devices`` > 1) and LoRA
(``--lora-rank`` > 0) parse as in JAX; the trainer raises on them, naming
their ROADMAP Queue 1 item.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field, fields
from typing import Optional


@dataclass
class TrainArgs:
    # model / tower
    model: str = "ViT-L-14"
    modality: str = "audio"          # pc | audio | depth | tactile | eeg | image
    pretrained: Optional[str] = None  # torch ckpt path (CLIP trunk)
    resume: Optional[str] = None      # 'latest' or path
    resume_ckpt_only: bool = False
    force_quick_gelu: bool = False
    force_image_size: Optional[int] = None
    # train-time PatchDropout prob on the Lens tower (reference
    # --force-patch-dropout, factory.py:228-230 + transformer.py:53-90)
    force_patch_dropout: Optional[float] = None

    # loss / towers (params.py --n_tower/--use_dual_loss/--contra_loss_type)
    n_tower: int = 3
    align_to: str = "image"           # dual-mode anchor
    contra_loss_type: str = "general"  # general | label_mask | sim_mask
    # video distill-tokens training (reference vid_distill_tokens branch):
    # frame-mean image anchor + token distillation into the video Lens
    video_distill: bool = False
    sim_thres: float = 0.9
    local_loss: bool = True
    gather_with_grad: bool = True

    # data
    train_data: Optional[str] = None
    val_data: Optional[str] = None
    dataset_type: str = "auto"        # auto | synthetic | csv
    csv_separator: str = "\t"         # params.py --csv-separator
    csv_img_key: str = "filepath"     # params.py --csv-img-key
    csv_caption_key: str = "title"    # params.py --csv-caption-key
    # image train-aug kwargs (params.py:402 --aug-cfg, e.g.
    # `--aug-cfg use_timm=True re_prob=0.25 color_jitter=0.4`)
    aug_cfg: dict = field(default_factory=dict)
    batch_size: int = 32              # per-chip
    workers: int = 4
    train_num_samples: Optional[int] = None

    # optimization (params.py defaults)
    lr: float = 5e-4
    beta1: float = 0.9
    beta2: float = 0.98
    eps: float = 1e-6
    wd: float = 0.2
    warmup: int = 10000
    epochs: int = 32
    lr_scheduler: str = "cosine"
    grad_clip_norm: Optional[float] = None
    accum_freq: int = 1
    precision: str = "bf16"           # bf16 | fp32 | pure_bf16
    grad_checkpointing: bool = False
    # print visual-tower params + FLOPs and exit (reference
    # --visual_stat_flops, audio_tri_main.py:349-371)
    visual_stat_flops: bool = False
    # remat variant when --grad-checkpointing is on: "full" recomputes the
    # whole block (least device memory), "dots" saves the 2-D products'
    # outputs and recomputes the rest (more memory, less recompute)
    remat_policy: str = "full"

    # locking (params.py --lock-image/--lock-text/--lock-visual + unlock-*)
    lock_image: bool = True
    lock_text: bool = True
    lock_visual: bool = True
    lock_visual_unlocked_groups: int = 0
    unlock_from_head: bool = False
    unlock_cls: bool = False
    unlock_pos_emb: bool = False
    unlock_trans_first_n_layers: Optional[int] = None
    skip_trans_first_n_layers: Optional[int] = None
    # LoRA on the Lens tower trunk (train/lora.py, beyond-reference):
    # rank>0 injects rank-r factors on the trunk matmuls and trains ONLY
    # them (overrides the visual lock flags for the trunk); alpha defaults
    # to rank (scale 1). Targets are dotted paths within one resblock.
    lora_rank: int = 0
    lora_alpha: Optional[float] = None
    lora_targets: str = "attn.qkv_w,attn.out_w,mlp.fc.w,mlp.proj.w"
    lora_towers: str = "visual"       # comma list of visual,text

    # bookkeeping
    logs: str = "./logs"
    name: Optional[str] = None
    save_frequency: int = 1
    save_most_recent: bool = True
    val_frequency: int = 1
    log_every_n_steps: int = 100
    seed: int = 0
    report_to: str = ""               # 'tensorboard' and/or 'wandb'
    # capture a torch.profiler trace of N steady-state train steps (written
    # to <log_dir>/trace/trace.json, a Chrome trace); 0 = off
    profile_steps: int = 0
    remote_sync: Optional[str] = None
    remote_sync_frequency: int = 300
    # preemption-safe training (preemptible machines): on SIGTERM the
    # trainer checkpoints at the next step boundary (tagged `preempt`,
    # mirrored to epoch_latest so --resume latest picks it up) and exits
    # cleanly. Single-process checks the flag every step (free); multi-host
    # ranks agree via all_gather every N steps (2 host round-trips — keep
    # off the hot path; preemption grace windows are 30 s+). 0 disables.
    # Beyond the reference (no equivalent).
    preempt_sync_every: int = 25

    # the torch device to train on (default: the CUDA device; "cpu" for the
    # host)
    device: Optional[str] = None

    # parallelism
    n_devices: Optional[int] = None   # default all
    # overlap host->device batch staging with compute (DevicePrefetcher,
    # the reference PrefetchLoader equivalent, training/data.py:42-107);
    # --no-input-prefetch restores synchronous per-step transfer
    input_prefetch: bool = True
    use_bn_sync: bool = True
    # FSDP/ZeRO: store params + Adam moments sharded over the data axis
    # (the JAX package's parallel/fsdp.py). DDP when off — the reference's
    # only mode.
    fsdp: bool = False
    # Megatron tensor parallelism over a model mesh axis of this size
    # (the JAX package's parallel/tp.py); devices split [data=N/tp,
    # model=tp].
    tp: int = 1

    # per-modality model hyperparameters (reference params.py:645-935
    # audio/pc/eeg/perceiver sections); None = keep the vitlensL preset.
    # audio tokenizer geometry (--audio_* in the reference; the published
    # L-2sec variant uses clip_duration 2.0 / target_length 204)
    audio_target_length: Optional[int] = None
    audio_mel_bins: Optional[int] = None
    audio_fstride: Optional[int] = None
    audio_tstride: Optional[int] = None
    audio_clip_duration: Optional[float] = None
    audio_sampling_rate: Optional[int] = None
    # audio train-time augmentation (--audio_freqm/timem/noise_aug/mix_up)
    audio_freqm: Optional[int] = None
    audio_timem: Optional[int] = None
    audio_noise_aug: Optional[bool] = None
    audio_mix_up: Optional[bool] = None
    # point-cloud tokenizer (--pc_* / --npoints)
    pc_tokenizer: Optional[str] = None   # pointbert | pnsa
    pc_npoints: Optional[int] = None
    pc_num_group: Optional[int] = None
    pc_group_size: Optional[int] = None
    pc_trans_dim: Optional[int] = None
    pc_encoder_dims: Optional[int] = None
    # EEG tokenizer
    eeg_chans: Optional[int] = None
    eeg_time_len: Optional[int] = None
    # video frame path (--vid_* in the reference, params.py vid group)
    vid_n_frames: Optional[int] = None   # --vid_num_frm
    vid_use_ltpos: Optional[bool] = None
    # video train-time RandAugment (reference lavis train processor,
    # vt_processors.py:756-772: VideoRandomAugment(n=2, m=5) after the
    # clip RandomResizedCrop+flip); --no-vid-rand-aug disables
    vid_rand_aug: bool = True
    vid_rand_aug_n: int = 2              # lavis_transform_conf "n"
    vid_rand_aug_m: float = 5.0          # lavis_transform_conf "m"
    # perceiver Lens (--perceiver_*)
    perceiver_depth: Optional[int] = None
    perceiver_input_dim: Optional[int] = None  # --perceiver_input_chan
    perceiver_num_latents: Optional[int] = None
    perceiver_latent_dim: Optional[int] = None
    perceiver_cross_heads: Optional[int] = None
    perceiver_latent_heads: Optional[int] = None
    perceiver_cross_dim_head: Optional[int] = None
    perceiver_latent_dim_head: Optional[int] = None
    perceiver_self_per_cross_attn: Optional[int] = None
    perceiver_as_identity: Optional[bool] = None
    perceiver_as_transformer: Optional[bool] = None


def _add_bool(p, name, default, help=""):
    dest = name.replace("-", "_")
    p.add_argument(f"--{name}", dest=dest, default=default,
                   action=argparse.BooleanOptionalAction, help=help)


class _ParseKwargs(argparse.Action):
    """`--aug-cfg k=v [k=v ...]` (reference params.py ParseKwargs)."""

    def __call__(self, parser, ns, values, option_string=None):
        import ast

        kw = {}
        for item in values:
            k, _, v = item.partition("=")
            try:
                v = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                pass  # keep as string
            kw[k.replace("-", "_")] = v
        setattr(ns, self.dest, kw)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("vitlens training (PyTorch port)")
    d = TrainArgs()
    for f in fields(TrainArgs):
        name = f.name.replace("_", "-")
        if f.name == "aug_cfg":
            p.add_argument("--aug-cfg", nargs="*", action=_ParseKwargs,
                           default={})
            continue
        if f.type == "bool" or isinstance(f.default, bool):
            _add_bool(p, name, f.default)
        else:
            typ = str
            if isinstance(f.default, int):
                typ = int
            elif isinstance(f.default, float):
                typ = float
            elif f.type in ("Optional[int]",):
                typ = int
            elif f.type in ("Optional[float]",):
                typ = float
            elif f.type in ("Optional[bool]",):
                typ = lambda s: s.lower() in ("1", "true", "yes")
            p.add_argument(f"--{name}", type=typ, default=f.default)
    return p


def parse_args(argv=None) -> TrainArgs:
    parser = build_parser()
    ns = parser.parse_args(argv)
    if ns.remat_policy not in ("full", "dots"):
        parser.error(f"--remat-policy must be 'full' or 'dots', "
                     f"got {ns.remat_policy!r}")
    return TrainArgs(**vars(ns))
