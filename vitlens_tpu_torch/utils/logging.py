"""Logging + observability (port of vitlens_tpu/utils/logging.py).

Mirrors the reference surface (training/logger.py:4-31 console+file logging;
train.py:27-44 AverageMeter and :251-307 samples/s + samples/s/chip logging;
train.py:865-867 results.jsonl; audio_main.py:323-343 trainable-param census
+ params.txt dump) with ``torch.profiler`` traces. Tensorboard/wandb
backends attach when their packages import; otherwise metrics still land in
results.jsonl.
"""

from __future__ import annotations

import json
import logging
import os
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional


def setup_logging(log_file: Optional[str] = None, level=logging.INFO,
                  include_host: bool = False) -> None:
    fmt = "%(asctime)s | %(levelname)s | %(message)s"
    if include_host:
        import socket

        fmt = f"%(asctime)s | {socket.gethostname()} | %(levelname)s | %(message)s"
    handlers = [logging.StreamHandler()]
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(level=level, format=fmt, handlers=handlers, force=True)


class AverageMeter:
    """Windowed average (reference train.py:27-44)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class ThroughputMeter:
    """samples/s and samples/s/chip (reference train.py:269-307)."""

    def __init__(self, n_chips: int = 1):
        self.n_chips = n_chips
        self.batch_time = AverageMeter()
        self.data_time = AverageMeter()
        self._last = time.time()

    def tick_data(self):
        now = time.time()
        self.data_time.update(now - self._last)
        self._last = now

    def tick_step(self, n_samples: int):
        now = time.time()
        dt = now - self._last
        self.batch_time.update(dt)
        self._last = now
        self.last_samples_per_s = n_samples / max(dt, 1e-9)
        self.last_samples_per_s_chip = self.last_samples_per_s / self.n_chips
        return self.last_samples_per_s, self.last_samples_per_s_chip


class MetricsWriter:
    """results.jsonl append + optional tensorboard/wandb fanout."""

    def __init__(self, log_dir: str, use_tensorboard: bool = False,
                 wandb_run=None):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, "results.jsonl")
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(log_dir)
            except Exception:
                logging.warning("tensorboard unavailable; jsonl only")
        self.wandb_run = wandb_run

    def log(self, metrics: Dict[str, Any], step: int, prefix: str = "train"):
        record = {"step": step,
                  **{f"{prefix}/{k}": _scalar(v) for k, v in metrics.items()}}
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(f"{prefix}/{k}", _scalar(v), step)
        if self.wandb_run is not None:
            self.wandb_run.log({f"{prefix}/{k}": _scalar(v)
                                for k, v in metrics.items()}, step=step)


def _scalar(v) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


def dump_params(log_dir: str, args: Dict[str, Any]) -> None:
    """params.txt dump (reference audio_main.py:330-343)."""
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "params.txt"), "w") as f:
        for k in sorted(args):
            f.write(f"{k}: {args[k]}\n")


def log_param_census(params, trainable_mask) -> Dict[str, int]:
    """Total vs trainable parameter counts (audio_main.py:323-329) of a
    module (or a {name: tensor} dict) under a {name: trainable} mask."""
    named = (dict(params.named_parameters()) if hasattr(params, "named_parameters")
             else dict(params))
    total = sum(p.numel() for p in named.values())
    trainable = sum(p.numel() for n, p in named.items() if trainable_mask.get(n))
    logging.info(f"params: total={total:,} trainable={trainable:,}")
    return {"total": total, "trainable": trainable}


def start_trace():
    """Start a ``torch.profiler`` trace of CPU and, where there is a card,
    CUDA activity; -> the profiler, for :func:`stop_trace`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def stop_trace(prof, log_dir: str) -> str:
    """Wait for the card, stop ``prof`` and export its Chrome trace as
    ``log_dir/trace.json``; -> that path."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


@contextmanager
def profile_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block, exported as a Chrome trace
    into ``log_dir`` (nothing without one)."""
    if not log_dir:
        yield
        return
    prof = start_trace()
    try:
        yield prof
    finally:
        stop_trace(prof, log_dir)
