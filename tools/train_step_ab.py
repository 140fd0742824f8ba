#!/usr/bin/env python3
"""Times the B64 audio train step of two checkouts of the repo on one card,
alternating, each run in its own process.

    python3 tools/train_step_ab.py PARENT_DIR CHANGE_DIR [--pairs 3]

Each process puts its directory first on ``sys.path``, builds the vitlensL
audio model of ``chip_smoke.py`` phase 4b with the published recipe (visual
and text towers locked, CLS unlocked, fp32 masters, frozen weights and
compute in bf16), takes two warm steps and times 12 steps at B64, each
ending in ``torch.cuda.synchronize()``. The order is parent, change,
change, parent, ... (``--pairs`` pairs). Prints the card's name and power
limit, then one JSON line per process: best and median samples/s, every
step's ms, the memory resident between steps. Each checkout builds its own
kernels at first use.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

B = 64


def run_one(root: str, label: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from vitlens_tpu_torch.factory import create_model, make_trainable_
    from vitlens_tpu_torch.train.freeze import tri_model_mask
    from vitlens_tpu_torch.train.step import (OptimizerConfig, StepConfig,
                                              init_train_state, make_optimizer,
                                              make_train_step)

    model = create_model("ViT-L-14", "audio", seed=0, device="cuda",
                         dtype=torch.float32)
    mask = tri_model_mask(model, model.cfg, lock_visual=True, lock_text=True,
                          unlock_cls=True)
    tx, mask = make_optimizer(model, OptimizerConfig(
        lr=1e-4, warmup=10, total_steps=1000, grad_clip_norm=1.0), mask)
    make_trainable_(model, mask, torch.bfloat16)
    state = init_train_state(model, tx)
    step = make_train_step(model.cfg, tx, mask, StepConfig(
        n_tower=2, align_to="text", compute_dtype=torch.bfloat16))
    rng = np.random.RandomState(0)
    text = rng.randint(1, 49000, size=(B, 77))
    text[:, 0], text[:, -1] = 49406, 49407
    a = model.cfg.tower.audio
    fb = rng.randn(B, a.target_length, a.mel_bins) * 0.5
    batch = {"text": torch.from_numpy(text).long().cuda(),
             "visual": torch.from_numpy(fb.astype(np.float32)).cuda()}
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(12):
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(json.dumps({
        "tree": label, "best_sps": B / min(times),
        "median_sps": B / float(np.median(times)),
        "ms": [round(t * 1e3, 2) for t in times],
        "resident_gb": torch.cuda.memory_allocated() / 1e9,
        "n_param_tensors": sum(1 for _ in model.parameters())}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--one", nargs=2, metavar=("DIR", "LABEL"),
                    help=argparse.SUPPRESS)  # the child process
    args = ap.parse_args()
    if args.one:
        run_one(*args.one)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    order = []
    for i in range(args.pairs):
        pair = [("parent", args.parent), ("change", args.change)]
        order += pair if i % 2 == 0 else pair[::-1]
    for label, root in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              args.parent, args.change, "--one", root, label],
                             timeout=600)
        if out.returncode:
            return out.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
