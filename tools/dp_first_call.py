#!/usr/bin/env python3
"""First call of the data-parallel phase on the card (chip_smoke.py phase
4dp), without the rest of chip_smoke.py:

    python3 tools/dp_first_call.py           # the first call
    python3 tools/dp_first_call.py --plant   # phase 4dp (b) against two faults

1. two ranks that both take cuda:0 under NCCL: prints what NCCL says (it
   refuses two ranks on one device);
2. two gloo ranks on cuda:0: all_gather, all_reduce and broadcast of CUDA
   tensors, results checked;
3. phase 4dp (a) on phase 4b's vitlensL audio recipe (a fresh state), (b)
   and (c), as chip_smoke.py runs them.

Exits non-zero when a check fails.

With ``--plant``, phase 4dp (b) runs twice, each time with a fault planted
in both rank processes (the step's functions replaced at run time; no file
changes): ``unsynced-bn`` (BatchNorm normalised over the rank's own rows)
and ``summed-grads`` (the gradients summed over the ranks, not averaged).
Exits 0 only when the phase fails under each fault.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def probe(kind: str) -> int:
    """A rank of the two-rank probes (torchrun's variables set)."""
    import torch
    import torch.distributed as dist

    env = os.environ
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    torch.cuda.set_device(0)
    dist.init_process_group(
        kind, init_method=f"tcp://127.0.0.1:{env['MASTER_PORT']}",
        world_size=world, rank=rank, timeout=datetime.timedelta(seconds=60))
    x = torch.full((4, 3), float(rank + 1), device="cuda")
    try:
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        y = x.clone()
        dist.all_reduce(y)
        z = x.clone()
        dist.broadcast(z, src=0)
        torch.cuda.synchronize()
        ok = (all(torch.equal(p, torch.full_like(x, i + 1.0))
                  for i, p in enumerate(parts))
              and torch.equal(y, torch.full_like(x, 3.0))
              and torch.equal(z, torch.full_like(x, 1.0)))
        print(f"{kind} rank {rank}: all_gather, all_reduce, broadcast of CUDA "
              f"tensors {'correct' if ok else 'WRONG'}", flush=True)
        return 0 if ok else 1
    except Exception as e:  # noqa: BLE001 - printed for the record
        print(f"{kind} rank {rank}: {type(e).__name__}: {str(e)[:600]}",
              flush=True)
        return 2
    finally:
        try:
            dist.destroy_process_group()
        except Exception:  # noqa: BLE001
            pass


def run_probe(kind: str):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    out = tempfile.mkdtemp(prefix=f"dp_probe_{kind}_")
    procs, logs = [], []
    for r in range(2):
        logs.append(os.path.join(out, f"rank{r}.log"))
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(r), MASTER_PORT=port)
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--probe", kind],
                stdout=f, stderr=subprocess.STDOUT, env=env))
    for p in procs:
        try:
            p.wait(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    for r, log in enumerate(logs):
        text = open(log).read().strip().splitlines()
        said = [ln for ln in text if ln.startswith(kind)] or text[-3:]
        print(f"[probe {kind}] rank {r} exit {procs[r].returncode}: "
              + " | ".join(said), flush=True)
    return [p.returncode for p in procs]


FAULTS = ("unsynced-bn", "summed-grads")


def plant_rank(fault: str, out_dir: str) -> int:
    """A rank of phase 4dp (b) with ``fault`` planted in the train step."""
    sys.path.insert(0, REPO)
    import chip_smoke as CS
    from vitlens_tpu_torch.train import step as S

    if fault == "unsynced-bn":
        synced = S.batch_norm_synced
        S.batch_norm_synced = lambda model, mesh: synced(model, None)
    elif fault == "summed-grads":
        average = S.average_gradients_

        def summed(grads, mesh):
            average(grads, mesh)
            for g in grads.values():
                g.mul_(mesh.data)
            return grads

        S.average_gradients_ = summed
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    return CS.dp_rank_main(out_dir)


def plant_main() -> int:
    """Phase 4dp (b) under each of FAULTS: 0 when every one fails it."""
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as CS
    from vitlens_tpu_torch.ops import _build

    t0 = time.time()
    _build.library()
    card = CS.card_line()
    print(f"{card} | torch {torch.__version__} cuda {torch.version.cuda}; "
          f"kernels built in {time.time() - t0:.1f} s", flush=True)
    passed = []
    for fault in FAULTS:
        t = time.time()
        try:
            CS.dp_ranks_phase(torch, dict.fromkeys(CS.COUNTED, 0), card,
                              rank_argv=[sys.executable, os.path.abspath(__file__),
                                         "--plant-rank", fault])
        except SystemExit as e:
            print(f"[plant {fault}] {card} | phase 4dp (b) failed, as it "
                  f"must ({time.time() - t:.1f} s): {e}", flush=True)
            continue
        passed.append(fault)
        print(f"[plant {fault}] {card} | phase 4dp (b) PASSED with the fault "
              f"planted", flush=True)
    print(f"[done] faults the phase let through: {passed or 'none'}; "
          f"{time.time() - t0:.1f} s", flush=True)
    return 1 if passed else 0


def main() -> int:
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as CS
    from vitlens_tpu_torch.ops import _build

    t0 = time.time()
    _build.library()
    card = CS.card_line()
    print(f"{card} | torch {torch.__version__} cuda {torch.version.cuda}; "
          f"kernels built in {time.time() - t0:.1f} s", flush=True)
    run_probe("nccl")
    if run_probe("gloo") != [0, 0]:
        CS.fail("gloo collectives on CUDA tensors")

    from vitlens_tpu_torch.factory import create_model, make_trainable_
    from vitlens_tpu_torch.train.freeze import tri_model_mask
    from vitlens_tpu_torch.train.step import (OptimizerConfig, StepConfig,
                                              init_train_state, make_optimizer)

    counters = CS.launch_counters()
    totals = dict.fromkeys(counters, 0)
    model = create_model("ViT-L-14", "audio", seed=CS.SEED, device="cuda",
                         dtype=torch.float32)
    mask = tri_model_mask(model, model.cfg, lock_visual=True, lock_text=True,
                          unlock_cls=True)
    tx, mask = make_optimizer(model, OptimizerConfig(
        lr=1e-4, warmup=10, total_steps=1000, grad_clip_norm=1.0), mask)
    make_trainable_(model, mask, torch.bfloat16)
    state = init_train_state(model, tx)
    acfg = model.cfg.tower
    rng = np.random.RandomState(CS.SEED)

    def batch(b):
        text = rng.randint(1, 49000, size=(b, 77))
        text[:, 0], text[:, -1] = 49406, 49407
        fb = rng.randn(b, acfg.audio.target_length, acfg.audio.mel_bins) * 0.5
        return {"text": torch.from_numpy(text).long(),
                "visual": torch.from_numpy(fb.astype(np.float32))}

    sc = StepConfig(n_tower=2, align_to="text", compute_dtype=torch.bfloat16)
    CS.dp_nccl_phase(torch, np, counters, totals, model, state, tx, mask, sc,
                     batch)
    del model, state
    CS.dp_ranks_phase(torch, totals, card)
    CS.dp_encode_phase(torch, np, counters, totals, card)
    print(f"[done] {card} | launches {totals}; {time.time() - t0:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--probe"]:
        sys.exit(probe(sys.argv[2]))
    if sys.argv[1:2] == ["--plant-rank"]:
        sys.exit(plant_rank(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--plant"]:
        sys.exit(plant_main())
    sys.exit(main())
