"""What the bench entry points share: arguments, inputs, timing, JSON rows."""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from vitlens_tpu_torch.factory import resolve_device


def parser(description: str, iters: int) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default=None,
                   help="default: the CUDA device; 'cpu' runs the plain versions")
    p.add_argument("--iters", type=int, default=iters,
                   help="launches per timed loop")
    p.add_argument("--seed", type=int, default=0)
    return p


def device_of(args) -> torch.device:
    return resolve_device(args.device)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def time_ms(fn, iters: int, device: torch.device, repeats: int = 3) -> float:
    """Best mean time of ``repeats`` loops of ``iters`` calls, in ms: CUDA
    events around each loop on the card, the host clock on the CPU."""
    fn()  # warm up (and build the kernels at first use)
    best = float("inf")
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            best = min(best, start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            best = min(best, (time.perf_counter() - t0) * 1e3 / iters)
    return best


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-6)).item()


def timing(ms: float, device: torch.device, **rates) -> dict:
    """The keys of a timed row: on the card the time and the rates derived
    from it; on the CPU only the host's time, under a name of its own, since
    no device metric comes from a CPU run."""
    if device.type == "cuda":
        return {"ms": ms, **rates}
    return {"host_ms": ms}


def emit(row: dict) -> dict:
    print(json.dumps(row), flush=True)
    return row


def mlp_inputs(rng: np.random.RandomState, m: int, d: int, hidden: int,
               device: torch.device):
    """x, lnw, lnb, w1, b1, w2, b2 with the prototypes' distributions (bf16
    activations and weights, fp32 LN parameters and biases)."""
    def t(a, dtype):
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype)

    bf, f32 = torch.bfloat16, torch.float32
    return (t(rng.randn(m, d) * 0.02, bf), t(rng.rand(d) + 0.5, f32),
            t(rng.randn(d) * 0.01, f32), t(rng.randn(d, hidden) * 0.02, bf),
            t(rng.randn(hidden) * 0.01, f32), t(rng.randn(hidden, d) * 0.02, bf),
            t(rng.randn(d) * 0.01, f32))
