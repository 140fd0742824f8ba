#!/usr/bin/env python3
"""Drives the PyTorch port (vitlens_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line each; any failure exits non-zero:
  1. device: needs CUDA; prints the card's name and power limit (nvidia-smi).
  2. build: compiles the hand-written kernels from vitlens_tpu_torch/csrc/.
  3. kernels: each kernel against its plain PyTorch version on the card, in
     bf16, at the shapes of the main path (fused MLP <= 2.5e-2 relative,
     attention <= 1e-2 relative).
  4. slice: ViTLens("vitlensL", ("audio", "text")) at full ViT-L width with
     random weights from a seeded CUDA generator, bf16 compute, answers
     audio requests (B = 1, 4, 8, 3 clips each) and a text request. Checks
     shapes, finite values, unit norms, the kernels' launch counts (24 fused
     MLP and 32 attention launches per audio encode, 12 fused MLP per text
     encode) and agreement (cosine >= 0.99) of the B = 1 request with the same
     weights moved to the CPU in fp32, where the plain versions run.
  5. timing: each kernel against its plain version at the B64 slice shapes,
     and the audio encode rate at B64 (64 samples x 3 clips) in bf16, each
     beside the card's name and power limit, and a torch.profiler breakdown
     of one B64 audio encode with the device's busy and idle share.
The last two lines are the card's name and power limit, then
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

MLP_TOL = 2.5e-2   # bf16 rounding; the kernel keeps the act input in fp32
ATTN_TOL = 1e-2    # bf16 P in the P @ V product, fp32 everywhere else
COS_MIN = 0.99     # bf16 card path against the fp32 CPU plain path
SEED = 0


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-6)).item()


def cuda_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel, plain, iters: int = 20):
    """Mean kernel and plain times over the order plain, kernel, kernel,
    plain, so that drift over the window falls on both sides alike."""
    p1 = cuda_ms(plain, iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def mlp_inputs(torch, g, m, d, h):
    def r(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

    f32 = torch.float32
    return (r(m, d, std=0.5), 1.0 + r(d, std=0.1, dtype=f32),
            r(d, std=0.1, dtype=f32), r(d, h, std=d ** -0.5),
            r(h, std=0.1, dtype=f32), r(h, d, std=h ** -0.5),
            r(d, std=0.1, dtype=f32))


def qkv_inputs(torch, g, b, h, nq, nk):
    return tuple(torch.randn(b, h, n, 64, generator=g, device="cuda")
                 .to(torch.bfloat16) for n in (nq, nk, nk))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vitlens_tpu_torch.api import ViTLens
    from vitlens_tpu_torch.ops import _build
    from vitlens_tpu_torch.ops.attention import plain_attention
    from vitlens_tpu_torch.ops.flash_attention import (attention_reference,
                                                       flash_attention)
    from vitlens_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_reference

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1 device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | devices {torch.cuda.device_count()}",
          flush=True)

    t0 = time.time()
    _build.library()
    print(f"[2 build] kernels built and loaded in {time.time() - t0:.1f} s "
          f"({_build.BUILD_ROOT / _build.source_hash()})", flush=True)

    # -- 3: each kernel against its plain version on the card ---------------
    g = torch.Generator(device="cuda").manual_seed(SEED)
    abs_err = {"fused_mlp": 0.0, "flash_attention": 0.0}
    checks = []
    for m, d, h in ((6168, 1024, 4096), (616, 768, 3072), (1001, 1024, 4096)):
        for act in ("gelu", "quick_gelu"):
            a = mlp_inputs(torch, g, m, d, h)
            got = fused_mlp(*a, act=act)
            torch.cuda.synchronize()
            want = fused_mlp_reference(*a, act=act)
            err = rel_err(got, want)
            abs_err["fused_mlp"] = max(abs_err["fused_mlp"],
                                       (got.float() - want.float()).abs().max().item())
            checks.append(f"mlp{m}x{d}x{h}/{act}={err:.2e}")
            if not (torch.isfinite(got).all() and err <= MLP_TOL):
                fail(f"fused_mlp {m}x{d}x{h} {act}: rel err {err} > {MLP_TOL}")
    for b, h, nq, nk in ((12, 16, 257, 257), (12, 1, 256, 600),
                         (12, 16, 256, 256)):
        q, k, v = qkv_inputs(torch, g, b, h, nq, nk)
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        want = attention_reference(q, k, v)
        err = rel_err(got, want)
        abs_err["flash_attention"] = max(abs_err["flash_attention"],
                                         (got.float() - want.float()).abs().max().item())
        checks.append(f"attn{b}x{h}x{nq}x{nk}={err:.2e}")
        if not (torch.isfinite(got).all() and err <= ATTN_TOL):
            fail(f"flash_attention {b}x{h}x{nq}x{nk}: rel err {err} > {ATTN_TOL}")
    print(f"[3 kernels] all within bound (mlp <= {MLP_TOL}, attn <= {ATTN_TOL}"
          f" relative): {' '.join(checks)}", flush=True)

    # -- 4: the slice through the port's entry point ------------------------
    t0 = time.time()
    model = ViTLens("vitlensL", ("audio", "text"), device="cuda",
                    compute_dtype=torch.bfloat16, seed=SEED)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    tcfg = model.towers["audio"].cfg
    n_layers, n_text = tcfg.arch.layers, model.towers["text"].cfg.layers
    n_attn = n_layers + tcfg.perceiver.depth * (1 + tcfg.perceiver.self_per_cross_attn)
    captions = ["a dog barking in the distance", "rain on a tin roof",
                "an orchestra tuning up", "a car engine starting",
                "birds singing at dawn", "a crowd cheering in a stadium",
                "typing on a keyboard", "waves crashing on rocks"]
    fbanks = {b: torch.randn(b, 3, tcfg.audio.target_length, tcfg.audio.mel_bins,
                             generator=g, device="cuda") * 0.5
              for b in (1, 4, 8)}

    fused_mlp.launches = flash_attention.launches = 0
    outs = {}
    per_call = []
    for b, fb in fbanks.items():
        before = (fused_mlp.launches, flash_attention.launches)
        outs[b] = model.encode({"audio": fb}, preprocessed=True)["audio"]
        torch.cuda.synchronize()
        per_call.append(("audio", b, fused_mlp.launches - before[0],
                         flash_attention.launches - before[1]))
    before = (fused_mlp.launches, flash_attention.launches)
    text = model.encode({"text": captions})["text"]
    torch.cuda.synchronize()
    per_call.append(("text", len(captions), fused_mlp.launches - before[0],
                     flash_attention.launches - before[1]))
    launches = {"fused_mlp": fused_mlp.launches,
                "flash_attention": flash_attention.launches}

    for kind_, b, n_mlp, n_fa in per_call:
        want = (n_layers, n_attn) if kind_ == "audio" else (n_text, 0)
        if (n_mlp, n_fa) != want:
            fail(f"{kind_} B={b}: launches (mlp, attn) = {(n_mlp, n_fa)}, "
                 f"expected {want}")
    for name, emb, b in [*((f"audio B={b}", e, b) for b, e in outs.items()),
                         ("text", text, len(captions))]:
        if tuple(emb.shape) != (b, 768) or not torch.isfinite(emb).all():
            fail(f"{name}: shape {tuple(emb.shape)} or non-finite values")
        norm_err = (emb.float().norm(dim=-1) - 1).abs().max().item()
        if norm_err > 1e-3:
            fail(f"{name}: norms off 1 by {norm_err}")

    ref = copy.deepcopy(model).to(device="cpu", dtype=torch.float32)
    ref.compute_dtype = torch.float32
    want_a = ref.encode({"audio": fbanks[1].cpu()}, preprocessed=True)["audio"]
    want_t = ref.encode({"text": captions})["text"]
    cos_a = torch.nn.functional.cosine_similarity(
        outs[1].float().cpu(), want_a.float(), dim=-1).min().item()
    cos_t = torch.nn.functional.cosine_similarity(
        text.float().cpu(), want_t.float(), dim=-1).min().item()
    del ref
    if min(cos_a, cos_t) < COS_MIN:
        fail(f"card bf16 vs CPU fp32: min cosine audio {cos_a}, text {cos_t} "
             f"< {COS_MIN}")
    print(f"[4 slice] vitlensL audio+text built in {build_s:.1f} s; requests "
          f"{[(k, b) for k, b, _, _ in per_call]}; launches per call (mlp, "
          f"attn) {[(m, a) for _, _, m, a in per_call]}; main-path totals "
          f"{launches}; min cosine vs CPU fp32 plain path: audio {cos_a:.6f} "
          f"text {cos_t:.6f}", flush=True)

    # -- 5: timing at the B64 slice shapes -----------------------------------
    timings = {"fused_mlp": [], "flash_attention": []}
    B = 64
    n_rows = B * 3
    for label, (m, d, h) in (("trunk", (257 * n_rows, 1024, 4096)),
                             ("text", (77 * B, 768, 3072))):
        a = mlp_inputs(torch, g, m, d, h)
        k_ms, p_ms = paired_ms(lambda: fused_mlp(*a), lambda: fused_mlp_reference(*a))
        timings["fused_mlp"].append(
            {"shape": f"{label} M={m} D={d} H={h}", "ms": k_ms, "plain_ms": p_ms,
             "tflops": 4 * m * d * h / k_ms / 1e9})
        del a
    for label, (b, h, nq, nk) in (("trunk", (n_rows, 16, 257, 257)),
                                  ("lens cross", (n_rows, 1, 256, 600)),
                                  ("lens self", (n_rows, 16, 256, 256))):
        q, k, v = qkv_inputs(torch, g, b, h, nq, nk)
        scale = 64 ** -0.5
        k_ms, p_ms = paired_ms(lambda: flash_attention(q, k, v),
                               lambda: attention_reference(q, k, v))
        bf16_ms = cuda_ms(lambda: plain_attention(q, k, v, None, scale))
        timings["flash_attention"].append(
            {"shape": f"{label} [{b},{h},{nq},{nk},64]", "ms": k_ms,
             "plain_ms": p_ms, "plain_bf16_ms": bf16_ms})
        del q, k, v
    for name, rows in timings.items():
        for r in rows:
            print(f"[5 timing] {card} | {name} {r['shape']}: kernel "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
                  + (f", plain bf16 {r['plain_bf16_ms']:.4f} ms"
                     if "plain_bf16_ms" in r else "")
                  + (f", kernel {r['tflops']:.1f} TFLOP/s" if "tflops" in r else ""),
                  flush=True)

    fb64 = torch.randn(B, 3, tcfg.audio.target_length, tcfg.audio.mel_bins,
                       generator=g, device="cuda") * 0.5
    model.encode({"audio": fb64}, preprocessed=True)
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        emb = model.encode({"audio": fb64}, preprocessed=True)["audio"]
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    if tuple(emb.shape) != (B, 768) or not torch.isfinite(emb).all():
        fail("B64 encode: bad output")
    best = min(runs)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[5 timing] {card} | audio encode B{B} x 3 clips bf16: "
          f"{B / best:.2f} samples/s ({n_rows / best:.2f} clips/s), best of "
          f"{len(runs)}: {best * 1e3:.2f} ms, all ms "
          f"{[round(r * 1e3, 2) for r in runs]}; peak allocated {peak_gb:.2f} GB",
          flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.encode({"audio": fb64}, preprocessed=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in table
                  if e.device_type == DeviceType.CUDA) / 1e3
    print(table.table(sort_by="self_cuda_time_total", row_limit=30), flush=True)
    print(f"[5 profile] {card} | B{B} encode under the profiler: device busy "
          f"{busy_ms:.2f} ms of {wall_ms:.2f} ms wall (idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f})", flush=True)

    kernels = [
        {"name": "fused_mlp", "route": "cuda",
         "source": "vitlens_tpu_torch/csrc/fused_mlp.cu",
         "replaces": "vitlens_tpu/ops/fused_mlp.py:105",
         "launches": launches["fused_mlp"],
         "max_abs_err": abs_err["fused_mlp"],
         "ms": timings["fused_mlp"][0]["ms"],
         "plain_ms": timings["fused_mlp"][0]["plain_ms"],
         "shapes": timings["fused_mlp"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "vitlens_tpu_torch/csrc/flash_attention.cu",
         "replaces": "vitlens_tpu/ops/flash_attention.py:53",
         "launches": launches["flash_attention"],
         "max_abs_err": abs_err["flash_attention"],
         "ms": timings["flash_attention"][0]["ms"],
         "plain_ms": timings["flash_attention"][0]["plain_ms"],
         "shapes": timings["flash_attention"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
