#!/usr/bin/env python3
"""Drives the PyTorch port (vitlens_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line each (or more); any failure exits non-zero:
  1. device: needs CUDA; prints the card's name and power limit (nvidia-smi).
  2. build: compiles the hand-written kernels from vitlens_tpu_torch/csrc/
     (one nvcc per source, in parallel).
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes of the main paths: fused MLP (bf16, <= 2.5e-2 relative),
     attention (bf16, <= 1e-2 relative), FPS (index-exact, at B64/N 8192 with
     zero starts and B8/N 10000 with random starts) and the point encoder
     (bf16, <= 2e-2 relative).
  4. slice: ViTLens("vitlensL", ("audio", "pc", "text")) at full ViT-L width
     and depth with random weights from a seeded CUDA generator, bf16
     compute, answers audio requests (B = 1, 4, 8, 3 clips each), point-cloud
     requests (B = 1, 4, 8 clouds of 8192 points, and one raw request of 2
     clouds of 9000 points through the host processor) and a text request.
     Every launch count is set to 0 just before each request and read just
     after it; checks shapes, finite values, unit norms, the launches per
     request (audio: 24 fused MLP + 32 attention; pc: 24 fused MLP + 32
     attention + 1 FPS + 1 point encoder; text: 12 fused MLP) and agreement
     (cosine >= 0.99) of the B = 1 audio and pc requests and the text request
     with the same weights moved to the CPU in fp32, where the plain versions
     run. The pc clouds are rounded through bf16 first, so that both runs give
     FPS the same coordinates; their FPS indices must be equal.
  5. timing: each kernel against its plain version (and, where one PyTorch
     call computes the same function, that call) at the B64 shapes of the
     main paths, beside each kernel's bound; the audio (64 samples x 3 clips)
     and pc (64 clouds) encode rates at B64 in bf16; a torch.profiler
     breakdown of one B64 audio and one B64 pc encode with the device's busy
     and idle share. Every time is printed beside the card's name and power
     limit.
The last lines are {"kernels": [...]}, the card's name and power limit, then
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
ENC_TOL = 2e-2     # bf16 rounding; rounding points that differ by one ulp
COS_MIN = 0.99     # bf16 card path against the fp32 CPU plain path
SEED = 0
B = 64             # the benchmark batch of both encode paths

# One NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet, dense rates).
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12


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


def abs_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


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


def paired_ms(kernel, plain, iters: int = 20, plain_iters: int = 20):
    """Mean kernel and plain times over the order plain, kernel, kernel,
    plain, so that drift over the window falls on both sides alike."""
    p1 = cuda_ms(plain, plain_iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, plain_iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(ops: float, nbytes: float, peak: float):
    """The least time (ms) the card could take: the larger of the operations
    over the peak rate and the bytes (each input read once, each output
    written once) over the memory rate; and which of the two it is."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def mlp_bound(m, d, h):  # x, out, W1, W2 bf16; LN params and biases fp32
    return bound(4 * m * d * h, 2 * (2 * m * d + 2 * d * h) + 4 * (3 * d + h),
                 PEAK_BF16)


def attn_bound(b, h, nq, nk, dh=64):  # q, k, v, out bf16
    return bound(4 * b * h * nq * nk * dh, 2 * b * h * dh * (2 * nq + 2 * nk),
                 PEAK_BF16)


def fps_bound(b, n, npoint):
    # per step and point: 3 sub, 3 mul, 2 add, min, compare (fp32 cores)
    return bound(10 * b * n * npoint, 12 * b * n + 4 * b + 4 * b * npoint,
                 PEAK_FP32)


def enc_bound(bg, m, c1, c2, c3, c4):
    ops = (2 * bg * m * (3 * c1 + c1 * c2 + c2 * c3 + c3 * c4)
           + 2 * bg * c2 * c3)
    nbytes = (2 * bg * m * 3 + 2 * bg * c4
              + 2 * (3 * c1 + c1 * c2 + 2 * c2 * c3 + c3 * c4)
              + 4 * (4 * c1 + c2 + 4 * c3 + c4))
    return bound(ops, nbytes, PEAK_BF16)


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


ENC_WIDTHS = (128, 256, 512, 256)  # the PointBERT encoder's C1..C4


def enc_inputs(torch, g, bg_shape, m):
    """Group points [..., M, 3] bf16 and encoder weights with nontrivial BN
    statistics, in the wrapper's argument order."""
    c1, c2, c3, c4 = ENC_WIDTHS

    def r(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    def bn(n):
        return (r(n, std=0.2), 0.5 + r(n).abs(), 1.0 + r(n, std=0.2),
                r(n, std=0.1))

    nb = r(*bg_shape, m, 3, std=0.1).bfloat16()
    return (nb, r(3, c1, std=0.5).bfloat16(), r(c1, std=0.1), bn(c1),
            r(c1, c2, std=c1 ** -0.5).bfloat16(), r(c2, std=0.1),
            r(2 * c2, c3, std=(2 * c2) ** -0.5).bfloat16(), r(c3, std=0.1),
            bn(c3), r(c3, c4, std=c3 ** -0.5).bfloat16(), r(c4, std=0.1))


def profile_encode(torch, card, label, encode):
    """One encode under torch.profiler: the kernel table and the device's
    busy and idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        encode()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in table
                  if e.device_type == DeviceType.CUDA) / 1e3
    print(table.table(sort_by="self_cuda_time_total", row_limit=30), flush=True)
    print(f"[5 profile] {card} | {label} under the profiler: device busy "
          f"{busy_ms:.2f} ms of {wall_ms:.2f} ms wall (idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f})", flush=True)


def encode_rate(torch, card, label, encode, samples, rows_note=""):
    encode()
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        emb = encode()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    if tuple(emb.shape) != (samples, 768) or not torch.isfinite(emb).all():
        fail(f"{label}: bad output")
    best = min(runs)
    print(f"[5 timing] {card} | {label}: {samples / best:.2f} samples/s"
          f"{rows_note}, best of {len(runs)}: {best * 1e3:.2f} ms, all ms "
          f"{[round(r * 1e3, 2) for r in runs]}; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return samples / best


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.time()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from vitlens_tpu_torch.api import ViTLens
    from vitlens_tpu_torch.ops import _build
    from vitlens_tpu_torch.ops.attention import plain_attention
    from vitlens_tpu_torch.ops.flash_attention import (attention_reference,
                                                       flash_attention)
    from vitlens_tpu_torch.ops.fps import fps_indices, fps_indices_reference
    from vitlens_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_reference
    from vitlens_tpu_torch.ops.fused_point_encoder import (
        fused_point_encoder, point_encoder_reference)

    kernels = {"fused_mlp": fused_mlp, "flash_attention": flash_attention,
               "fps": fps_indices, "point_encoder": fused_point_encoder}
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
    err = {name: 0.0 for name in kernels}
    checks = []
    for m, d, h in ((6168, 1024, 4096), (616, 768, 3072), (1001, 1024, 4096)):
        for act in ("gelu", "quick_gelu"):
            a = mlp_inputs(torch, g, m, d, h)
            got = fused_mlp(*a, act=act)
            torch.cuda.synchronize()
            want = fused_mlp_reference(*a, act=act)
            e = rel_err(got, want)
            err["fused_mlp"] = max(err["fused_mlp"], abs_err(got, want))
            checks.append(f"mlp{m}x{d}x{h}/{act}={e:.2e}")
            if not (torch.isfinite(got).all() and e <= MLP_TOL):
                fail(f"fused_mlp {m}x{d}x{h} {act}: rel err {e} > {MLP_TOL}")
    for b, h, nq, nk in ((12, 16, 257, 257), (12, 1, 256, 600),
                         (12, 16, 256, 256), (8, 1, 256, 512)):
        q, k, v = qkv_inputs(torch, g, b, h, nq, nk)
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        want = attention_reference(q, k, v)
        e = rel_err(got, want)
        err["flash_attention"] = max(err["flash_attention"], abs_err(got, want))
        checks.append(f"attn{b}x{h}x{nq}x{nk}={e:.2e}")
        if not (torch.isfinite(got).all() and e <= ATTN_TOL):
            fail(f"flash_attention {b}x{h}x{nq}x{nk}: rel err {e} > {ATTN_TOL}")
    fps_inputs = {}
    for b, n, starts in ((B, 8192, "zero"), (8, 10000, "random")):
        xyz = torch.randn(b, n, 3, generator=g, device="cuda") * 0.3
        if starts == "zero":
            start = torch.zeros(b, dtype=torch.int32, device="cuda")
        else:
            start = torch.randint(0, n, (b,), generator=g, device="cuda",
                                  dtype=torch.int32)
        fps_inputs[(b, n)] = (xyz, start)
        got = fps_indices(xyz, 512, start)
        torch.cuda.synchronize()
        want = fps_indices_reference(xyz, 512, start)
        n_diff = (got != want).sum().item()
        err["fps"] = max(err["fps"], abs_err(got, want))
        checks.append(f"fps{b}x{n}/{starts}:{n_diff}-differ")
        if n_diff:
            fail(f"fps_indices B{b} N{n} {starts} starts: {n_diff} indices "
                 "differ from the plain version")
    enc_args = enc_inputs(torch, g, (B, 512), 32)
    got = fused_point_encoder(*enc_args)
    torch.cuda.synchronize()
    want = point_encoder_reference(*enc_args)
    e = rel_err(got, want)
    err["point_encoder"] = abs_err(got, want)
    checks.append(f"enc{B}x512x32={e:.2e}")
    if not (torch.isfinite(got).all() and e <= ENC_TOL):
        fail(f"fused_point_encoder: rel err {e} > {ENC_TOL}")
    print(f"[3 kernels] all within bound (mlp <= {MLP_TOL}, attn <= {ATTN_TOL}, "
          f"encoder <= {ENC_TOL} relative, fps index-exact): {' '.join(checks)}",
          flush=True)

    # -- 4: the slices through the port's entry point -----------------------
    t0 = time.time()
    model = ViTLens("vitlensL", ("audio", "pc", "text"), device="cuda",
                    compute_dtype=torch.bfloat16, seed=SEED)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    acfg, pcfg = model.towers["audio"].cfg, model.towers["pc"].cfg
    n_layers, n_text = acfg.arch.layers, model.towers["text"].cfg.layers

    def n_attn(cfg):
        return cfg.arch.layers + cfg.perceiver.depth * (
            1 + cfg.perceiver.self_per_cross_attn)

    want_launches = {"audio": (n_layers, n_attn(acfg), 0, 0),
                     "pc": (n_layers, n_attn(pcfg), 1, 1),
                     "text": (n_text, 0, 0, 0)}
    captions = ["a dog barking in the distance", "rain on a tin roof",
                "an orchestra tuning up", "a car engine starting",
                "birds singing at dawn", "a crowd cheering in a stadium",
                "typing on a keyboard", "waves crashing on rocks"]
    fbanks = {b: torch.randn(b, 3, acfg.audio.target_length, acfg.audio.mel_bins,
                             generator=g, device="cuda") * 0.5
              for b in (1, 4, 8)}
    npts = pcfg.point.npoints
    # rounded through bf16 once, so the fp32 CPU run sees what the card sees
    clouds = {b: (torch.randn(b, npts, 3, generator=g, device="cuda") * 0.3)
              .bfloat16().float() for b in (1, 4, 8)}
    rng = np.random.RandomState(SEED)
    raw = [(rng.randn(9000, 3) * 0.3).astype(np.float32) for _ in range(2)]

    requests = [*(("audio", b, {"audio": fb}, True) for b, fb in fbanks.items()),
                *(("pc", b, {"pc": c}, True) for b, c in clouds.items()),
                ("pc", len(raw), {"pc": raw}, False),
                ("text", len(captions), {"text": captions}, False)]
    launches = dict.fromkeys(kernels, 0)
    outs, per_call = [], []
    for path, b, inputs, pre in requests:
        for fn in kernels.values():
            fn.launches = 0
        emb = model.encode(inputs, preprocessed=pre)[path]
        torch.cuda.synchronize()
        counts = tuple(fn.launches for fn in kernels.values())
        for name, n in zip(kernels, counts):
            launches[name] += n
        per_call.append((path, b, counts))
        outs.append((path, b, pre, emb))
        if counts != want_launches[path]:
            fail(f"{path} B={b}: launches (mlp, attn, fps, encoder) = "
                 f"{counts}, expected {want_launches[path]}")
    for path, b, pre, emb in outs:
        if tuple(emb.shape) != (b, 768) or not torch.isfinite(emb).all():
            fail(f"{path} B={b}: shape {tuple(emb.shape)} or non-finite values")
        norm_err = (emb.float().norm(dim=-1) - 1).abs().max().item()
        if norm_err > 1e-3:
            fail(f"{path} B={b}: norms off 1 by {norm_err}")

    ref = copy.deepcopy(model).to(device="cpu", dtype=torch.float32)
    ref.compute_dtype = torch.float32
    card_emb = {path: emb for path, b, pre, emb in outs if b == 1 or path == "text"}
    want = {"audio": ref.encode({"audio": fbanks[1].cpu()}, preprocessed=True),
            "pc": ref.encode({"pc": clouds[1].cpu()}, preprocessed=True),
            "text": ref.encode({"text": captions})}
    cos = {path: torch.nn.functional.cosine_similarity(
        card_emb[path].float().cpu(), want[path][path].float(), dim=-1).min().item()
        for path in want}
    del ref
    n_group = pcfg.point.num_group
    idx_card = fps_indices(clouds[1].bfloat16(), n_group).cpu()
    idx_cpu = fps_indices(clouds[1].cpu(), n_group)
    if not torch.equal(idx_card, idx_cpu):
        fail(f"pc B=1: {(idx_card != idx_cpu).sum().item()} FPS indices of "
             "the card run differ from the CPU run's")
    if min(cos.values()) < COS_MIN:
        fail(f"card bf16 vs CPU fp32: min cosine {cos} < {COS_MIN}")
    print(f"[4 slice] vitlensL audio+pc+text built in {build_s:.1f} s; requests "
          f"(path, B, launches (mlp, attn, fps, encoder)) {per_call}; "
          f"main-path totals {launches}; min cosine vs CPU fp32 plain path: "
          + " ".join(f"{k} {v:.6f}" for k, v in cos.items())
          + f"; pc B=1 FPS indices equal on card and CPU ({n_group} centers)",
          flush=True)

    # -- 5: timing at the B64 shapes -----------------------------------------
    timings = {name: [] for name in kernels}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, (m, d, h) in (("audio trunk", (257 * B * 3, 1024, 4096)),
                             ("pc trunk", (257 * B, 1024, 4096)),
                             ("text", (77 * B, 768, 3072))):
        a = mlp_inputs(torch, g, m, d, h)
        k_ms, p_ms = paired_ms(lambda: fused_mlp(*a), lambda: fused_mlp_reference(*a))
        bd, by = mlp_bound(m, d, h)
        timings["fused_mlp"].append(
            {"shape": f"{label} M={m} D={d} H={h}", "ms": k_ms, "plain_ms": p_ms,
             "bound_ms": bd, "bound_by": by, "library_ms": None,
             "tflops": 4 * m * d * h / k_ms / 1e9})
        del a
    for label, (b, h, nq, nk) in (("audio trunk", (B * 3, 16, 257, 257)),
                                  ("audio lens cross", (B * 3, 1, 256, 600)),
                                  ("audio lens self", (B * 3, 16, 256, 256)),
                                  ("pc lens cross", (B, 1, 256, 512))):
        q, k, v = qkv_inputs(torch, g, b, h, nq, nk)
        k_ms, p_ms = paired_ms(lambda: flash_attention(q, k, v),
                               lambda: attention_reference(q, k, v))
        bf16_ms = cuda_ms(lambda: plain_attention(q, k, v, None, 64 ** -0.5))
        lib_ms = cuda_ms(lambda: sdpa(q, k, v))
        bd, by = attn_bound(b, h, nq, nk)
        timings["flash_attention"].append(
            {"shape": f"{label} [{b},{h},{nq},{nk},64]", "ms": k_ms,
             "plain_ms": p_ms, "plain_bf16_ms": bf16_ms, "bound_ms": bd,
             "bound_by": by, "library_ms": lib_ms})
        del q, k, v
    xyz, start = fps_inputs[(B, 8192)]
    k_ms, p_ms = paired_ms(lambda: fps_indices(xyz, 512, start),
                           lambda: fps_indices_reference(xyz, 512, start),
                           plain_iters=3)
    bd, by = fps_bound(B, 8192, 512)
    timings["fps"].append({"shape": f"B{B} N8192 npoint512", "ms": k_ms,
                           "plain_ms": p_ms, "bound_ms": bd, "bound_by": by,
                           "library_ms": None})
    k_ms, p_ms = paired_ms(lambda: fused_point_encoder(*enc_args),
                           lambda: point_encoder_reference(*enc_args),
                           plain_iters=5)
    bd, by = enc_bound(B * 512, 32, *ENC_WIDTHS)
    timings["point_encoder"].append(
        {"shape": f"[{B},512,32,3] -> [{B},512,256]", "ms": k_ms,
         "plain_ms": p_ms, "bound_ms": bd, "bound_by": by, "library_ms": None})
    del enc_args, fps_inputs
    for name, rows in timings.items():
        for r in rows:
            print(f"[5 timing] {card} | {name} {r['shape']}: kernel "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
                  + (f", plain bf16 {r['plain_bf16_ms']:.4f} ms"
                     if "plain_bf16_ms" in r else "")
                  + (f", library {r['library_ms']:.4f} ms"
                     if r["library_ms"] is not None else "")
                  + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
                  + (f", kernel {r['tflops']:.1f} TFLOP/s" if "tflops" in r else ""),
                  flush=True)

    fb64 = torch.randn(B, 3, acfg.audio.target_length, acfg.audio.mel_bins,
                       generator=g, device="cuda") * 0.5
    pc64 = torch.randn(B, npts, 3, generator=g, device="cuda") * 0.3

    def audio64():
        return model.encode({"audio": fb64}, preprocessed=True)["audio"]

    def pc64_encode():
        return model.encode({"pc": pc64}, preprocessed=True)["pc"]

    encode_rate(torch, card, f"audio encode B{B} x 3 clips bf16", audio64, B,
                rows_note=f" ({B * 3} clips per call)")
    pc_rate = encode_rate(torch, card, f"pc encode B{B} x {npts} points bf16",
                          pc64_encode, B)
    profile_encode(torch, card, f"B{B} audio encode", audio64)
    profile_encode(torch, card, f"B{B} pc encode", pc64_encode)

    replaces = {
        "fused_mlp": "vitlens_tpu/ops/fused_mlp.py:105",
        "flash_attention": "vitlens_tpu/ops/flash_attention.py:53",
        "fps": "vitlens_tpu/ops/fps.py:120, vitlens_tpu/ops/fps.py:175",
        "point_encoder": "vitlens_tpu/ops/fused_point_encoder.py:116"}
    sources = {"fused_mlp": "fused_mlp.cu", "flash_attention": "flash_attention.cu",
               "fps": "fps.cu", "point_encoder": "fused_point_encoder.cu"}
    line = []
    for name in kernels:
        main = timings[name][0]
        line.append({
            "name": name, "route": "cuda",
            "source": f"vitlens_tpu_torch/csrc/{sources[name]}",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shapes": timings[name]})
    print(f"[done] {card} | pc encode B{B}: {pc_rate:.2f} samples/s; whole run "
          f"{time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
