#!/usr/bin/env python3
"""Drives the PyTorch port (vitlens_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line each (or more); any failure exits non-zero:
  1. device: needs CUDA; prints the card's name and power limit (nvidia-smi).
  2. build: compiles the hand-written kernels from vitlens_tpu_torch/csrc/
     (one nvcc per source, in parallel).
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes of the main paths and at edge shapes: fused MLP, both
     variants and both activations (out and the save-preact output a; bf16,
     <= 2.5e-2 and 1e-2 relative; also a ragged M = 4100, D/H = 768/3072
     and 1664/8192, the bigG text tower's 1280/5120 at M = 154, and the
     plain variant at the video distill step's B64
     image tower, M = 131584), attention (bf16, <= 1e-2 relative; at the
     video Lens cross [64, 1, 256, 2048, 64], a ragged NK of 2040 beside it,
     the EEG and pc Lens cross [64, 1, 256, 512, 64] and the distill step's
     image tower [512, 16, 257, 257, 64]; also every NQ, NK in
     {1, 7, 77, 257, 600}, NK past the K/V-resident limit, and the packed-qkv
     and Lens views bit-equal to contiguous copies; and head dims 32, 80,
     88, 104, 112 and 128 at every NQ, NK in {1, 77, 257, 600}, contiguous
     and on the packed-qkv views), fused LN + projection (bf16, <= 1e-2
     relative; ragged M at D/N 768/2304, 1024/3072 and 1664/4992, bigG's
     ragged N), FPS
     (index-exact, FPS_CASES: B in {1, 2, 64, 65, 133} and N in {1, 31,
     8192, 10000, 16384, 16385, 100000, 300000}, which cross every cluster
     size the wrapper picks (1 to 16) and every tier of a partition
     (registers, shared memory, global memory), npoint in {1, 512, N + 5}, zero and random
     starts, random clouds and clouds with exact ties: a lattice, duplicated
     points) and the point encoder (bf16, <= 2e-2 relative; at the pc
     path's [64, 512, 32] and at every group size M in {16, 32, 48, 64,
     128} with 21 groups, a count no tile size divides but 1; at M = 48,
     80 and 128 over more tiles than two a CTA, groups straddling its two
     consumers; at C4 = 384 and 512, conv4 in passes), the int8 product's
     INT32 epilogue (equal, at 4096^3, at the
     quantized encode's ragged M = 49344 and at an M that is not a multiple
     of 64), its DEQUANT epilogue (bit-equal to the plain dequantise of the
     same product, with and without bias, bf16 and fp32 output), the
     quantise kernel (bit-equal, the quantized encode's K at M = 49344 and a
     ragged M, rows with zeros, .5 ties and negative extremes) and
     quant.int8_matmul on the card bit-equal to its plain version, the row
     gather (bit-equal, [49408, 512] table, 9856 ids with repeated and
     boundary ids),
     the chained fused MLP with and without the out-projection (both
     activations, bf16, <= 2.5e-2 relative, D = 1024 at M = 16448 and a
     ragged M, D = 256 and 128), kernel 1's outputs at both of its
     activations bit-identical to the parent build's (KERNEL1_DIGESTS), and
     the fused LN + projection at the LN + qkv prototype's shape; then the
     gradients of each kernel-backed autograd Function
     (fused MLP, attention, LN + projection) against torch autograd of its
     plain version on the card, in bf16 (<= 2e-2 relative for the fused MLP
     and LN + projection, 1e-2 for attention).
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
     FPS the same coordinates; their FPS indices must be equal. Then the B = 1
     pc request again with the tokenizer's group size set to 24, which the
     point-encoder kernel does not take: the plain encoder runs (1 FPS, 0
     point-encoder launches) and the cosine against the CPU holds.
  4v. served from files: writes WAV files (16 kHz mono 5 s, 44.1 kHz stereo
     12 s, 8 kHz 1.5 s), a FLAC file (tools/reference_layout.py's writer),
     PNG and JPEG images (320 x 240, RGB and gray), .npy clouds of 9000
     points, disparity maps (.npy and a 16-bit .png), an EEG .pt [128, 500],
     a directory of 12 JPEG frames, and reference-layout checkpoints made
     from a seed by tools/reference_layout.py (a merged export with
     vitlens.{audio, pc, depth, eeg, video}. keys, a CLIP file with visual.
     and text keys; fp16). ViTLens("vitlensL", ("image", "tactile",
     "depth", "audio", "eeg", "video", "pc", "text"), checkpoints=...,
     batch_buckets=(1, 4, 8)) on the card in bf16 and the same in fp32 on
     the CPU: loaded tensors equal the files' after the cast; B = 1 encodes
     from files (and one B = 3 audio request: WAV, the 8 kHz WAV, the FLAC;
     one B = 2 depth request: the .npy and the .png) with the launches per
     request derived from the config (image, tactile and depth 24 fused MLP
     + 24 attention, EEG 24 + 26, video 24 + 28, audio 24 + 32, pc 24 + 32 +
     1 FPS + 1 point encoder, text 12) and cosine >= 0.99 against the CPU. The on-device fbank of
     [3, 80000] waveforms (the tower's waveform branch) against the host
     AudioProcessor's of the same samples: max |d| <= 1e-3 on the normalised
     fbank, tower features cosine >= 0.99. Then
     make_server(model, max_batch=8, max_wait_ms=50) answers 16 concurrent
     HTTP requests mixing the eight modalities (paths, a frame directory,
     captions, numeric pc items): each reply cosine >= 0.999 against a
     direct encode, fewer batches than requests, /healthz names the card and
     the eight modalities, both workers gone after shutdown and close.
     Last, `python -m vitlens_tpu_torch.cli.serve --modalities depth eeg
     video text --ckpt all=... --ckpt text=... --max-batch 2 --port 0`
     answers one request of each (cosine >= 0.999 against the in-process
     model's direct encode) and drains on SIGTERM with exit 0.
  4t. transformer Lens: a vitlensL depth tower whose Lens is 2 trunk-width
     blocks (as_transformer) at full width and depth, a B = 2 bf16 encode
     with 26 fused MLP + 26 attention launches and cosine >= 0.99 against
     the fp32 CPU copy.
  4f. fp32 default: ViTLens("vitlensL", ("audio", "pc", "text")) with its
     default compute dtype (fp32, as in JAX) encodes B = 2 of each on the
     card through the plain paths (the kernels take bf16, as JAX's gates
     send fp32 to XLA): no fused MLP, attention or point-encoder launch, one
     FPS launch per pc request; cosine >= 0.999 against the same model in
     fp32 on the CPU (the audio encode also with cuDNN's TF32 convolution
     off); the text encode on its own line.
  4h. head dims: bf16 B = 1 audio encodes at full width whose trunks have
     head dims other than 64, ViTLens("vitlensG", ("audio",)) (ViT-bigG-14,
     104) and a ViT-H-14 audio tower (80), each trunk cut to 4 blocks so that
     the CPU run stays short: launches derived from the config (4 fused MLP,
     4 + the Lens's attention), cosine >= 0.99 against the CPU in fp32.
  4g. vitlensG pc: ViTLens("vitlensG", ("pc", "text")) at full ViT-bigG-14
     width and depth (the first 16 of 48 trunk blocks skipped, as published)
     with the PNSA tokenizer over 10000 xyz + rgb points, bf16 compute and
     bf16 weights (the serve CLI's vitlensG setting), loaded from
     reference-layout fp16 checkpoints written by tools/reference_layout.py
     (a loaded PNSA weight and a skipped block's weight equal the file's);
     B = 1 and B = 2 encodes of raw .npy clouds of 10000 x 6 and of
     xyz-only clouds (the processor fills 0.4 grey), each with 1 FPS, 32
     fused MLP and 40 attention launches and no point-encoder launch
     (tower_launches), and a text request (32 fused MLP); cosine >= 0.99
     against the same weights in fp32 on the CPU, which gets the
     processor's clouds rounded through bf16 as the card sees them; then one
     HTTP request of two clouds and a caption through make_server, cosine
     >= 0.999 against the direct encodes.
  4q. quantized: the audio tower of that model quantized to int8 (W8A8) on
     the card by quant.quantize_model, at full width and depth: w_q and w_s
     made on the card equal to those made on the CPU; a B = 1 and a B = 64 x
     3 clips audio encode, each with 96 DEQUANT products and 96 quantise
     launches (4 x 24 blocks), 32 attention and no fused MLP or fused LN +
     projection launch, a text encode of the copy's float text tower (12
     fused MLP) and one of a copy whose text tower is quantized too (48 of
     each, no fused MLP); cosine >= 0.99 of the B = 1
     int8 encode against the same quantized weights in fp32 on the CPU and of
     both against the float bf16 encode on the card.
  4s. scripts: each bench entry point of vitlens_tpu_torch.scripts (the
     counterparts of the TPU prototypes' own main()) runs in this process at
     its own shapes with few iterations, must exit 0, and must launch its
     kernel.
  4b. train: the vitlensL audio+text model at full width and depth, fp32
     trainable masters, frozen weights in bf16, bf16 compute, with the
     published audio recipe (visual and text towers locked, CLS unlocked,
     dual loss aligned to text). The gradients of one B = 2 pass and one
     B = 2 step against the same on the CPU in fp32 (loss within 5e-2,
     grad_norm within 1e-1 relative, gradient cosine >= 0.99); 3 steps at
     B = 8, 2 at B = 8 with accum_freq 4 and one with remat, each with its
     launches per kernel variant against the count derived from the config;
     finite losses, every trainable parameter changed, every frozen one
     bit-identical.
  4c. opt-in: with VITLENS_ENABLE_FUSED_LNQKV=1 (set for this phase only), a
     B = 1 audio encode, a text encode and a train step launch the fused LN +
     projection 24 times per audio tower pass and 12 per text pass; the
     encode and the B = 2 gradients hold cosine >= 0.99 against the CPU fp32
     path.
  4d. tri train: the vitlensL depth model (create_model("ViT-L-14",
     "depth")) at full width and depth with its frozen ViT-L-14 image tower,
     fp32 trainable masters, frozen weights in bf16, bf16 compute, the
     published depth recipe (image, text and visual towers locked, the first
     4 trunk blocks unlocked, n_tower=3). The gradients of one B = 2 pass
     against the same pass on the CPU in fp32 (loss within 5e-2, grad_norm
     within 1e-1 relative, cosine >= 0.99); 3 steps at B = 8 and 2 with
     accum_freq 4, each with its launches per kernel variant against
     tri_train_launches (the image and text towers only kernel 1's plain
     variant, the Lens tower's trunk the save-preact one); every frozen
     parameter, the whole image tower included, bit-identical, every
     trainable one changed.
  4e. video distill: the vitlensL video model with video_distill=True and
     the distill-token loss (the image tower over the 8 frames of each clip,
     its features and tokens averaged over the frames, distilled into the
     video Lens tower; image, text and visual towers locked, so the Lens
     and the adapter train): the B = 2 gradients against the CPU in fp32,
     then 2 steps at B = 4 with accum_freq 2 (the cached tokens spliced in),
     with launches, frozen and trained checks as in 4d.
  4p. pc tri train: the vitlensL pc model (create_model("ViT-L-14", "pc"):
     the PointBERT tokenizer over 8192 points, the Lens of depth 4) at full
     width and depth with the published pc recipe (image, text and visual
     towers locked: the tokenizer and the Lens train, n_tower=3). The B = 2
     pass against the CPU fp32 pass as in 4d, FPS started at the same given
     points on both, the clouds rounded through bf16 once and the CPU pass
     given the card pass's kNN groups (bf16 distances, rounded as JAX's
     are, pick other neighbours than fp32 in most groups: the share is
     printed), with the
     moves of the tokenizer's BatchNorm running statistics held to the
     CPU's (cosine >= 0.99); 2 steps at B = 8 and 2 with accum_freq 4, FPS
     starts drawn from a CUDA generator, each with its launches against
     tri_train_launches (FPS once a pass that runs the tokenizer, the point
     encoder never: it is eval-only, as in JAX), the frozen and trained
     checks of 4d, and each BatchNorm run in train mode once a pass with
     its running statistics after the step those its accum_freq cached
     passes left (the grad passes' updates dropped).
  4x. train CLI: `python -m vitlens_tpu_torch.cli.train` as a child
     process on the card, the published vitlensL audio recipe (--n-tower 2
     --align-to text --unlock-cls --precision bf16, ViT-L-14 at full width
     and depth, B = 8, accum_freq 2) from files written here: 24
     AudioSet-style clips of 5-10 s (every fourth a FLAC, decoded by the
     native host library), an ESC50-style fold of 8 clips over 4 classes, an
     AudioCaps-style test set of 6 rows, and a reference-layout vitlensL tri
     file (fp16, tools/reference_layout.py) as --pretrained. Run (a): 2
     epochs, exit 0, a finite loss and grad_norm > 0 every step, val lines
     with ESC50 accuracy, AudioCaps r_mean and the primary metric, epoch_1,
     epoch_2, epoch_latest and checkpoint_best written. Run (b): --resume
     latest --epochs 3 continues at epoch 2 with the step count; every
     trainable tensor moved, every frozen one bit-identical to the
     pretrained file's after the bf16 cast. In this process, through
     cli.train's functions: the AdamW moments loaded from epoch_2 bit-equal
     to the file's; one train step (the batch through the DevicePrefetcher)
     with its launches against train_launches; one eval batch (8 x 3 clips)
     with tower_launches; checkpoint_best's eval features (loaded with
     load_checkpoint) cosine >= 0.99 against the same weights in fp32 on the
     CPU. Run (c): --visual-stat-flops prints its JSON line.
  5. timing: each kernel against its plain version (and, where one PyTorch
     call computes the same function, that call) at the B64 shapes of the
     main paths, beside each kernel's bound, with cuBLAS's two products
     (torch.addmm on the normalised input) beside the fused MLP and the
     fused LN + projection, the trunk attention also on the packed-qkv views; the audio (64 samples x 3 clips)
     and pc (64 clouds) encode rates at B64 in bf16, the audio encode also
     with the opt-in; the audio train-step rate at B64 with and without the
     opt-in, with the peak device memory; the 4d depth tri step's rate at
     B64, the 4e video distill step's and the 4p pc tri step's at the
     largest B in (64, 32) that fits, each with its peak device memory and
     one step under the profiler (busy and idle share); the 4g vitlensG pc
     encode at B16 (arrays given) with its peak memory and a profile, and
     the ball query at its shape [16, 512, 10000], 64 a ball, beside its
     bound; attention at the bigG trunk's
     head dim 104 beside SDPA; the int8 product's INT32 and DEQUANT
     epilogues at 4096^3 and the quantized encode's four shapes beside
     torch._int_mm, the quantise kernel beside its bound, the row gather's
     device time and, through its wrapper, its time back to back and host
     time a call, beside index_select's, the chained MLPs beside the
     three-launch fused MLP on the same function and today's split; FPS at
     B64 and B = 1 (N 8192, npoint 512); the host-timed latency of a B = 1 pc
     encode; the B64 quantized audio encode rate
     beside the float one; a torch.profiler breakdown of one B64 audio (float
     and quantized) and one B64 pc encode and one B64 train step with the
     device's busy and idle share; the Lens-cross attention of video [64, 1,
     256, 2048, 64] and of EEG and pc [64, 1, 256, 512, 64] beside SDPA;
     the served path (phase 4v's model): the B64 image, depth, EEG and video
     encode rates (arrays given; a profile of the video encode), the host
     AudioProcessor per 10 s WAV, ImageProcessor per image, DepthProcessor
     per .npy and per .png, EEGProcessor per .pt and VideoProcessor per
     12-frame directory, the on-device fbank at [192, 80000], and a
     closed-loop served run (64 audio requests of one 5 s WAV from 16 client
     threads at max_batch 64: requests/s, p50 and p95 from /healthz); the
     native host library: PointCloudProcessor on raw .npy clouds of 9000
     and 10000 points (FPS through the library) beside the plain numpy FPS
     loop, a 10 s FLAC decoded by the library beside the pure-Python
     decoder, and the closed loop again with one 5 s FLAC a request; phase
     4x's train step (host-timed) and the host ms a clip of its AudioSet
     pipeline. Every time is printed beside the card's name and power
     limit.
The last lines are {"kernels": [...]}, the card's name and power limit, then
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

MLP_TOL = 2.5e-2   # bf16 rounding; the kernel keeps the act input in fp32
PREACT_TOL = 1e-2  # a: the kernel adds b1 in fp32, the plain version in bf16
ATTN_TOL = 1e-2    # bf16 P in the P @ V product, fp32 everywhere else
LNP_TOL = 1e-2     # bf16 LN output and product; only sum order differs
ENC_TOL = 2e-2     # bf16 rounding; rounding points that differ by one ulp
# Gradients of the Functions against autograd of the plain versions, bf16:
# the intermediate gradients (dh, da, dy) round to bf16 at other points in
# the closed-form backward than in autograd, and dW, db, dLN sum ~1000 rows
# (the first H100 run read at most 6.9e-3).
GRAD_TOL = 2e-2
ATTN_GRAD_TOL = 1e-2  # both recompute P in fp32; only the rounding of dq/dk/dv
CHAIN_TOL = 2.5e-2  # as the fused MLP: bf16 roundings of z, h and out
COS_MIN = 0.99     # bf16 card path against the fp32 CPU plain path
LOSS_TOL = 5e-2    # |loss card - loss CPU|: bf16 features at logit scale 14.3
# grad_norm card / CPU - 1: bf16 gradients; a cosine of 0.99 alone allows
# ~14%, the ViT-Tiny rehearsal on the CPU read 2%
NORM_TOL = 1e-1
SEED = 0
B = 64             # the benchmark batch of both encode paths

# One NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet, dense rates).
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_INT8 = 1979e12
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


def attn_bound(b, h, nq, nk, dh):  # q, k, v, out bf16
    return bound(4 * b * h * nq * nk * dh, 2 * b * h * dh * (2 * nq + 2 * nk),
                 PEAK_BF16)


def preact_bound(m, d, h):  # the save-preact variant also writes a [M, H] bf16
    return bound(4 * m * d * h,
                 2 * (2 * m * d + 2 * d * h + m * h) + 4 * (3 * d + h), PEAK_BF16)


def ln_proj_bound(m, d, n):  # x, out, W bf16; LN params and bias fp32
    return bound(2 * m * d * n, 2 * (m * d + m * n + d * n) + 4 * (2 * d + n),
                 PEAK_BF16)


def fps_bound(b, n, npoint):
    # per distance update (npoint - 1 of them) and point: 3 sub, 3 mul, 2 add,
    # min, compare (fp32 cores)
    return bound(10 * b * n * (npoint - 1), 12 * b * n + 4 * b + 4 * b * npoint,
                 PEAK_FP32)


def enc_bound(bg, m, c1, c2, c3, c4):
    ops = (2 * bg * m * (3 * c1 + c1 * c2 + c2 * c3 + c3 * c4)
           + 2 * bg * c2 * c3)
    nbytes = (2 * bg * m * 3 + 2 * bg * c4
              + 2 * (3 * c1 + c1 * c2 + 2 * c2 * c3 + c3 * c4)
              + 4 * (4 * c1 + c2 + 4 * c3 + c4))
    return bound(ops, nbytes, PEAK_BF16)


def int8_bound(m, k, n):  # a, b int8 read once; the int32 product written once
    return bound(2 * m * k * n, m * k + k * n + 4 * m * n, PEAK_INT8)


def dequant_bound(m, k, n):
    """a, b int8 read once; row scales, column scales and bias fp32; the
    bf16 output written once."""
    return bound(2 * m * k * n, m * k + k * n + 4 * m + 8 * n + 2 * m * n,
                 PEAK_INT8)


def quantize_bound(m, k, elem_bytes):  # x read once; int8 rows, fp32 scales
    return bound(0, m * k * elem_bytes + m * k + 4 * m, PEAK_BF16)


def gather_bound(j, row_bytes):  # J rows read and written, J int32 ids
    return bound(0, 2 * j * row_bytes + 4 * j, PEAK_BF16)


def chain_bound(m, d, h, outproj):  # as mlp_bound, plus ctx, Wo and bo
    extra_ops, extra_bytes = (2 * m * d * d, 2 * (m * d + d * d) + 4 * d) \
        if outproj else (0, 0)
    return bound(4 * m * d * h + extra_ops,
                 2 * (2 * m * d + 2 * d * h) + 4 * (3 * d + h) + extra_bytes,
                 PEAK_BF16)


def int8_inputs(torch, g, m, k, n):
    """a [M, K], b [K, N] and b transposed, random in [-127, 127]."""
    a = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                      dtype=torch.int8)
    return a, b, b.t().contiguous()


def outproj_inputs(torch, g, m, d):
    def r(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

    return (r(m, d, std=0.5), r(d, d, std=d ** -0.5),
            r(d, std=0.1, dtype=torch.float32))


def mlp_inputs(torch, g, m, d, h):
    def r(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

    f32 = torch.float32
    return (r(m, d, std=0.5), 1.0 + r(d, std=0.1, dtype=f32),
            r(d, std=0.1, dtype=f32), r(d, h, std=d ** -0.5),
            r(h, std=0.1, dtype=f32), r(h, d, std=h ** -0.5),
            r(d, std=0.1, dtype=f32))


def fps_inputs(torch, g, b, n, cloud="random", starts="zero"):
    """xyz [b, n, 3] fp32 on the card and start [b] int32 (zero or uniform
    in [0, n)). Clouds: "random" (normal, std 0.3); "lattice" (a 16 x 16 x k
    grid of step 0.125 in point order, so that equal distances meet inside a
    warp, across warps and across the cluster's partitions); "duplicates"
    (37 distinct points repeated, so that every distance reaches 0 and index
    0 repeats once the 37 are taken)."""
    i = torch.arange(n, device="cuda")
    if cloud == "random":
        xyz = torch.randn(b, n, 3, generator=g, device="cuda") * 0.3
    elif cloud == "lattice":
        grid = torch.stack((i % 16, (i // 16) % 16, i // 256), -1).float() * 0.125
        xyz = grid.expand(b, n, 3).contiguous()
    else:
        base = torch.randn(b, 37, 3, generator=g, device="cuda")
        xyz = base[:, i % 37].contiguous()
    start = (torch.randint(0, n, (b,), generator=g, device="cuda", dtype=torch.int32)
             if starts == "random" else torch.zeros(b, dtype=torch.int32, device="cuda"))
    return xyz, start


# (B, N, npoint, cloud, starts) of phase 3's FPS checks; the first two are
# timed in phase 5.
FPS_CASES = ((B, 8192, 512, "random", "zero"), (1, 8192, 512, "random", "zero"),
             (1, 1, 1, "random", "zero"), (2, 1, 6, "random", "zero"),
             (2, 31, 36, "random", "random"), (65, 31, 1, "random", "random"),
             (65, 10000, 512, "random", "random"),
             (133, 16384, 512, "random", "zero"),
             (64, 16385, 512, "random", "random"),
             (2, 16385, 512, "lattice", "random"),
             (1, 100000, 512, "random", "random"),
             (1, 300000, 64, "random", "random"),
             (64, 100000, 64, "random", "zero"),
             (133, 100000, 16, "lattice", "random"),
             (1, 8192, 512, "lattice", "zero"), (B, 8192, 512, "lattice", "random"),
             (65, 10000, 512, "duplicates", "random"),
             (2, 31, 36, "duplicates", "zero"),
             (133, 8192, 512, "duplicates", "zero"))


# sha256 (first 16 hex digits) of kernel 1's outputs on kernel1_digests'
# inputs, from the build of the parent commit on an H100: the tanh GELU added
# to gemm_sm90.cuh's act_fn (for the chained MLPs) leaves acts 0 and 1
# bit-identical.
KERNEL1_DIGESTS = {
    "gelu": ("8ea59f0450c38bb8", "8ea59f0450c38bb8", "b202cffe3b1788aa"),
    "quick_gelu": ("9a789c45de3cbca6", "9a789c45de3cbca6", "b202cffe3b1788aa")}


def kernel1_digests(torch, np):
    """Digests of kernel 1's outputs (out of the plain variant, out and a of
    the save-preact variant) at acts 0 and 1 on inputs made with numpy from
    SEED, [1001, 1024] x [1024, 4096]."""
    import hashlib

    from vitlens_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_save_preact

    rng = np.random.RandomState(SEED)
    m, d, h = 1001, 1024, 4096
    arrays = (rng.randn(m, d) * 0.5, 1 + 0.1 * rng.randn(d), 0.1 * rng.randn(d),
              rng.randn(d, h) * d ** -0.5, 0.1 * rng.randn(h),
              rng.randn(h, d) * h ** -0.5, 0.1 * rng.randn(d))
    args = [torch.tensor(a, dtype=torch.float32, device="cuda") for a in arrays]
    for i in (0, 3, 5):
        args[i] = args[i].bfloat16()

    def digest(t):
        return hashlib.sha256(t.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]

    out = {}
    for act in ("gelu", "quick_gelu"):
        y = fused_mlp(*args, act=act)
        y2, a = fused_mlp_save_preact(*args, act=act)
        out[act] = (digest(y), digest(y2), digest(a))
    return out


def ln_proj_inputs(torch, g, m, d, n):
    def r(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

    f32 = torch.float32
    return (r(m, d, std=0.5), 1.0 + r(d, std=0.1, dtype=f32),
            r(d, std=0.1, dtype=f32), r(d, n, std=d ** -0.5),
            r(n, std=0.1, dtype=f32))


def qkv_inputs(torch, g, b, h, nq, nk, d=64):
    return tuple(torch.randn(b, h, n, d, generator=g, device="cuda")
                 .to(torch.bfloat16) for n in (nq, nk, nk))


def quant_rows(torch, g, m, k, dtype):
    """Activations whose rows hold the quantise step's edge cases: an
    all-zero row (the 1e-12 floor), a row of exact .5 ties (amax 127, so the
    row scale is 1), a row whose extremes are negative, and random rows of
    three magnitudes."""
    x = torch.randn(m, k, generator=g, device="cuda")
    x = x * torch.tensor([1e-3, 1.0, 40.0], device="cuda")[
        torch.randint(0, 3, (m, 1), generator=g, device="cuda")]
    x[0] = 0
    if m > 1:
        x[1] = torch.tensor([127.0, -0.5, 0.5, 1.5, 2.5, -1.5, -2.5, 3.5],
                            device="cuda").repeat(k // 8)
    if m > 2:
        x[2] = -x[2].abs() * 3
    return x.to(dtype)


def device_ms(torch, fn, iters=50):
    """The device time a call of ``fn``: the kernels it launches, summed by
    the profiler over ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / iters


def host_us(torch, fn, iters=300):
    """The host time a call of ``fn`` takes to enqueue its work (the card
    keeps up where the device time is the shorter)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


ENC_WIDTHS = (128, 256, 512, 256)  # the PointBERT encoder's C1..C4


def enc_inputs(torch, g, bg_shape, m, c4=ENC_WIDTHS[3]):
    """Group points [..., M, 3] bf16 and encoder weights with nontrivial BN
    statistics, in the wrapper's argument order; C4 is the tokenizer's
    encoder_dims."""
    c1, c2, c3 = ENC_WIDTHS[:3]

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


def grad_errs(torch, g, function, plain, args):
    """Relative errors of the gradients of ``function`` (a kernel-backed
    autograd Function) against torch autograd of ``plain`` on the same
    inputs and output gradient, one per input."""
    def run(fn):
        leaves = [t.detach().clone().requires_grad_(True) for t in args]
        out = fn(*leaves)
        cot = torch.randn(out.shape, generator=g, device="cuda").to(out.dtype)
        return out, torch.autograd.grad(out, leaves, cot)

    state = g.get_state()
    out, got = run(function)
    if "Function" not in type(out.grad_fn).__name__:
        fail(f"{function.__name__}: autograd did not record its Function")
    g.set_state(state)  # the same output gradient for both
    _, want = run(plain)
    return [rel_err(a, b) for a, b in zip(got, want)]


COUNTED = ("fused_mlp", "fused_mlp_save_preact", "flash_attention", "fps",
           "point_encoder", "fused_ln_proj", "int8_matmul", "int8_matmul_dequant",
           "int8_quantize", "row_gather", "fused_mlp_chunked", "fused_attnout_mlp")


def launch_counts(**counts):
    """Expected launches by counter: the named ones, every other 0."""
    return {**dict.fromkeys(COUNTED, 0), **counts}


def tower_launches(cfg, **more):
    """Expected launches of one bf16 encode of a vision tower, derived from
    its config: kernel 1 and kernel 2 once a trunk block that runs (the
    first skip_first_n_layers are skipped); a Perceiver Lens adds one
    attention a cross and a self block; a transformer Lens adds its blocks'
    MLP and attention; the identity Lens adds nothing."""
    p = cfg.perceiver
    mlp = attn = cfg.arch.layers - (cfg.skip_first_n_layers or 0)
    if p is not None and p.as_transformer:
        mlp, attn = mlp + p.depth, attn + p.depth
    elif p is not None and not p.as_identity:
        attn += p.depth * (1 + p.self_per_cross_attn)
    return launch_counts(fused_mlp=mlp, flash_attention=attn, **more)


def train_launches(cfg, text_layers, accum, remat, opt_in):
    """Launches per kernel variant of one train step of the dual audio+text
    recipe, derived from the config: each pass with grad runs the audio
    trunk through the save-preact variant (twice under remat: the block is
    recomputed in the backward) and the frozen text tower through the plain
    one; accum_freq > 1 adds a cached pass of both towers without grad.
    Attention: the trunk's blocks and the Lens's cross and self blocks (the
    text tower's causal attention is plain)."""
    la, lt = cfg.arch.layers, text_layers
    lens = cfg.perceiver.depth * (1 + cfg.perceiver.self_per_cross_attn)
    cached = accum if accum > 1 else 0
    r = 2 if remat else 1
    return launch_counts(
        fused_mlp=accum * lt + cached * (la + lt),
        fused_mlp_save_preact=accum * la * r,
        flash_attention=accum * (la * r + lens) + cached * (la + lens),
        fused_ln_proj=(accum * (la * r + lt) + cached * (la + lt)
                       if opt_in else 0))


def train_phase(torch, np, counters, totals):
    """Phases 4b and 4c: the audio train step of the published recipe on
    the card, against the CPU in fp32. Returns what phase 5 times."""
    from dataclasses import replace

    from vitlens_tpu_torch.factory import create_model, make_trainable_
    from vitlens_tpu_torch.models import tri
    from vitlens_tpu_torch.train.freeze import count_trainable, tri_model_mask
    from vitlens_tpu_torch.train.losses import make_loss_fn
    from vitlens_tpu_torch.train.step import (OptimizerConfig, StepConfig,
                                              init_train_state, make_optimizer,
                                              make_train_step, micro_grads)

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def read():
        """The launches since reset(), added to the main-path totals."""
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in counters.items()}
        for name, n in counts.items():
            totals[name] += n
        return counts

    t0 = time.time()
    model = create_model("ViT-L-14", "audio", seed=SEED, device="cuda",
                         dtype=torch.float32)
    cfg = model.cfg
    acfg, n_text = cfg.tower, cfg.text.layers
    mask = tri_model_mask(model, cfg, lock_visual=True, lock_text=True,
                          unlock_cls=True)
    tx, mask = make_optimizer(model, OptimizerConfig(
        lr=1e-4, warmup=10, total_steps=1000, grad_clip_norm=1.0), mask)
    make_trainable_(model, mask, torch.bfloat16)
    ref = copy.deepcopy(model).to(device="cpu", dtype=torch.float32)
    names = [n for n, t in mask.items() if t]
    rng = np.random.RandomState(SEED)

    def batch(b):
        text = rng.randint(1, 49000, size=(b, 77))
        text[:, 0], text[:, -1] = 49406, 49407
        fb = rng.randn(b, acfg.audio.target_length, acfg.audio.mel_bins) * 0.5
        return {"text": torch.from_numpy(text).long(),
                "visual": torch.from_numpy(fb.astype(np.float32))}

    sc = StepConfig(n_tower=2, align_to="text", compute_dtype=torch.bfloat16)
    sc_cpu = replace(sc, compute_dtype=torch.float32)
    loss_fn = make_loss_fn(2)

    def grads_of(m, step_cfg, bt):
        params = {n: p for n, p in m.named_parameters() if mask[n]}
        dev = m.logit_scale.device
        loss, gr = micro_grads(m, {k: v.to(dev) for k, v in bt.items()},
                               step_cfg, params, loss_fn)
        return float(loss), torch.cat([gr[n].float().flatten().cpu() for n in names])

    def cosine(a, b):  # in float64: the gradients have ~1.3e8 elements
        a, b = a.double().flatten(), b.double().flatten()
        return (a @ b / (a.norm() * b.norm())).item()

    def expect(label, counts, want):
        if counts != want:
            fail(f"{label}: launches {counts}, expected {want}")

    b2 = batch(2)
    loss_cpu, g_cpu = grads_of(ref, sc_cpu, b2)
    reset()
    loss_card, g_card = grads_of(model, sc, b2)
    expect("B=2 gradients", read(), train_launches(acfg, n_text, 1, False, False))
    cos_g = cosine(g_card, g_cpu)
    if not (cos_g >= COS_MIN and abs(loss_card - loss_cpu) <= LOSS_TOL):
        fail(f"B=2 gradients vs CPU fp32: cosine {cos_g}, loss {loss_card} vs "
             f"{loss_cpu}")

    # -- 4c: the opt-in fused LN + projection, at the initial weights -------
    os.environ["VITLENS_ENABLE_FUSED_LNQKV"] = "1"
    try:
        reset()
        loss_opt, g_opt = grads_of(model, sc, b2)
        expect("opt-in B=2 gradients", read(),
               train_launches(acfg, n_text, 1, False, True))
        fb1, ids1 = batch(1)["visual"], b2["text"][:1]
        with torch.no_grad():
            reset()
            emb = tri.encode_visual(model, fb1.cuda(), normalize=True,
                                    compute_dtype=torch.bfloat16)
            n_audio = read()["fused_ln_proj"]
            reset()
            temb = tri.encode_text(model, ids1.cuda(), normalize=True,
                                   compute_dtype=torch.bfloat16)
            n_txt = read()["fused_ln_proj"]
            emb_cpu = tri.encode_visual(ref, fb1, normalize=True)
            temb_cpu = tri.encode_text(ref, ids1, normalize=True)
    finally:
        del os.environ["VITLENS_ENABLE_FUSED_LNQKV"]
    cos_opt = {"audio encode": cosine(emb.cpu(), emb_cpu),
               "text encode": cosine(temb.cpu(), temb_cpu),
               "B=2 gradients": cosine(g_opt, g_cpu)}
    if (n_audio, n_txt) != (acfg.arch.layers, n_text):
        fail(f"opt-in encodes: fused_ln_proj launches audio {n_audio}, text "
             f"{n_txt}, expected {acfg.arch.layers} and {n_text}")
    if min(cos_opt.values()) < COS_MIN or abs(loss_opt - loss_cpu) > LOSS_TOL:
        fail(f"opt-in vs CPU fp32: cosines {cos_opt}, loss {loss_opt} vs {loss_cpu}")
    print(f"[4c opt-in] VITLENS_ENABLE_FUSED_LNQKV=1: fused_ln_proj launches "
          f"{n_audio} per audio encode (B=1), {n_txt} per text encode, "
          f"{train_launches(acfg, n_text, 1, False, True)['fused_ln_proj']} per "
          f"B=2 gradient pass; cosine vs CPU fp32: "
          + " ".join(f"{k} {v:.6f}" for k, v in cos_opt.items())
          + f"; loss {loss_opt:.5f} (CPU {loss_cpu:.5f})", flush=True)

    # -- 4b: train steps -----------------------------------------------------
    frozen0 = {n: p.detach().clone() for n, p in model.named_parameters()
               if not mask[n]}
    train0 = {n: p.detach().clone() for n, p in model.named_parameters()
              if mask[n]}
    state, state_cpu = init_train_state(model, tx), init_train_state(ref, tx)
    step_cpu = make_train_step(cfg, tx, mask, sc_cpu)
    state_cpu, m_cpu = step_cpu(state_cpu, b2)
    del ref, state_cpu
    runs = ([("B=2, the CPU's step", b2, 1, False, False)]
            + [("B=8", None, 1, False, False)] * 3
            + [("B=8 accum_freq 4", None, 4, False, False)] * 2
            + [("B=8 remat", None, 1, True, False),
               ("B=8 opt-in", None, 1, False, True)])
    per_step = []
    for label, bt, accum, remat, opt_in in runs:
        step = make_train_step(cfg, tx, mask, replace(sc, accum_freq=accum,
                                                      remat=remat))
        if opt_in:
            os.environ["VITLENS_ENABLE_FUSED_LNQKV"] = "1"
        try:
            reset()
            state, m = step(state, batch(8) if bt is None else bt)
            counts = read()
        finally:
            os.environ.pop("VITLENS_ENABLE_FUSED_LNQKV", None)
        expect(label, counts, train_launches(acfg, n_text, accum, remat, opt_in))
        m = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"{label}: metrics {m}")
        per_step.append((label, m["loss"], counts))
        if bt is b2:
            m_card = m
    d_loss = abs(m_card["loss"] - float(m_cpu["loss"]))
    d_norm = abs(m_card["grad_norm"] / float(m_cpu["grad_norm"]) - 1)
    if d_loss > LOSS_TOL or d_norm > NORM_TOL:
        fail(f"B=2 step vs CPU fp32: card {m_card}, CPU "
             f"{ {k: float(v) for k, v in m_cpu.items()} }")
    moved = [n for n, p in model.named_parameters() if not mask[n]
             and not torch.equal(p, frozen0[n])]
    still = [n for n, p in model.named_parameters() if mask[n]
             and torch.equal(p, train0[n])]
    if moved or still:
        fail(f"frozen parameters that changed {moved[:5]}, trainable ones "
             f"that did not {still[:5]}")
    del frozen0, train0
    print(f"[4b train] vitlensL audio+text, recipe lock_visual + lock_text + "
          f"unlock_cls: {count_trainable(model, mask)} trainable parameters "
          f"in {len(names)} tensors; phases 4b and 4c took "
          f"{time.time() - t0:.1f} s with the CPU fp32 runs; B=2 vs CPU fp32: gradient cosine {cos_g:.6f}, loss "
          f"{loss_card:.5f} vs {loss_cpu:.5f}, step grad_norm "
          f"{m_card['grad_norm']:.5f} vs {float(m_cpu['grad_norm']):.5f}; steps "
          f"(label, loss, launches) {per_step}; frozen parameters "
          f"bit-identical, every trainable one changed", flush=True)
    return model, state, tx, mask, sc, batch


def tri_train_launches(cfg, accum):
    """Launches per kernel variant of one tri or video-distill train step,
    derived from the config: each pass with grad runs the frozen image
    tower (once over every frame of a clip) and the frozen text tower
    through kernel 1's plain variant and the Lens tower, whose Lens trains,
    through the save-preact variant; accum_freq > 1 adds a cached pass of
    the three towers without grad. Attention: the image tower's trunk and
    the Lens tower's trunk and Lens (the text tower's is plain). A point
    cloud's tokenizer launches FPS once a pass, and the point encoder never
    (it is eval-only, as in JAX: training runs the plain mini-PointNet with
    batch statistics)."""
    li, lt = cfg.vision.layers, cfg.text.layers
    lens = tower_launches(cfg.tower)
    la_mlp, la_attn = lens["fused_mlp"], lens["flash_attention"]
    cached = accum if accum > 1 else 0
    return launch_counts(
        fused_mlp=accum * (li + lt) + cached * (li + lt + la_mlp),
        fused_mlp_save_preact=accum * la_mlp,
        flash_attention=(accum + cached) * (li + la_attn),
        fps=accum + cached if cfg.tower.modality == "pc" else 0)


def tri_batch(torch, np, cfg, b, rng, frames=0):
    """A seeded tri batch on the host: token ids, images (``frames`` > 0:
    clips [B, frames, 3, 224, 224], also the Lens tower's input) and the
    Lens tower's input: depth maps, or point clouds [B, npoints, 3] rounded
    through bf16 once (so that an fp32 run on the CPU gives FPS the
    coordinates the card's bf16 run sees)."""
    text = rng.randint(1, 49000, size=(b, 77))
    text[:, 0], text[:, -1] = 49406, 49407
    shape = (b, frames, 3, 224, 224) if frames else (b, 3, 224, 224)
    image = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    if frames:
        visual = image
    elif cfg.tower.modality == "pc":
        visual = torch.from_numpy((rng.randn(b, cfg.tower.point.npoints, 3)
                                   * 0.3).astype(np.float32)).bfloat16().float()
    else:
        visual = torch.from_numpy(
            rng.randn(b, 1, 224, 224).astype(np.float32))  # depth maps
    return {"text": torch.from_numpy(text).long(), "image": image,
            "visual": visual}


def shared_knn_groups(torch, first, second):
    """(first(), second(), a note): second() replays, in order, the kNN
    groups (ops.fps.knn_indices) that first() selected, so that the B = 2
    card-against-CPU comparison holds both to the same neighbourhoods, as
    it holds them to the same FPS starts. In bf16 the distances round as
    JAX's do (the product form, |q|^2 + |p|^2 - 2 q.p, in bf16), which picks
    other neighbours than fp32 in most groups; the note gives that share."""
    from vitlens_tpu_torch.ops import fps as F

    knn, made = F.knn_indices, []

    def record(xyz, query, k):
        made.append((xyz, query, knn(xyz, query, k)))
        return made[-1][2]

    F.knn_indices = record
    try:
        a = first()
        replay = iter([idx for _, _, idx in made])
        F.knn_indices = lambda xyz, query, k: next(replay).to(xyz.device)
        b = second()
    finally:
        F.knn_indices = knn
    note = ""
    for xyz, query, idx in made:
        exact = knn(xyz.float(), query.float(), idx.shape[-1])
        differ = (exact.sort(-1).values != idx.sort(-1).values).any(-1)
        note += (f"; kNN groups replayed from the card's pass ({xyz.dtype}: "
                 f"{differ.float().mean().item():.3f} of them differ from fp32 "
                 f"distances' on the same centers)")
    return a, b, note


def batch_norm_stats(torch, model):
    """{buffer name: fp32 copy on the CPU} of every BatchNorm running mean
    and var of ``model`` (empty where it has none)."""
    return {n: b.detach().float().cpu().clone()
            for n, b in model.named_buffers()
            if n.endswith((".mean", ".var")) and ".bn" in n}


class batch_norm_trace:
    """Within the block, every train-mode BatchNorm call records its
    running mean right after its update: {module: [tensor, ...]}."""

    def __init__(self, torch):
        from vitlens_tpu_torch.adapters.tokenizers import BatchNorm

        self.cls, self.calls = BatchNorm, {}

    def __enter__(self):
        forward, calls = self.cls.forward, self.calls
        self.forward = forward

        def traced(bn, x, train=False):
            y = forward(bn, x, train)
            if train:
                calls.setdefault(bn, []).append(bn.mean.detach().clone())
            return y

        self.cls.forward = traced
        return self.calls

    def __exit__(self, *exc):
        self.cls.forward = self.forward


def check_running_stats(torch, label, model, calls, before, accum):
    """A step's BatchNorms ran in train mode once a pass (accum_freq 1: one
    pass; otherwise accum_freq cached passes, then accum_freq grad passes),
    and each one's running mean after the step is the one its last cached
    pass left: updated accum_freq times, the grad passes' updates dropped.
    Every running mean and var moved."""
    want_calls = 1 if accum == 1 else 2 * accum
    for bn, means in calls.items():
        if len(means) != want_calls:
            fail(f"{label}: a BatchNorm ran {len(means)} times in train mode, "
                 f"expected {want_calls}")
        if not torch.equal(bn.mean, means[accum - 1]):
            fail(f"{label}: a BatchNorm's running mean is not the one its "
                 f"{accum} cached pass(es) left")
        if accum > 1 and torch.equal(bn.mean, means[-1]):
            fail(f"{label}: the grad passes' running-statistic updates stayed")
    now = batch_norm_stats(torch, model)
    still = [k for k in before if torch.equal(now[k], before[k])]
    if 2 * len(calls) != len(before) or still:
        fail(f"{label}: {len(calls)} BatchNorms ran in train mode for "
             f"{len(before)} running tensors; unmoved {still}")


def tri_train_phase(torch, np, counters, totals, tag, modality, flags, sc,
                    runs, frames=0):
    """Phase 4d, 4e or 4p: a tri-shaped recipe on the vitlensL ``modality``
    model at full width and depth (fp32 trainable masters, frozen weights
    in bf16, bf16 compute). The gradients of one B = 2 pass against the
    same pass on the CPU in fp32 (loss, grad_norm, cosine); then ``runs``
    [(label, B, accum_freq)] steps, each with its launches per kernel
    variant against tri_train_launches; every frozen parameter (the whole
    image tower too) bit-identical, every trainable one changed. A point
    cloud's B = 2 passes start FPS at the same given points on both, the
    CPU pass takes the card pass's kNN groups (shared_knn_groups), and
    their BatchNorm running statistics move alike (cosine of the moves);
    its steps draw the starts from a CUDA generator, and each step leaves
    every BatchNorm's running statistics as its cached passes left them
    (accum_freq of them; the grad passes' updates dropped). Returns what
    phase 5 times."""
    from dataclasses import replace

    from vitlens_tpu_torch.factory import create_model, make_trainable_
    from vitlens_tpu_torch.train.freeze import count_trainable, tri_model_mask
    from vitlens_tpu_torch.train.losses import make_loss_fn
    from vitlens_tpu_torch.train.step import (OptimizerConfig, init_train_state,
                                              make_optimizer, make_train_step,
                                              micro_grads)

    t0 = time.time()
    model = create_model("ViT-L-14", modality, seed=SEED, device="cuda",
                         dtype=torch.float32)
    cfg = model.cfg
    mask = tri_model_mask(model, cfg, **flags)
    tx, mask = make_optimizer(model, OptimizerConfig(
        lr=1e-4, warmup=10, total_steps=1000, grad_clip_norm=1.0), mask)
    make_trainable_(model, mask, torch.bfloat16)
    names = [n for n, t in mask.items() if t]
    loss_fn = make_loss_fn(sc.n_tower, sc.contra_loss_type)
    rng = np.random.RandomState(SEED)
    pc = modality == "pc"
    starts2 = torch.tensor([17, 4242], dtype=torch.int32) if pc else None

    def grads_of(m, step_cfg, bt):
        params = {n: p for n, p in m.named_parameters() if mask[n]}
        dev = m.logit_scale.device
        loss, gr = micro_grads(m, {k: v.to(dev) for k, v in bt.items()},
                               step_cfg, params, loss_fn,
                               None if starts2 is None else starts2.to(dev))
        return float(loss), torch.cat([gr[n].float().flatten().cpu()
                                       for n in names]).double()

    b2 = tri_batch(torch, np, cfg, 2, rng, frames)
    ref = copy.deepcopy(model).to(device="cpu", dtype=torch.float32)
    bn0 = batch_norm_stats(torch, model)

    def cpu_pass():
        t = time.time()
        out = grads_of(ref, replace(sc, compute_dtype=torch.float32), b2)
        return out, time.time() - t

    ((loss_card, g_card), counts), ((loss_cpu, g_cpu), t_cpu), knn_line = \
        shared_knn_groups(torch, lambda: run_counted(
            torch, counters, totals, lambda: grads_of(model, sc, b2)), cpu_pass)
    bn_cpu = batch_norm_stats(torch, ref)
    del ref
    if counts != tri_train_launches(cfg, 1):
        fail(f"{tag} B=2 gradients: launches {counts}, expected "
             f"{tri_train_launches(cfg, 1)}")
    cos_g = (g_card @ g_cpu / (g_card.norm() * g_cpu.norm())).item()
    norm_card, norm_cpu = g_card.norm().item(), g_cpu.norm().item()
    if not (cos_g >= COS_MIN and abs(loss_card - loss_cpu) <= LOSS_TOL
            and abs(norm_card / norm_cpu - 1) <= NORM_TOL):
        fail(f"{tag} B=2 gradients vs CPU fp32: cosine {cos_g}, loss "
             f"{loss_card} vs {loss_cpu}, grad_norm {norm_card} vs {norm_cpu}")
    bn_line = ""
    if bn0:  # the running statistics' moves, card against CPU
        bn_card = batch_norm_stats(torch, model)
        moves = {k: cos_min(torch, (bn_card[k] - bn0[k])[None],
                            (bn_cpu[k] - bn0[k])[None]) for k in bn0}
        if min(moves.values()) < COS_MIN:
            fail(f"{tag} B=2: running statistics moved unlike the CPU's: "
                 f"cosines {moves}")
        bn_line = (f"; running statistics after the B=2 pass, cosine of "
                   f"their moves vs CPU fp32: " + ", ".join(
                       f"{k} {v:.6f}" for k, v in moves.items()))

    frozen0 = {n: p.detach().clone() for n, p in model.named_parameters()
               if not mask[n]}
    train0 = {n: p.detach().clone() for n, p in model.named_parameters()
              if mask[n]}
    state = init_train_state(model, tx)
    gen = torch.Generator(device="cuda").manual_seed(SEED) if pc else None
    per_step = []
    for label, b, accum in runs:
        step = make_train_step(cfg, tx, mask, replace(sc, accum_freq=accum))
        bt = tri_batch(torch, np, cfg, b, rng, frames)
        before = batch_norm_stats(torch, model)
        with batch_norm_trace(torch) as trace:
            (state, m), counts = run_counted(
                torch, counters, totals, lambda: step(state, bt, fps_generator=gen))
        if counts != tri_train_launches(cfg, accum):
            fail(f"{tag} {label}: launches {counts}, expected "
                 f"{tri_train_launches(cfg, accum)}")
        check_running_stats(torch, f"{tag} {label}", model, trace, before, accum)
        m = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"{tag} {label}: metrics {m}")
        per_step.append((label, round(m["loss"], 5), counts["fused_mlp"],
                         counts["fused_mlp_save_preact"],
                         counts["flash_attention"], counts["fps"],
                         counts["point_encoder"]))
    moved = [n for n, p in model.named_parameters() if not mask[n]
             and not torch.equal(p, frozen0[n])]
    still = [n for n, p in model.named_parameters() if mask[n]
             and torch.equal(p, train0[n])]
    if moved or still:
        fail(f"{tag}: frozen parameters that changed {moved[:5]}, trainable "
             f"ones that did not {still[:5]}")
    n_image = sum(1 for n in frozen0 if n.startswith("image."))
    del frozen0, train0
    print(f"[{tag}] vitlensL {modality} tri model, {flags}, {sc.n_tower} "
          f"towers, video_distill {sc.video_distill}, loss "
          f"{sc.contra_loss_type}: {count_trainable(model, mask)} trainable "
          f"parameters in {len(names)} tensors; B=2 vs CPU fp32: gradient "
          f"cosine {cos_g:.6f}, loss {loss_card:.5f} vs {loss_cpu:.5f}, "
          f"grad_norm {norm_card:.5f} vs {norm_cpu:.5f} (the CPU pass took "
          f"{t_cpu:.1f} s){knn_line}{bn_line}; steps (label, loss, launches plain, "
          f"save-preact, attention, FPS, point encoder) {per_step}; frozen "
          f"parameters bit-identical ({n_image} tensors of the image tower "
          f"among them), every trainable one changed"
          + (f"; each step's BatchNorm running statistics those of its "
             f"accum_freq cached passes ({len(bn0)} tensors)" if bn0 else "")
          + f"; phase took {time.time() - t0:.1f} s", flush=True)
    return model, state, tx, mask, sc


def profile_encode(torch, card, label, encode):
    """One call under torch.profiler: the top kernels by device time and the
    device's busy and idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        encode()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    for e in kernels[:15]:  # the top kernels by device time
        t = e.self_device_time_total / 1e3
        print(f"    {t:9.3f} ms {100 * t / busy_ms:5.1f}% {e.count:5d}x "
              f"{e.key[:110]}")
    print(f"[5 profile] {card} | {label} under the profiler: device busy "
          f"{busy_ms:.2f} ms of {wall_ms:.2f} ms wall (idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f})", flush=True)


def encode_rate(torch, card, label, encode, samples, rows_note="", dim=768):
    encode()
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        emb = encode()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    if tuple(emb.shape) != (samples, dim) or not torch.isfinite(emb).all():
        fail(f"{label}: bad output")
    best = min(runs)
    print(f"[5 timing] {card} | {label}: {samples / best:.2f} samples/s"
          f"{rows_note}, best of {len(runs)}: {best * 1e3:.2f} ms, all ms "
          f"{[round(r * 1e3, 2) for r in runs]}; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return samples / best


def encode_latency(torch, card, label, encode, runs=5):
    """Host-timed latency of one request: the best of ``runs`` calls, each
    ending in torch.cuda.synchronize(). Returns ms."""
    encode()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        encode()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"[5 timing] {card} | {label}: latency best of {runs} "
          f"{min(times):.2f} ms, all ms {[round(t, 2) for t in times]}", flush=True)
    return min(times)


def train_rate(torch, card, label, step, samples, runs=3):
    step()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    best = min(times)
    print(f"[5 timing] {card} | {label}: {samples / best:.2f} samples/s, best "
          f"of {runs}: {best * 1e3:.2f} ms, all ms "
          f"{[round(t * 1e3, 2) for t in times]}; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({resident / 1e9:.2f} "
          f"GB resident between steps)", flush=True)
    return samples / best


def tri_timings(torch, np, card, runs):
    """Phase 5's train-step rates: for each (trained phase, frames, batch
    sizes) of ``runs``, the step at the first size that fits, with its peak
    memory and one step under the profiler; a point-cloud step draws its
    FPS starts from a CUDA generator. Returns {name: (B, rate)}."""
    from vitlens_tpu_torch.train.step import make_train_step

    rng = np.random.RandomState(SEED)
    rates = {}
    for (model, state, tx, mask, sc), frames, sizes in runs:
        modality = model.cfg.tower.modality
        name = ("video distill" if sc.video_distill else f"{modality} tri")
        step = make_train_step(model.cfg, tx, mask, sc)
        gen = (torch.Generator(device="cuda").manual_seed(SEED)
               if modality == "pc" else None)
        for b in sizes:
            bt = {k: v.cuda() for k, v in
                  tri_batch(torch, np, model.cfg, b, rng, frames).items()}
            try:
                rate = train_rate(torch, card, f"{name} train step B{b} bf16 "
                                  f"(frozen image tower in bf16"
                                  + (f", {b * frames} frames a step" if frames
                                     else "") + ")",
                                  lambda: step(state, bt, fps_generator=gen), b)
            except torch.cuda.OutOfMemoryError:
                del bt
                torch.cuda.empty_cache()
                print(f"[5 timing] {card} | {name} train step B{b}: out of "
                      "device memory", flush=True)
                continue
            profile_encode(torch, card, f"B{b} {name} train step",
                           lambda: step(state, bt, fps_generator=gen))
            rates[name] = (b, rate)
            del bt
            break
        else:
            fail(f"{name} train step: no batch size fits")
        torch.cuda.empty_cache()
    return rates


def ball_query_bound(b, s, n, k):
    """Per (query, point) pair: the distance in the matmul form (3 products
    and 3 adds of the dot, 2 adds of the norms), the radius compare and the
    candidate select, then at least one compare of the k-smallest
    selection, on the fp32 cores; bytes: the bf16 points and queries read
    once, the int32 indices written once."""
    pairs = b * s * n
    return bound(11 * pairs, 2 * 3 * (b * n + b * s) + 4 * b * s * k, PEAK_FP32)


def vitlensG_timings(torch, card, model, b=16):
    """Phase 5's vitlensG pc encode: B16 clouds of 10000 x 6 (arrays given)
    with its peak memory and a profile; then the ball query at that
    encode's shape ([16, 512, 10000], 64 a ball, bf16 points) beside its
    bound. Returns the encode rate."""
    from vitlens_tpu_torch.ops.fps import ball_query, fps

    g = torch.Generator(device="cuda").manual_seed(SEED)
    pt = model.towers["pc"].cfg.point
    pc = torch.cat([torch.randn(b, pt.npoints, 3, generator=g, device="cuda") * 0.4,
                    torch.rand(b, pt.npoints, 3, generator=g, device="cuda")], -1)

    def encode():
        return model.encode({"pc": pc}, preprocessed=True)["pc"]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rate = encode_rate(torch, card, f"vitlensG pc encode B{b} x {pt.npoints} "
                       f"points x 6 bf16 (PNSA, bigG trunk, 32 of 48 blocks)",
                       encode, b, dim=1280)
    profile_encode(torch, card, f"B{b} vitlensG pc encode", encode)
    xyz = pc[..., :3].bfloat16().contiguous()
    centers = fps(xyz, pt.num_group)
    ms = cuda_ms(lambda: ball_query(xyz, centers, pt.radius, pt.group_size))
    bd, by = ball_query_bound(b, pt.num_group, pt.npoints, pt.group_size)
    print(f"[5 timing] {card} | ball query (plain PyTorch: the distance "
          f"product, torch.topk over int32 candidates) [{b}, {pt.num_group}, "
          f"{pt.npoints}] k {pt.group_size} bf16 points: {ms:.4f} ms, bound "
          f"{bd:.4f} ms ({by})", flush=True)
    return rate


def check_attention_edges(torch, g, err, checks):
    """Attention at the edges of its tiling: every NQ, NK in {1, 7, 77, 257,
    600} and NK of 833 and 2048 keys (more chunks than the ring holds),
    against the plain version; and the trunk's packed-qkv views and the
    Lens's q / to_kv views bit-equal to the same call on contiguous
    copies."""
    from vitlens_tpu_torch.ops.flash_attention import (attention_reference,
                                                       flash_attention)

    worst = 0.0
    for b, h, nq, nk in (*((2, 3, nq, nk) for nq in (1, 7, 77, 257, 600)
                           for nk in (1, 7, 77, 257, 600)),
                         (2, 2, 257, 833), (3, 1, 256, 2048)):
        q, k, v = qkv_inputs(torch, g, b, h, nq, nk)
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        want = attention_reference(q, k, v)
        e = rel_err(got, want)
        worst = max(worst, e)
        err["flash_attention"] = max(err["flash_attention"], abs_err(got, want))
        if not (torch.isfinite(got).all() and e <= ATTN_TOL):
            fail(f"flash_attention {b}x{h}x{nq}x{nk}: rel err {e} > {ATTN_TOL}")
    checks.append(f"attn-edges(NQ,NK in 1..600, NK 833, 2048)<={worst:.2e}")
    for label, b, nq, nk, h, packed in (("packed-qkv", 4, 257, 257, 16, True),
                                        ("packed-qkv", 2, 77, 77, 12, True),
                                        ("lens-cross", 4, 256, 600, 1, False),
                                        ("lens-self", 2, 256, 256, 16, False)):
        if packed:
            qkv = torch.randn(b, nq, 3 * h * 64, generator=g, device="cuda").bfloat16()
            q, k, v = qkv.view(b, nq, 3, h, 64).permute(2, 0, 3, 1, 4)
        else:
            q = torch.randn(b, nq, h * 64, generator=g, device="cuda").bfloat16()
            kv = torch.randn(b, nk, 2 * h * 64, generator=g, device="cuda").bfloat16()
            q = q.view(b, nq, h, 64).transpose(1, 2)
            k, v = kv.view(b, nk, 2, h, 64).permute(2, 0, 3, 1, 4)
        got = flash_attention(q, k, v)
        want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"flash_attention on {label} views B{b} NQ{nq} NK{nk} H{h}: "
                 "differs from the call on contiguous copies")
        checks.append(f"attn-{label}-views{b}x{h}x{nq}x{nk}=bit-equal")


OTHER_HEAD_DIMS = (32, 80, 88, 104, 112, 128)  # the trunks' head dims besides 64


def check_head_dims(torch, g, err, checks):
    """Attention at head dims other than 64 (the trunks of ViT-H-14,
    ViT-g-14, ViT-bigG-14 and ViT-e-14 have 80, 88, 104 and 112): every NQ,
    NK in {1, 77, 257, 600} on contiguous tensors and on the packed qkv
    projection's views, against the plain version (bf16, <= ATTN_TOL)."""
    from vitlens_tpu_torch.ops.flash_attention import (attention_reference,
                                                       flash_attention)

    for d in OTHER_HEAD_DIMS:
        worst = 0.0
        for nq in (1, 77, 257, 600):
            for nk in (1, 77, 257, 600):
                cases = [("", qkv_inputs(torch, g, 2, 3, nq, nk, d))]
                if nq == nk:  # the trunk's packed qkv, read in place
                    qkv = torch.randn(2, nq, 3 * 3 * d, generator=g,
                                      device="cuda").bfloat16()
                    cases.append((" packed-qkv views", tuple(
                        qkv.view(2, nq, 3, 3, d).permute(2, 0, 3, 1, 4))))
                for kind, args in cases:
                    got = flash_attention(*args)
                    torch.cuda.synchronize()
                    want = attention_reference(*args)
                    e = rel_err(got, want)
                    worst = max(worst, e)
                    err["flash_attention"] = max(err["flash_attention"],
                                                 abs_err(got, want))
                    if not (torch.isfinite(got).all() and e <= ATTN_TOL):
                        fail(f"flash_attention D={d} NQ={nq} NK={nk}{kind}: "
                             f"rel err {e} > {ATTN_TOL}")
        checks.append(f"attn-D{d}(NQ,NK in 1..600, packed views)<={worst:.2e}")


def check_int8_epilogues(torch, g, err, checks):
    """The quantise kernel bit-equal to its plain version at the quantized
    encode's shapes (its inputs' K: 1024 for qkv, out and fc, 4096 for proj)
    and at a ragged M, bf16 and fp32 input; the DEQUANT epilogue bit-equal
    to the plain dequantise of the same int32 product, with and without bias
    and in bf16 and fp32; and quant.int8_matmul on the card (quantise ->
    DEQUANT) bit-equal to its plain version end to end."""
    from vitlens_tpu_torch import quant
    from vitlens_tpu_torch.ops.int8_matmul import (
        dequant_reference, int8_matmul_dequant, int8_matmul_reference,
        int8_quantize, int8_quantize_reference)

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    m = 257 * B * 3
    # why the plain quantise divides by a tensor: PyTorch's CUDA division by
    # a Python scalar multiplies by the reciprocal instead
    a = torch.rand(1 << 16, generator=g, device="cuda") * 100
    n_recip = ((a / 127.0) != (a / a.new_tensor(127.0))).sum().item()
    checks.append(f"cuda-x/127.0-vs-IEEE-x/127:{n_recip}-of-65536-differ")
    err["int8_quantize"] = err["int8_matmul_dequant"] = 0.0
    for m_, k, dt in ((m, 1024, torch.bfloat16), (m, 4096, torch.bfloat16),
                      (1001, 3072, torch.bfloat16), (1001, 1024, torch.float32)):
        x = quant_rows(torch, g, m_, k, dt)
        xi, xs = int8_quantize(x)
        torch.cuda.synchronize()
        want_i, want_s = int8_quantize_reference(x)
        n_diff = (xi != want_i).sum().item() + (bits(xs) != bits(want_s)).sum().item()
        err["int8_quantize"] = max(err["int8_quantize"],
                                   (xs - want_s).abs().max().item())
        checks.append(f"quantize {m_}x{k}/{str(dt)[6:]}:{n_diff}-differ")
        if n_diff:
            fail(f"int8_quantize {m_}x{k} {dt}: {n_diff} of xi and xs differ "
                 "from the plain version")
        del x, xi, xs, want_i, want_s
    for m_, k, n in ((m, 1024, 4096), (m, 4096, 1024), (1001, 1024, 3072)):
        a, b, b_t = int8_inputs(torch, g, m_, k, n)
        acc = int8_matmul_reference(a, b)
        xs = torch.rand(m_, 1, generator=g, device="cuda") * 0.02 + 1e-4
        ws = torch.rand(1, n, generator=g, device="cuda") * 0.01 + 1e-5
        bias = torch.randn(n, generator=g, device="cuda")
        for bb, dt in ((bias, torch.bfloat16), (None, torch.bfloat16),
                       (bias, torch.float32)):
            got = int8_matmul_dequant(a, b, xs, ws, bb, dt, b_t)
            torch.cuda.synchronize()
            want = dequant_reference(acc, xs, ws, bb, dt)
            n_diff = (bits(got) != bits(want)).sum().item()
            err["int8_matmul_dequant"] = max(err["int8_matmul_dequant"],
                                             abs_err(got, want))
            checks.append(f"dequant {m_}x{k}x{n}/{'bias' if bb is not None else 'no-bias'}"
                          f"/{str(dt)[6:]}:{n_diff}-differ")
            if n_diff:
                fail(f"int8_matmul_dequant {m_}x{k}x{n} {dt}: {n_diff} elements "
                     "differ from the plain dequantise of the same product")
        del a, b, b_t, acc, got, want
    for m_, k, n in ((m, 1024, 3072), (77 * 8, 768, 2304)):  # end to end
        x = quant_rows(torch, g, m_, k, torch.bfloat16)
        w_q, w_s = quant.quantize_weight(torch.randn(k, n, generator=g, device="cuda") * 0.05)
        bias = torch.randn(n, generator=g, device="cuda")
        got = quant.int8_matmul(x, w_q, w_s, bias, w_q.t().contiguous())
        torch.cuda.synchronize()
        n_diff = (bits(got) != bits(quant.int8_matmul_reference(x, w_q, w_s, bias))).sum().item()
        checks.append(f"quant.int8_matmul {m_}x{k}x{n}:{n_diff}-differ")
        if n_diff:
            fail(f"quant.int8_matmul {m_}x{k}x{n} on the card: {n_diff} elements "
                 "differ from its plain version")
        del x, got


def check_new_kernels(torch, g, err, checks):
    """Phase 3, continued: the int8 product, the row gather, the chained
    fused MLPs and the fused LN + projection at the LN + qkv prototype's
    shape, each against its plain version on the card."""
    from vitlens_tpu_torch.ops.fused_ln_proj import (fused_ln_proj,
                                                     ln_proj_reference)
    from vitlens_tpu_torch.ops.fused_mlp_chain import (
        fused_attnout_mlp, fused_mlp_chain_reference, fused_mlp_chunked)
    from vitlens_tpu_torch.ops.int8_matmul import (int8_matmul,
                                                   int8_matmul_reference)
    from vitlens_tpu_torch.ops.row_gather import row_gather, row_gather_reference

    err["int8_matmul"] = 0.0
    for m, k, n in ((4096, 4096, 4096), (771 * 64, 1024, 3072), (1001, 4096, 1024)):
        a, b, b_t = int8_inputs(torch, g, m, k, n)
        got = int8_matmul(a, b, b_t)
        torch.cuda.synchronize()
        want = int8_matmul_reference(a, b)
        n_diff = (got != want).sum().item()
        err["int8_matmul"] = max(err["int8_matmul"],
                                 (got.long() - want.long()).abs().max().item())
        checks.append(f"int8 {m}x{k}x{n}:{n_diff}-differ")
        if n_diff:
            fail(f"int8_matmul {m}x{k}x{n}: {n_diff} elements differ from the "
                 "plain version (the product is exact)")
        del a, b, b_t, got, want
    v, d, j = 49408, 512, 9856
    table = torch.randn(v, d, generator=g, device="cuda").bfloat16()
    ids = torch.randint(0, v, (j,), generator=g, device="cuda", dtype=torch.int32)
    ids[:4] = torch.tensor([0, v - 1, 7, 7], dtype=torch.int32)
    got = row_gather(table, ids)
    torch.cuda.synchronize()
    want = row_gather_reference(table, ids)
    n_diff = (got.view(torch.int16) != want.view(torch.int16)).sum().item()
    err["row_gather"] = abs_err(got, want)
    checks.append(f"gather {v}x{d} J{j}:{n_diff}-differ")
    if n_diff:
        fail(f"row_gather: {n_diff} elements differ bitwise from table[ids]")
    err["fused_mlp_chunked"] = err["fused_attnout_mlp"] = 0.0
    for m, d, h in ((16448, 1024, 4096), (1001, 1024, 4096), (777, 256, 1024),
                    (300, 128, 512)):
        x, *mlp = mlp_inputs(torch, g, m, d, h)
        proj = outproj_inputs(torch, g, m, d)
        for act in ("gelu_tanh", "gelu"):
            for name, got, want in (
                    ("fused_mlp_chunked", fused_mlp_chunked(x, *mlp, act=act),
                     fused_mlp_chain_reference(x, *mlp, act=act)),
                    ("fused_attnout_mlp",
                     fused_attnout_mlp(x, *proj, *mlp, act=act),
                     fused_mlp_chain_reference(x, *mlp, act=act, outproj=proj))):
                torch.cuda.synchronize()
                e = rel_err(got, want)
                err[name] = max(err[name], abs_err(got, want))
                checks.append(f"{name} M{m}xD{d}/{act}={e:.2e}")
                if not (torch.isfinite(got).all() and e <= CHAIN_TOL):
                    fail(f"{name} M={m} D={d} {act}: rel err {e} > {CHAIN_TOL}")
        del x, mlp, proj
    a = ln_proj_inputs(torch, g, 16448, 1024, 3072)
    got = fused_ln_proj(*a)
    torch.cuda.synchronize()
    want = ln_proj_reference(*a)
    e = rel_err(got, want)
    err["fused_ln_qkv"] = abs_err(got, want)
    checks.append(f"ln_qkv 16448x1024x3072={e:.2e}")
    if not (torch.isfinite(got).all() and e <= LNP_TOL):
        fail(f"fused_ln_proj at the LN + qkv prototype's shape: rel err {e} > "
             f"{LNP_TOL}")


def run_counted(torch, counters, totals, fn):
    """fn() with every launch count set to 0 just before and read just
    after; the counts are added to the main-path totals."""
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    counts = {name: c.launches for name, c in counters.items()}
    for name, n in counts.items():
        totals[name] += n
    return out, counts


def cos_min(torch, a, b):
    return torch.nn.functional.cosine_similarity(
        a.float().cpu(), b.float().cpu(), dim=-1).min().item()


FP32_COS_MIN = 0.999  # fp32 on the card against fp32 on the CPU


def transformer_lens_phase(torch, counters, totals):
    """Phase 4t: a vitlensL depth tower whose Lens is the transformer Lens
    (2 trunk-width blocks; no released config uses it) at full width and
    depth, random weights from a seeded generator: a B = 2 bf16 encode on
    the card with the launches derived from the config (26 fused MLP + 26
    attention) and cosine >= 0.99 against the same tower in fp32 on the
    CPU."""
    from vitlens_tpu_torch.config import make_model_config
    from vitlens_tpu_torch.factory import cast_matmul_weights_, make_generator
    from vitlens_tpu_torch.models.vit import VisionTower

    t0 = time.time()
    cfg = make_model_config("ViT-L-14", "depth").tower
    cfg = dataclasses.replace(cfg, perceiver=dataclasses.replace(
        cfg.perceiver, as_identity=False, as_transformer=True, depth=2))
    tower = VisionTower(cfg, device="cuda")
    tower.init_(make_generator(SEED, "cuda"))
    ref = copy.deepcopy(tower).to(device="cpu")
    cast_matmul_weights_(tower, torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    x = torch.randn(2, 1, 224, 224, generator=g, device="cuda")
    with torch.inference_mode():
        emb, counts = run_counted(torch, counters, totals,
                                  lambda: tower(x, torch.bfloat16))
        want = ref(x.cpu())
    if counts != tower_launches(cfg) or counts["fused_mlp"] != 26:
        fail(f"4t transformer Lens: launches {counts}, expected "
             f"{tower_launches(cfg)}")
    cos = cos_min(torch, emb, want)
    if cos < COS_MIN or not torch.isfinite(emb).all():
        fail(f"4t transformer Lens: cosine vs CPU fp32 {cos} < {COS_MIN}")
    print(f"[4t transformer Lens] vitlensL depth tower with a 2-block "
          f"transformer Lens, B=2 bf16: launches (fused MLP, attention) "
          f"{counts['fused_mlp']}, {counts['flash_attention']}; cosine vs CPU "
          f"fp32 {cos:.6f}; phase took {time.time() - t0:.1f} s", flush=True)


def fp32_phase(torch, counters, totals, fb2, clouds2, captions2):
    """Phase 4f: the default ViTLens (compute fp32, as in JAX) encodes B = 2
    of each modality on the card through the plain paths (the kernels take
    bf16): no fused MLP, attention or point-encoder launch, the FPS launch as
    in bf16; against the same model in fp32 on the CPU."""
    from vitlens_tpu_torch.api import ViTLens

    t0 = time.time()
    model = ViTLens("vitlensL", ("audio", "pc", "text"), device="cuda", seed=SEED)
    if model.compute_dtype != torch.float32:
        fail(f"ViTLens's default compute dtype is {model.compute_dtype}, not fp32")
    ref = copy.deepcopy(model).to("cpu")
    want = {"audio": launch_counts(), "pc": launch_counts(fps=1),
            "text": launch_counts()}
    cos, per_call = {}, []
    for path, data, pre in (("audio", fb2, True), ("pc", clouds2, True),
                            ("text", captions2, False)):
        emb, counts = run_counted(torch, counters, totals,
                                  lambda: model.encode({path: data}, preprocessed=pre)[path])
        if counts != want[path]:
            fail(f"fp32 {path} B=2: launches {counts}, expected {want[path]}")
        if tuple(emb.shape) != (2, 768) or not torch.isfinite(emb).all():
            fail(f"fp32 {path} B=2: shape {tuple(emb.shape)} or non-finite values")
        cpu_data = data.cpu() if isinstance(data, torch.Tensor) else data
        cos[path] = cos_min(torch, emb, ref.encode({path: cpu_data},
                                                   preprocessed=pre)[path])
        per_call.append((path, counts["fps"]))
    # cuDNN runs the audio adapter's fp32 convolution in TF32 by default
    # (fp32 products outside it stay fp32): the same encode without it.
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cos_no_tf32 = cos_min(torch, model.encode({"audio": fb2}, preprocessed=True)["audio"],
                              ref.encode({"audio": fb2.cpu()}, preprocessed=True)["audio"])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    del model, ref
    if min(cos.values()) < FP32_COS_MIN:
        fail(f"fp32 card vs CPU: min cosine {cos} < {FP32_COS_MIN}")
    print(f"[4f fp32 default] ViTLens('vitlensL', ('audio', 'pc', 'text')) "
          f"(compute fp32) on the card, B=2 each: no fused MLP, attention or "
          f"point-encoder launch, FPS launches per request {per_call}; min "
          f"cosine vs CPU fp32: audio {cos['audio']:.7f} (cudnn.allow_tf32="
          f"{tf32}; {cos_no_tf32:.7f} with it off), pc {cos['pc']:.7f}; "
          f"torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}; phase took "
          f"{time.time() - t0:.1f} s with the CPU run", flush=True)
    print(f"[4f fp32 default] text encode B=2 (ResBlock plain MLP, masked "
          f"plain_attention): min cosine vs CPU fp32 {cos['text']:.7f}, no "
          f"kernel launch", flush=True)


HD_DEPTH = 4  # trunk blocks kept in the head-dim phase (the CPU run stays short)


def head_dim_phase(torch, counters, totals, fb1):
    """Phase 4h: bf16 B = 1 audio encodes at full width whose trunks have
    head dims other than 64, on the card against the CPU in fp32, with
    launch counts derived from the config: ViTLens("vitlensG", ("audio",))
    (ViT-bigG-14, head dim 104) and a ViT-H-14 audio tower (head dim 80),
    each trunk cut to HD_DEPTH blocks."""
    from dataclasses import replace

    from vitlens_tpu_torch.api import ViTLens
    from vitlens_tpu_torch.config import make_model_config
    from vitlens_tpu_torch.factory import cast_matmul_weights_, make_generator
    from vitlens_tpu_torch.models.vit import VisionTower

    t0 = time.time()
    big = ViTLens("vitlensG", ("audio",), device="cuda",
                  compute_dtype=torch.bfloat16, seed=SEED)
    big.towers["audio"].trunk.blocks = big.towers["audio"].trunk.blocks[:HD_DEPTH]
    torch.cuda.empty_cache()
    cfg = make_model_config("ViT-H-14", "audio").tower
    h14 = VisionTower(replace(cfg, arch=replace(cfg.arch, layers=HD_DEPTH)),
                      device="cuda")
    h14.init_(make_generator(SEED, "cuda"))
    cast_matmul_weights_(h14, torch.bfloat16)
    clips = fb1.reshape((-1,) + tuple(fb1.shape[2:]))  # [3, T, F]

    def h14_encode(tower, x, dtype):
        f = tower(x, dtype).float().mean(dim=0, keepdim=True)
        return f / f.norm(dim=-1, keepdim=True)

    lines = []
    for label, net, encode, ref_encode in (
            ("vitlensG audio (ViT-bigG-14, head dim 104)", big,
             lambda m: m.encode({"audio": fb1}, preprocessed=True)["audio"],
             lambda m: m.encode({"audio": fb1.cpu()}, preprocessed=True)["audio"]),
            ("ViT-H-14 audio tower (head dim 80)", h14,
             lambda m: h14_encode(m, clips, torch.bfloat16),
             lambda m: h14_encode(m, clips.cpu(), torch.float32))):
        tcfg = net.towers["audio"].cfg if net is big else net.cfg
        heads = tcfg.arch.width // tcfg.arch.heads
        want = launch_counts(
            fused_mlp=HD_DEPTH,
            flash_attention=HD_DEPTH + tcfg.perceiver.depth * (
                1 + tcfg.perceiver.self_per_cross_attn))
        emb, counts = run_counted(torch, counters, totals, lambda: encode(net))
        if counts != want:
            fail(f"{label}: launches {counts}, expected {want}")
        if tuple(emb.shape) != (1, tcfg.embed_dim) or not torch.isfinite(emb).all():
            fail(f"{label}: shape {tuple(emb.shape)} or non-finite values")
        ref = copy.deepcopy(net).to(device="cpu", dtype=torch.float32)
        if net is big:
            ref.compute_dtype = torch.float32
        cos = cos_min(torch, emb, ref_encode(ref))
        del ref
        if cos < COS_MIN:
            fail(f"{label}: cosine vs CPU fp32 {cos} < {COS_MIN}")
        lines.append(f"{label}, width {tcfg.arch.width}, head dim {heads}: "
                     f"launches (fused MLP, attention) {counts['fused_mlp']}, "
                     f"{counts['flash_attention']}; cosine vs CPU fp32 {cos:.6f}")
    del big, h14
    torch.cuda.empty_cache()
    print(f"[4h head dims] bf16 B=1 x 3 clips audio encodes at full width, each "
          f"trunk cut to {HD_DEPTH} blocks (the CPU fp32 run stays short): "
          + "; ".join(lines) + f"; phase took {time.time() - t0:.1f} s", flush=True)


def quant_phase(torch, model, counters, totals, fb1, fb64, captions, want):
    """Phase 4q: the audio tower quantized to int8 on the card and driven
    through ViTLens.encode. Returns the quantized model."""
    from vitlens_tpu_torch.quant import (is_quantized, quantize_model,
                                         quantize_weight)

    t0 = time.time()
    qmodel = quantize_model(model, towers=("towers.audio",))
    tower, source = qmodel.towers["audio"], model.towers["audio"]
    if (not is_quantized(tower) or is_quantized(source)
            or is_quantized(qmodel.towers["text"])
            or tower.trunk.blocks[0].mlp.fc.w is not None):
        fail("quantize_model: the copy's audio trunk must be quantized, "
             "nothing else")
    last = len(source.trunk.blocks) - 1
    for i in (0, last):
        fb, qb = source.trunk.blocks[i], tower.trunk.blocks[i]
        for name, w, q, q_t, s_card in (
                ("qkv", fb.attn.qkv_w, qb.attn.qkv_w_q, qb.attn.qkv_w_qt,
                 qb.attn.qkv_w_s),
                ("out", fb.attn.out_w, qb.attn.out_w_q, qb.attn.out_w_qt,
                 qb.attn.out_w_s),
                ("fc", fb.mlp.fc.w, qb.mlp.fc.w_q, qb.mlp.fc.w_qt, qb.mlp.fc.w_s),
                ("proj", fb.mlp.proj.w, qb.mlp.proj.w_q, qb.mlp.proj.w_qt,
                 qb.mlp.proj.w_s)):
            q_cpu, s_cpu = quantize_weight(w.cpu())
            if not (torch.equal(q.cpu(), q_cpu) and torch.equal(q_t.cpu(), q_cpu.t())
                    and torch.equal(s_card.cpu(), s_cpu)):
                fail(f"block {i} {name}: w_q or w_s made on the card differs "
                     "from the one made on the CPU")
    embs, per_call = {}, []
    for label, b, key, inputs in (("audio B=1", 1, "audio", {"audio": fb1}),
                                  (f"audio B={B}", B, "audio", {"audio": fb64}),
                                  ("text", len(captions), "text",
                                   {"text": captions})):
        emb, counts = run_counted(
            torch, counters, totals,
            lambda: qmodel.encode(inputs, preprocessed=key == "audio")[key])
        if counts != want[key]:
            fail(f"quantized {label}: launches {counts}, expected {want[key]}")
        norm_err = (emb.float().norm(dim=-1) - 1).abs().max().item()
        if (tuple(emb.shape) != (b, 768) or not torch.isfinite(emb).all()
                or norm_err > 1e-3):
            fail(f"quantized {label}: shape {tuple(emb.shape)}, norms off 1 by "
                 f"{norm_err}, or non-finite values")
        embs[label] = emb.float()
        per_call.append((label, counts["int8_matmul_dequant"],
                         counts["int8_quantize"], counts["flash_attention"],
                         counts["fused_mlp"]))
    # the text tower quantized too: D = 768 products on a ragged M = B * 77
    both = quantize_model(qmodel, towers=("towers.text",))
    temb, counts = run_counted(torch, counters, totals,
                               lambda: both.encode({"text": captions})["text"].float())
    if counts != want["text_int8"]:
        fail(f"quantized text: launches {counts}, expected {want['text_int8']}")
    per_call.append(("text, int8 tower", counts["int8_matmul_dequant"],
                     counts["int8_quantize"], counts["flash_attention"],
                     counts["fused_mlp"]))
    del both
    # what the int8 encodes are held against (these launches are not counted)
    floats = {label: model.encode({"audio": fb}, preprocessed=True)["audio"].float()
              for label, fb in (("audio B=1", fb1), (f"audio B={B}", fb64))}
    qref = copy.deepcopy(qmodel).to(device="cpu", dtype=torch.float32)
    qref.compute_dtype = torch.float32
    cpu1 = qref.encode({"audio": fb1.cpu()}, preprocessed=True)["audio"]
    del qref

    cos = {"B=1 int8 card vs quantized fp32 CPU": cos_min(torch, embs["audio B=1"], cpu1),
           "B=1 int8 vs float bf16, card": cos_min(torch, embs["audio B=1"],
                                                   floats["audio B=1"]),
           f"B={B} int8 vs float bf16, card": cos_min(torch, embs[f"audio B={B}"],
                                                      floats[f"audio B={B}"]),
           "text int8 vs float bf16, card": cos_min(torch, temb, embs["text"])}
    if min(cos.values()) < COS_MIN:
        fail(f"quantized audio encode: min cosine {cos} < {COS_MIN}")
    print(f"[4q quantized] vitlensL audio trunk quantized to int8 on the card "
          f"(w_q, its transposed copy and w_s equal to the CPU's for blocks 0 "
          f"and {last}); requests (label, DEQUANT products, quantise, "
          f"attention, fused MLP launches) {per_call}; min cosine: "
          + "; ".join(f"{k} {v:.6f}" for k, v in cos.items())
          + f"; phase took {time.time() - t0:.1f} s with the CPU fp32 run",
          flush=True)
    return qmodel


SCRIPT_RUNS = (  # (entry point, arguments, the counter its kernel adds to)
    ("fused_mlp_chunked", ["--iters", "5"], "fused_mlp_chunked"),
    ("fused_ln_qkv", ["--iters", "5"], "fused_ln_proj"),
    ("fused_attnout_mlp", ["--iters", "5"], "fused_attnout_mlp"),
    ("bench_int8_native", ["--iters", "10"], "int8_matmul"),
    ("bench_dma_gather", ["--iters", "50"], "row_gather"),
    ("bench_int8_encode", ["--iters", "3"], "int8_matmul_dequant"))


def scripts_phase(torch, counters, totals):
    """Phase 4s: the bench entry points, in this process, each with the
    launches of its kernel. Returns {entry point: launches}."""
    import importlib

    by_script = {}
    for name, argv, kernel in SCRIPT_RUNS:
        module = importlib.import_module(f"vitlens_tpu_torch.scripts.{name}")
        print(f"[4s scripts] python -m vitlens_tpu_torch.scripts.{name} "
              f"{' '.join(argv)}", flush=True)
        rc, counts = run_counted(torch, counters, totals, lambda: module.main(argv))
        if rc != 0 or counts[kernel] == 0:
            fail(f"scripts.{name}: exit code {rc}, {kernel} launches "
                 f"{counts[kernel]}")
        by_script[name] = counts[kernel]
    print(f"[4s scripts] every entry point exited 0; launches of its kernel: "
          f"{by_script}", flush=True)
    return by_script


def time_new_kernels(torch, g, timings):
    """Phase 5, continued: the int8 product's two epilogues and the quantise
    kernel, the row gather (its device time, and the wrapper's time back to
    back and its host time a call, beside index_select's) and the chained
    fused MLPs at their shapes, beside plain, library and bound."""
    from vitlens_tpu_torch.ops.fused_mlp import fused_mlp
    from vitlens_tpu_torch.ops.fused_mlp_chain import (
        fused_attnout_mlp, fused_mlp_chain_reference, fused_mlp_chunked)
    from vitlens_tpu_torch.ops.int8_matmul import (
        dequant_reference, int8_matmul, int8_matmul_dequant, int8_matmul_reference,
        int8_quantize, int8_quantize_reference)
    from vitlens_tpu_torch.ops.row_gather import row_gather, row_gather_reference

    m = 257 * B * 3  # the quantized B64 x 3 clips encode's rows
    for label, (m_, k, n) in (("quantized trunk fc", (m, 1024, 4096)),
                              ("quantized trunk qkv", (m, 1024, 3072)),
                              ("quantized trunk out", (m, 1024, 1024)),
                              ("quantized trunk proj", (m, 4096, 1024)),
                              ("prototype", (4096, 4096, 4096))):
        a, b, b_t = int8_inputs(torch, g, m_, k, n)
        lib_ms = cuda_ms(lambda: torch._int_mm(a, b))
        k_ms, p_ms = paired_ms(lambda: int8_matmul(a, b, b_t),
                               lambda: int8_matmul_reference(a, b), plain_iters=3)
        bd, by = int8_bound(m_, k, n)
        timings["int8_matmul"].append(
            {"shape": f"INT32, {label} M={m_} K={k} N={n}", "ms": k_ms,
             "plain_ms": p_ms, "bound_ms": bd, "bound_by": by,
             "library_ms": lib_ms, "tops": 2 * m_ * k * n / k_ms / 1e9})
        xs = torch.rand(m_, 1, generator=g, device="cuda") * 0.02 + 1e-4
        ws = torch.rand(1, n, generator=g, device="cuda") * 0.01 + 1e-5
        bias = torch.randn(n, generator=g, device="cuda")
        k_ms, p_ms = paired_ms(
            lambda: int8_matmul_dequant(a, b, xs, ws, bias, torch.bfloat16, b_t),
            lambda: dequant_reference(int8_matmul_reference(a, b), xs, ws, bias,
                                      torch.bfloat16), plain_iters=3)
        bd, by = dequant_bound(m_, k, n)
        timings["int8_matmul_dequant"].append(
            {"shape": f"DEQUANT to bf16 with bias, {label} M={m_} K={k} N={n}",
             "ms": k_ms, "plain_ms": p_ms, "bound_ms": bd, "bound_by": by,
             "library_ms": lib_ms, "tops": 2 * m_ * k * n / k_ms / 1e9})
        del a, b, b_t
    for label, k in (("qkv, out and fc inputs", 1024), ("proj input", 4096)):
        x = quant_rows(torch, g, m, k, torch.bfloat16)
        k_ms, p_ms = paired_ms(lambda: int8_quantize(x),
                               lambda: int8_quantize_reference(x), plain_iters=5)
        bd, by = quantize_bound(m, k, 2)
        timings["int8_quantize"].append(
            {"shape": f"{label} [{m},{k}] bf16", "ms": k_ms, "plain_ms": p_ms,
             "bound_ms": bd, "bound_by": by, "library_ms": None})
        del x
    v, d, j = 49408, 512, 9856
    table = torch.randn(v, d, generator=g, device="cuda").bfloat16()
    ids = torch.randint(0, v, (j,), generator=g, device="cuda", dtype=torch.int32)

    def gather():
        return row_gather(table, ids)

    def index_select():
        return torch.index_select(table, 0, ids)

    wrapper_ms, p_ms = paired_ms(gather, lambda: row_gather_reference(table, ids),
                                 iters=100, plain_iters=100)
    bd, by = gather_bound(j, 2 * d)
    # the kernel's own time is its device time; back to back through the
    # Python wrapper the host's enqueue can be the longer
    timings["row_gather"].append(
        {"shape": f"table [{v},{d}] bf16, {j} ids", "ms": device_ms(torch, gather),
         "plain_ms": p_ms, "bound_ms": bd, "bound_by": by,
         "library_ms": cuda_ms(index_select, 100), "wrapper_ms": wrapper_ms,
         "library_device_ms": device_ms(torch, index_select),
         "host_us": host_us(torch, gather),
         "library_host_us": host_us(torch, index_select)})
    m, d, h = 257 * B, 1024, 4096
    x, *mlp = mlp_inputs(torch, g, m, d, h)
    proj = outproj_inputs(torch, g, m, d)
    ctx, wo, bo = proj

    def today():  # the library's out-projection + residual, then kernel 1
        return fused_mlp(x + (ctx @ wo + bo.to(x.dtype)), *mlp, act="gelu")

    for act in ("gelu_tanh", "gelu"):
        k_ms, p_ms = paired_ms(
            lambda: fused_mlp_chunked(x, *mlp, act=act),
            lambda: fused_mlp_chain_reference(x, *mlp, act=act), plain_iters=3)
        bd, by = chain_bound(m, d, h, False)
        timings["fused_mlp_chunked"].append(
            {"shape": f"M={m} D={d} H={h} {act}", "ms": k_ms, "plain_ms": p_ms,
             "bound_ms": bd, "bound_by": by, "library_ms": None,
             "tflops": 4 * m * d * h / k_ms / 1e9,
             **({"three_launch_ms": cuda_ms(lambda: fused_mlp(x, *mlp, act="gelu"))}
                if act == "gelu" else {})})
        k_ms, p_ms = paired_ms(
            lambda: fused_attnout_mlp(x, *proj, *mlp, act=act),
            lambda: fused_mlp_chain_reference(x, *mlp, act=act, outproj=proj),
            plain_iters=3)
        bd, by = chain_bound(m, d, h, True)
        timings["fused_attnout_mlp"].append(
            {"shape": f"M={m} D={d} H={h} {act}", "ms": k_ms, "plain_ms": p_ms,
             "bound_ms": bd, "bound_by": by, "library_ms": None,
             "tflops": (2 * m * d * d + 4 * m * d * h) / k_ms / 1e9,
             **({"today_split_ms": cuda_ms(today)} if act == "gelu" else {})})


SERVE_COS_MIN = 0.999  # a served reply against a direct encode of the same items
LENS_FILE = ("audio", "pc", "depth", "eeg", "video")  # the merged export's towers
FBANK_TOL = 1e-3       # cuFFT against pocketfft, on the normalised fbank


def _tone(np, rate, seconds, channels, seed):
    """A tone over noise 30 dB down: float64 [channels, T] in [-1, 1)."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(rate * seconds)) / rate
    f = 220.0 * (1 + seed % 5) + 110.0 * np.arange(channels)[:, None]
    return 0.4 * np.sin(2 * np.pi * f * t) + 0.013 * rng.randn(channels, t.size)


def write_inputs(torch, np, root):
    """Phase 4v's files: WAV (16 kHz mono 5 s, 44.1 kHz stereo 12 s, 8 kHz
    1.5 s), one FLAC (the tests' minimal writer), PNG and JPEG images at
    320 x 240 in RGB and grayscale, .npy clouds of 9000 points, disparity
    maps (a 240 x 320 .npy, a 300 x 200 16-bit .png), an EEG recording [128,
    500] as .pt, a directory of 12 JPEG frames at 320 x 240, and the
    reference-layout checkpoints: a merged export (vitlens.{audio, pc,
    depth, eeg, video}.*) and a CLIP file (visual.* and the text keys),
    fp16, from a seeded generator."""
    from PIL import Image

    from tools.reference_layout import (clip_state_dict, merged_state_dict,
                                        pcm_from_float, vision_tower_state_dict,
                                        write_flac, write_wav)
    from vitlens_tpu_torch.config import make_model_config

    f = {}
    for name, (rate, secs, ch) in {"wav16k": (16000, 5.0, 1),
                                   "wav44k": (44100, 12.0, 2),
                                   "wav8k": (8000, 1.5, 1),
                                   "wav10s": (16000, 10.0, 1)}.items():
        f[name] = os.path.join(root, name + ".wav")
        write_wav(f[name], pcm_from_float(_tone(np, rate, secs, ch, len(f)), 16), rate)
    f["flac"] = os.path.join(root, "a.flac")
    write_flac(f["flac"], pcm_from_float(_tone(np, 16000, 3.0, 2, 7), 16), 16000,
               16, "fixed", 2, "mid_side")
    rng = np.random.RandomState(SEED)
    yy, xx = np.mgrid[0:240, 0:320]
    rgb = np.stack([xx / 320, yy / 240, (xx + yy) / 560], -1) * 200
    rgb = np.clip(rgb + rng.randint(0, 55, rgb.shape), 0, 255).astype(np.uint8)
    for ext in ("png", "jpg"):
        for mode in ("RGB", "L"):
            f[f"{ext}_{mode}"] = os.path.join(root, f"im_{mode}.{ext}")
            Image.fromarray(rgb, "RGB").convert(mode).save(f[f"{ext}_{mode}"])
    for i in range(2):
        f[f"npy{i}"] = os.path.join(root, f"cloud{i}.npy")
        np.save(f[f"npy{i}"], (rng.randn(9000, 3) * 0.3).astype(np.float32))
    # disparity: a ramp across the clamp range (0.01 .. 75) with noise
    f["depth_npy"] = os.path.join(root, "disparity.npy")
    np.save(f["depth_npy"], (80 * (xx / 320) * (yy / 240)
                             + 3 * rng.rand(240, 320)).astype(np.float32))
    f["depth_png"] = os.path.join(root, "disparity.png")
    Image.fromarray((rng.rand(300, 200) * 5e4).astype(np.uint16)).save(f["depth_png"])
    f["eeg_pt"] = os.path.join(root, "eeg.pt")
    t = np.arange(500) / 1000.0
    eeg = np.sin(2 * np.pi * (5 + np.arange(128))[:, None] * t) + 0.3 * rng.randn(128, 500)
    torch.save(torch.from_numpy(eeg.astype(np.float32)), f["eeg_pt"])
    f["frames"] = os.path.join(root, "clip_frames")
    os.makedirs(f["frames"])
    for i in range(12):  # the image above, drifting a few pixels a frame
        Image.fromarray(np.roll(rgb, 7 * i, axis=1), "RGB").save(
            os.path.join(f["frames"], f"{i:04d}.jpg"))
    g = torch.Generator(device="cuda").manual_seed(SEED)
    half = torch.float16
    towers = {m: vision_tower_state_dict(make_model_config("ViT-L-14", m).tower,
                                         g, half) for m in LENS_FILE}
    merged = merged_state_dict(towers)
    clip = clip_state_dict(make_model_config("ViT-L-14", "image"), g, half)
    f["all"] = os.path.join(root, "vitlensL_merged.pt")
    f["clip"] = os.path.join(root, "clip_vitl14.pt")
    torch.save({"epoch": 1, "state_dict": merged}, f["all"])
    torch.save(clip, f["clip"])
    return f, merged, clip


def _post(port, payload, timeout=600):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/encode", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _healthz(port):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=60) as r:
        return json.loads(r.read())


def _serve(make_server, model, max_batch, max_wait_ms):
    import threading

    srv = make_server(model, port=0, max_batch=max_batch, max_wait_ms=max_wait_ms)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv, th


def _stop(srv, th):
    """Stop accepting, drain, close; both workers must have exited."""
    srv.shutdown()
    srv.encoder.close()
    srv.server_close()
    th.join(30)
    enc = srv.encoder
    alive = [t.name for t in (enc._worker, enc._pre_worker, th)
             if t is not None and t.is_alive()]
    if alive:
        fail(f"threads still alive after the drain: {alive}")


def vitlensG_phase(torch, np, counters, totals):
    """Phase 4g: ViTLens("vitlensG", ("pc", "text")) on the card in bf16
    (weights stored in bf16, as the serve CLI stores vitlensG's), loaded
    from reference-layout checkpoints that tools/reference_layout.py writes
    (fp16): the PNSA tokenizer over 10000 xyz + rgb points, the bigG Lens
    and the ViT-bigG-14 trunk with its first 16 of 48 blocks skipped (they
    still hold the file's weights), and the bigG text tower. B = 1 and B = 2
    encodes of raw .npy clouds of 10000 x 6 and of xyz-only clouds
    (OpenShape's 0.4 grey fills their rgb), with the launches per request
    from tower_launches (1 FPS, 32 trunk blocks, 4 Lens layers; no point
    encoder) and cosine >= 0.99 against the same weights in fp32 on the CPU,
    given the processor's clouds rounded through bf16 as the card sees
    them; a text request (32 fused MLP); then one HTTP request of two
    clouds and a caption through make_server, cosine >= 0.999 against the
    direct encodes. Returns the model, for phase 5."""
    import tempfile

    from tools.reference_layout import (text_tower_state_dict,
                                        vision_tower_state_dict)
    from vitlens_tpu_torch.api import ViTLens
    from vitlens_tpu_torch.config import make_model_config
    from vitlens_tpu_torch.serve import make_server
    from vitlens_tpu_torch.train.openshape import vitlensG_tower_config

    t0 = time.time()
    root = tempfile.mkdtemp(prefix="vitlens_4g_")
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    tcfg, cfg = vitlensG_tower_config(), make_model_config("ViT-bigG-14", "image")
    files = {"pc": os.path.join(root, "vitlensG_pc.pt"),
             "text": os.path.join(root, "bigG_text.pt")}
    sd = vision_tower_state_dict(tcfg, g, torch.float16)
    torch.save(sd, files["pc"])
    want_w = {"sa.0.conv.w": sd["visual_adapter.sa.mlp_convs.0.weight"][..., 0, 0].T,
              "trunk.blocks.0.attn.qkv_w":  # a skipped block
                  sd["transformer.resblocks.0.attn.in_proj_weight"].T}
    del sd
    torch.save(text_tower_state_dict(cfg.text, cfg.embed_dim, g, torch.float16),
               files["text"])
    rng = np.random.RandomState(SEED + 7)
    for i in range(2):
        files[f"npy{i}"] = os.path.join(root, f"cloud{i}.npy")
        np.save(files[f"npy{i}"], np.concatenate(
            [rng.randn(10000, 3) * 0.4, rng.rand(10000, 3)], 1).astype(np.float32))
    files["xyz"] = os.path.join(root, "xyz_only.npy")
    np.save(files["xyz"], (rng.randn(10000, 3) * 0.4).astype(np.float32))
    t_files = time.time() - t0

    t0 = time.time()
    model = ViTLens("vitlensG", ("pc", "text"), device="cuda",
                    compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                    seed=SEED, checkpoints={"pc": files["pc"],
                                            "text": files["text"]})
    torch.cuda.synchronize()
    t_load = time.time() - t0
    tower = model.towers["pc"]
    got_w = {"sa.0.conv.w": tower.adapter.sa[0].conv.w,
             "trunk.blocks.0.attn.qkv_w": tower.trunk.blocks[0].attn.qkv_w}
    for name, want in want_w.items():
        if not torch.equal(got_w[name].cpu(), want.float().to(torch.bfloat16)):
            fail(f"4g: loaded {name} differs from the checkpoint's")
    proc = model.processors["pc"]
    if (proc.n, proc.channels) != (10000, 6) or tower.cfg.point.tokenizer != "pnsa":
        fail(f"4g: pc processor {proc.n} x {proc.channels}, tokenizer "
             f"{tower.cfg.point.tokenizer}")
    n_text = model.towers["text"].cfg.layers
    want = {"pc": tower_launches(tower.cfg, fps=1),
            "text": launch_counts(fused_mlp=n_text)}
    if (want["pc"]["fused_mlp"], want["pc"]["flash_attention"]) != (32, 40):
        fail(f"4g: launches derived from the vitlensG pc config {want['pc']}")
    requests = [("pc", [files["npy0"]]), ("pc", [files["npy0"], files["npy1"]]),
                ("pc", [files["xyz"]]), ("pc", [files["npy1"], files["xyz"]]),
                ("text", ["a wooden chair with four legs"])]
    outs, per_req = [], []
    for m, items in requests:
        emb, counts = run_counted(torch, counters, totals,
                                  lambda: model.encode({m: items})[m])
        if counts != want[m]:
            fail(f"4g {m} B={len(items)}: launches {counts}, expected {want[m]}")
        if (tuple(emb.shape) != (len(items), 1280)
                or not torch.isfinite(emb).all()):
            fail(f"4g {m} B={len(items)}: shape {tuple(emb.shape)} or "
                 "non-finite values")
        outs.append((m, items, emb))
        per_req.append((m, len(items), counts["fused_mlp"],
                        counts["flash_attention"], counts["fps"]))

    t0 = time.time()
    ref = copy.deepcopy(model).to(device="cpu", dtype=torch.float32)
    ref.compute_dtype = torch.float32
    cos = {}
    for m, items, emb in outs:
        if m == "pc":  # the processor's clouds as the card's bf16 cast sees them
            x = torch.from_numpy(proc(items)).bfloat16().float()
            ref_emb = ref.encode({"pc": x}, preprocessed=True)["pc"]
        else:
            ref_emb = ref.encode({m: items})[m]
        label = f"{m} B={len(items)}" + (" xyz-only" if files["xyz"] in items else "")
        cos[label] = cos_min(torch, emb, ref_emb)
    t_cpu = time.time() - t0
    del ref
    if min(cos.values()) < COS_MIN:
        fail(f"4g: card bf16 vs CPU fp32 cosines {cos} < {COS_MIN}")

    srv, th = _serve(make_server, model, 4, 20)
    try:
        items = [files["npy0"], files["xyz"]]
        out = _post(srv.server_address[1], {"inputs": {
            "pc": items, "text": ["a wooden chair with four legs"]}})
    finally:
        _stop(srv, th)
    served = {m: cos_min(torch, torch.tensor(out["embeddings"][m]),
                         model.encode({m: v})[m])
              for m, v in (("pc", items), ("text", ["a wooden chair with four legs"]))}
    if min(served.values()) < 0.999:
        fail(f"4g: served replies vs direct encodes: cosines {served}")
    shutil.rmtree(root, ignore_errors=True)
    print(f"[4g vitlensG pc] ViTLens('vitlensG', ('pc', 'text')) bf16, weights "
          f"bf16, from reference-layout fp16 checkpoints (written in "
          f"{t_files:.1f} s, loaded in {t_load:.1f} s; the skipped block 0 "
          f"holds the file's weights): requests (modality, B, launches "
          f"(mlp, attn, fps)) {per_req}; cosine vs CPU fp32 (took "
          f"{t_cpu:.1f} s): " + " ".join(f"{k} {v:.6f}" for k, v in cos.items())
          + "; one HTTP request (2 clouds, one xyz-only, and a caption): "
          + " ".join(f"{k} {v:.6f}" for k, v in served.items()), flush=True)
    return model


def served_phase(torch, np, counters, totals, card):
    """Phase 4v: vitlensL with every ported modality, loaded from
    reference-layout checkpoints, encodes raw files on the card and is
    served over HTTP. Returns what phase 5 times."""
    import tempfile
    import threading

    from vitlens_tpu_torch.api import ViTLens
    from vitlens_tpu_torch.ops.fbank import fbank_fixed_length
    from vitlens_tpu_torch.serve import make_server

    t0 = time.time()
    root = tempfile.mkdtemp(prefix="vitlens_4v_")
    files, merged, clip = write_inputs(torch, np, root)
    t_files = time.time() - t0
    mods = ("image", "tactile", "depth", "audio", "eeg", "video", "pc", "text")
    ckpts = {"all": files["all"], "image": files["clip"],
             "tactile": files["clip"], "text": files["clip"]}
    t0 = time.time()
    model = ViTLens("vitlensL", mods, device="cuda", compute_dtype=torch.bfloat16,
                    seed=SEED, checkpoints=ckpts, batch_buckets=(1, 4, 8))
    torch.cuda.synchronize()
    t_card = time.time() - t0
    t0 = time.time()
    ref = ViTLens("vitlensL", mods, device="cpu", seed=SEED, checkpoints=ckpts)
    t_cpu = time.time() - t0

    # a handful of loaded tensors against the file's, after the cast
    t = model.towers
    p = "transformer.resblocks.0."
    last = f"transformer.resblocks.{len(t['text'].trunk.blocks) - 1}."
    dim = t["text"].text_projection.shape[1]
    pairs = {
        "image conv1": (t["image"].adapter.conv1.w,
                        clip["visual.conv1.weight"].float().flatten(1).T),
        "tactile ln_pre": (t["tactile"].ln_pre.scale, clip["visual.ln_pre.weight"]),
        "audio qkv_w[0]": (t["audio"].trunk.blocks[0].attn.qkv_w,
                           merged["vitlens.audio." + p + "attn.in_proj_weight"].float().T),
        "audio latents": (t["audio"].perceiver.latents,
                          merged["vitlens.audio.perceiver.latents"]),
        "pc bn1 mean": (t["pc"].adapter.encoder.bn1.mean,
                        merged["vitlens.pc.visual_adapter.encoder.first_conv.1.running_mean"]),
        "depth conv1": (t["depth"].adapter.conv1.w,
                        merged["vitlens.depth.visual_adapter.conv1.weight"]
                        .float().flatten(1).T),
        "eeg proj w": (t["eeg"].adapter.proj.w,
                       merged["vitlens.eeg.visual_adapter.proj.weight"]
                       .float().flatten(1).T),
        "video ltpos": (t["video"].adapter.ltpos,
                        merged["vitlens.video.ltpos.weight"]),
        "video conv1": (t["video"].adapter.conv1.w,
                        merged["vitlens.video.conv1.weight"].float().flatten(1).T),
        "text token_embedding": (t["text"].token_embedding,
                                 clip["token_embedding.weight"]),
        "text fc w[last]": (t["text"].trunk.blocks[-1].mlp.fc.w,
                            clip[last + "mlp.c_fc.weight"].float().T)}
    for name, (got, want) in pairs.items():
        if not torch.equal(got.cpu(), want.float().to(got.dtype)):
            fail(f"4v: loaded {name} differs from the checkpoint's")
    del merged, clip

    # B = 1 (and one B = 3 audio, one B = 2 depth) encodes from files, counted
    n_text = t["text"].cfg.layers
    want = {m: tower_launches(t[m].cfg) for m in mods if m not in ("pc", "text")}
    want["pc"] = tower_launches(t["pc"].cfg, fps=1, point_encoder=1)
    want["text"] = launch_counts(fused_mlp=n_text)
    derived = {m: (want[m]["fused_mlp"], want[m]["flash_attention"])
               for m in ("depth", "eeg", "video")}
    if derived != {"depth": (24, 24), "eeg": (24, 26), "video": (24, 28)}:
        fail(f"4v: launches derived from the vitlensL configs {derived}")
    requests = [("image", [files["png_RGB"]]), ("tactile", [files["jpg_L"]]),
                ("depth", [files["depth_npy"], files["depth_png"]]),
                ("audio", [files["wav44k"]]),
                ("audio", [files["wav16k"], files["wav8k"], files["flac"]]),
                ("eeg", [files["eeg_pt"]]), ("video", [files["frames"]]),
                ("pc", [files["npy0"]]),
                ("text", ["a dog barking in the rain"])]
    per_req, cos = [], {}
    for m, items in requests:
        emb, counts = run_counted(torch, counters, totals,
                                  lambda: model.encode({m: items})[m])
        per_req.append((m, len(items), counts["fused_mlp"], counts["flash_attention"],
                        counts["fps"], counts["point_encoder"]))
        if counts != want[m]:
            fail(f"4v {m} from files: launches {counts}, expected {want[m]}")
        if (tuple(emb.shape) != (len(items), dim) or not torch.isfinite(emb).all()
                or (emb.float().norm(dim=-1) - 1).abs().max() > 1e-3):
            fail(f"4v {m} from files: shape {tuple(emb.shape)}, non-finite "
                 "values or norms off 1")
        if m == "pc":  # the card's tower rounds the cloud to bf16 before FPS
            x = torch.from_numpy(model.processors["pc"](items))
            want_emb = ref.encode({"pc": x.bfloat16().float()}, preprocessed=True)["pc"]
        else:
            want_emb = ref.encode({m: items})[m]
        cos[f"{m} B={len(items)}"] = cos_min(torch, emb, want_emb)
    del ref
    if min(cos.values()) < COS_MIN:
        fail(f"4v: card bf16 vs CPU fp32 from files: min cosine {cos} < {COS_MIN}")
    print(f"[4v files] vitlensL {mods} from reference-layout checkpoints "
          f"(merged vitlens.{{{','.join(LENS_FILE)}}}. export, CLIP visual. + "
          f"text file; "
          f"files written in {t_files:.1f} s, card model built and loaded in "
          f"{t_card:.1f} s, CPU fp32 copy in {t_cpu:.1f} s); {len(pairs)} loaded "
          f"tensors equal the files'; requests from files (modality, B, mlp, "
          f"attn, fps, encoder) {per_req}; min cosine vs CPU fp32: "
          + " ".join(f"{k} {v:.6f}" for k, v in cos.items()), flush=True)

    # the on-device fbank against the host processor's, same samples
    proc, tower = model.processors["audio"], t["audio"]
    from vitlens_tpu_torch.data.audio_decode import load_audio_file

    clips = proc.clips(*load_audio_file(files["wav44k"]))  # [3, 80000]
    host = torch.from_numpy(proc.fbank(clips))
    a = tower.cfg.audio
    wave = torch.from_numpy(clips).cuda()
    dev = fbank_fixed_length(wave, target_length=a.target_length,
                             sample_frequency=float(a.sampling_rate),
                             num_mel_bins=a.mel_bins).cpu()
    d = (dev - host).abs().max().item()
    if d > FBANK_TOL:
        fail(f"4v: on-device fbank vs host: max |d| {d} > {FBANK_TOL}")
    with torch.inference_mode():
        f_wave = tower(wave, torch.bfloat16)
        f_host = tower(host.cuda(), torch.bfloat16)
    fcos = cos_min(torch, f_wave, f_host)
    if fcos < COS_MIN:
        fail(f"4v: waveform-branch features vs host-fbank features: cosine {fcos}")
    print(f"[4v fbank] {card} | [3, 80000] waveforms: on-device fbank (cuFFT) "
          f"vs the host AudioProcessor's (CPU): max |d| {d:.3e} (<= "
          f"{FBANK_TOL}) on the normalised fbank; tower features from the "
          f"waveform vs from the host fbank: min cosine {fcos:.6f}", flush=True)

    # served: about 12 concurrent requests mixing the five modalities
    srv, th = _serve(make_server, model, 8, 50)
    port = srv.server_address[1]
    clouds = [np.load(files[f"npy{i}"]) for i in range(2)]
    reqs = [("text", ["a bird singing"]), ("text", ["rain", "a siren wailing"]),
            ("text", ["an old car"]),
            ("image", [files["png_RGB"]]), ("image", [files["jpg_RGB"], files["png_L"]]),
            ("tactile", [files["jpg_L"]]), ("tactile", [files["png_RGB"]]),
            ("depth", [files["depth_npy"]]), ("depth", [files["depth_png"]]),
            ("audio", [files["wav16k"]]), ("audio", [files["flac"]]),
            ("audio", [files["wav8k"]]),
            ("eeg", [files["eeg_pt"]]), ("video", [files["frames"]]),
            ("pc", [clouds[0].tolist()]), ("pc", [clouds[1].tolist()])]
    replies = [None] * len(reqs)

    def ask(i):
        m, items = reqs[i]
        try:
            replies[i] = _post(port, {"inputs": {m: items}})
        except Exception as e:  # noqa: BLE001 - reported below
            replies[i] = e

    for c in counters.values():
        c.launches = 0
    threads = []
    t0 = time.time()
    for m in mods:
        # one burst a modality, the bursts further apart than the window
        for i, (rm, _) in enumerate(reqs):
            if rm == m:
                threads.append(threading.Thread(target=ask, args=(i,)))
                threads[-1].start()
        time.sleep(0.15)
    for th_ in threads:
        th_.join(600)
    served_s = time.time() - t0
    served_counts = {name: c.launches for name, c in counters.items()}
    for name, n in served_counts.items():
        totals[name] += n
    health = _healthz(port)
    _stop(srv, th)
    scos = []
    for (m, items), reply in zip(reqs, replies):
        if not isinstance(reply, dict):
            fail(f"4v serve: {m} request failed: {reply!r}")
        got = torch.tensor(reply["embeddings"][m])
        direct = [np.asarray(x, np.float32) for x in items] if m == "pc" else items
        scos.append(cos_min(torch, got, model.encode({m: direct})[m]))
    stats = health["stats"]
    if min(scos) < SERVE_COS_MIN:
        fail(f"4v serve: replies vs direct encodes: cosines {scos} < {SERVE_COS_MIN}")
    if not stats["batches"] < len(reqs):
        fail(f"4v serve: {stats['batches']} batches for {len(reqs)} requests: "
             "nothing was coalesced")
    if (health["device_name"] != torch.cuda.get_device_name(0)
            or not health["device"].startswith("cuda")):
        fail(f"4v serve: /healthz names {health['device']} {health['device_name']}")
    if health["modalities"] != list(mods):
        fail(f"4v serve: /healthz lists {health['modalities']}, not {list(mods)}")
    print(f"[4v serve] {card} | {len(reqs)} concurrent HTTP requests (text, "
          f"image, tactile, depth .npy/.png, audio, EEG .pt paths, a video "
          f"frame directory, pc numeric items) in {served_s:.2f} s: "
          f"{stats['batches']} batches, {stats['items']} items; min cosine of a "
          f"reply vs a direct encode {min(scos):.6f} (>= {SERVE_COS_MIN}); "
          f"launches {dict((k, v) for k, v in served_counts.items() if v)}; "
          f"/healthz device {health['device']} ({health['device_name']}), "
          f"latency {health['latency']}; after shutdown and close both "
          f"workers have exited", flush=True)

    print(f"[4v cli] {card} | {run_cli(torch, model, files, root)}", flush=True)
    return {"model": model, "files": files, "root": root}


def run_cli(torch, model, files, tmp):
    """python -m vitlens_tpu_torch.cli.serve on the card with the depth,
    EEG, video and text towers loaded from phase 4v's reference-layout
    checkpoints: answers one request of each (a disparity .npy, an EEG .pt,
    a frame directory, a caption) at cosine >= SERVE_COS_MIN against
    ``model``'s direct encode of the same items (the same files' weights),
    drains on SIGTERM and exits 0. Its log goes to ``tmp``."""
    import re
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    log = os.path.join(tmp, "serve_cli.log")
    cmd = [sys.executable, "-m", "vitlens_tpu_torch.cli.serve", "--modalities",
           "depth", "eeg", "video", "text", "--ckpt", f"all={files['all']}",
           "--ckpt", f"text={files['clip']}", "--max-batch", "2", "--port", "0"]
    items = {"depth": [files["depth_npy"]], "eeg": [files["eeg_pt"]],
             "video": [files["frames"]], "text": ["a dog"]}
    t0 = time.time()
    with open(log, "w") as out:
        p = subprocess.Popen(cmd, cwd=root, stdout=out, stderr=subprocess.STDOUT)
        try:
            port = None
            while time.time() - t0 < 300 and port is None:
                m = re.search(r"listening on http://[^:]+:(\d+)", open(log).read())
                if m:
                    port = int(m.group(1))
                elif p.poll() is not None:
                    fail(f"serve CLI exited {p.returncode}: {open(log).read()[-1500:]}")
                else:
                    time.sleep(0.5)
            if port is None:
                fail("serve CLI never printed its port")
            t_up = time.time() - t0
            cos = {}
            for m, x in items.items():
                reply = _post(port, {"inputs": {m: x}})
                if len(reply["embeddings"][m]) != 1 or reply["dim"] != 768:
                    fail(f"serve CLI {m} reply: {str(reply)[:200]}")
                cos[m] = cos_min(torch, torch.tensor(reply["embeddings"][m]),
                                 model.encode({m: x})[m])
            p.send_signal(signal.SIGTERM)
            rc = p.wait(timeout=120)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
    if min(cos.values()) < SERVE_COS_MIN:
        fail(f"serve CLI replies vs direct encodes: cosines {cos} < {SERVE_COS_MIN}")
    text = open(log).read()
    drained = re.search(r"vitlens-serve: drained, exiting \(served 4 items.*", text)
    if rc != 0 or "draining" not in text or not drained:
        fail(f"serve CLI: exit {rc}, log {text[-1500:]}")
    return (f"{' '.join(cmd[1:6])} ... (merged and CLIP files): up (warmed) in "
            f"{t_up:.1f} s, answered one depth, EEG, video and text request, "
            f"cosine vs a direct encode "
            + " ".join(f"{m} {c:.6f}" for m, c in cos.items())
            + f", exit {rc} on SIGTERM: {drained.group(0)!r}")


def served_timings(torch, np, card, ctx):
    """Phase 5's timings of the served path: the B64 image, depth, EEG and
    video encodes (arrays given), the host processors, the on-device fbank
    at [192, 80000], and a closed-loop served run (64 audio requests of one
    5 s WAV each from 16 client threads at max_batch 64)."""
    import threading

    from vitlens_tpu_torch.data.processors import (AudioProcessor,
                                                   DepthProcessor, EEGProcessor,
                                                   ImageProcessor)
    from vitlens_tpu_torch.data.video_processors import VideoProcessor
    from vitlens_tpu_torch.ops.fbank import fbank_fixed_length
    from vitlens_tpu_torch.serve import make_server

    model, files = ctx["model"], ctx["files"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    hw = model.towers["image"].cfg.arch.image_size
    img64 = torch.randn(B, 3, hw, hw, generator=g, device="cuda")
    def image64():
        return model.encode({"image": img64}, preprocessed=True)["image"]

    rates = {"image": encode_rate(
        torch, card, f"image encode B{B} bf16 (preprocessed [B, 3, {hw}, {hw}])",
        image64, B)}
    profile_encode(torch, card, f"B{B} image encode", image64)
    del img64
    for m in ("depth", "eeg", "video"):
        x = torch.randn((B,) + model._warmup_sample(m, 1).shape[1:], generator=g,
                        device="cuda")

        def encode(m=m, x=x):
            return model.encode({m: x}, preprocessed=True)[m]

        rates[m] = encode_rate(torch, card, f"{m} encode B{B} bf16 (preprocessed "
                               f"{list(x.shape)})", encode, B)
        if m == "video":
            profile_encode(torch, card, f"B{B} video encode", encode)
        del x, encode

    def host_ms(fn, runs=5):
        fn()
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times), times

    aud, img = AudioProcessor(), ImageProcessor()
    a_ms, a_all = host_ms(lambda: aud([files["wav10s"]]))
    i_ms, i_all = host_ms(lambda: img([files["jpg_RGB"]]), runs=20)
    print(f"[5 timing] {card} | host AudioProcessor, one 10 s 16 kHz WAV -> "
          f"[1, 3, 512, 128] (decode, 3 clips, CPU fbank; torch "
          f"{torch.get_num_threads()} threads): {a_ms:.2f} ms best of 5, all "
          f"{[round(x, 2) for x in a_all]}; host ImageProcessor, one 320 x 240 "
          f"JPEG -> [1, 3, 224, 224]: {i_ms:.3f} ms best of 20", flush=True)
    host = {"DepthProcessor, one 240 x 320 .npy disparity -> [1, 1, 224, 224]":
            (DepthProcessor(), files["depth_npy"], 20),
            "DepthProcessor, one 300 x 200 16-bit .png -> [1, 1, 224, 224]":
            (DepthProcessor(), files["depth_png"], 20),
            "EEGProcessor, one [128, 500] .pt -> [1, 128, 512]":
            (EEGProcessor(), files["eeg_pt"], 20),
            "VideoProcessor, one directory of 12 320 x 240 JPEG frames -> "
            "[1, 8, 3, 224, 224]": (VideoProcessor(), files["frames"], 5)}
    for label, (proc, path, runs) in host.items():
        ms, _ = host_ms(lambda: proc([path]), runs=runs)
        print(f"[5 timing] {card} | host {label}: {ms:.3f} ms best of {runs}",
              flush=True)
    w192 = torch.randn(3 * B, 80000, generator=g, device="cuda") * 0.1
    fb_ms = cuda_ms(lambda: fbank_fixed_length(w192))
    # the bound: each waveform read and the fbank written once, or the
    # operations (a 512-point real FFT ~2.5 N log2 N, the power spectrum
    # and the mel product) at the fp32 peak
    frames = 1 + (80000 - 400) // 160
    fb_ops = 3 * B * frames * (2.5 * 512 * 9 + 3 * 256 + 2 * 256 * 128)
    fb_bound, fb_by = bound(fb_ops, w192.numel() * 4 + 3 * B * 512 * 128 * 4,
                            PEAK_FP32)
    print(f"[5 timing] {card} | on-device fbank [{3 * B}, 80000] -> "
          f"[{3 * B}, 512, 128] fp32 (plain PyTorch: unfold, cuFFT rfft, the "
          f"mel matmul): {fb_ms:.4f} ms, bound {fb_bound:.4f} ms ({fb_by})",
          flush=True)

    srv, th = _serve(make_server, model, B, 50)
    port = srv.server_address[1]
    _post(port, {"inputs": {"audio": [files["wav16k"]]}})  # warm the path
    errors = []

    def client():
        for _ in range(4):
            try:
                _post(port, {"inputs": {"audio": [files["wav16k"]]}})
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

    clients = [threading.Thread(target=client) for _ in range(16)]
    t0 = time.perf_counter()
    for c in clients:
        c.start()
    for c in clients:
        c.join(600)
    wall = time.perf_counter() - t0
    health = _healthz(port)
    _stop(srv, th)
    if errors:
        fail(f"served run: {len(errors)} requests failed: {errors[0]!r}")
    st, lat = health["stats"], health["latency"]
    print(f"[5 timing] {card} | served closed loop: 64 audio requests (one 5 s "
          f"16 kHz WAV each, 3 clips) from 16 client threads, max_batch {B}, "
          f"max_wait 50 ms: {64 / wall:.2f} requests/s ({wall:.2f} s), "
          f"{st['batches'] - 1} batches (mean {63 / max(1, st['batches'] - 1):.1f} "
          f"items, the warm request aside), latency p50 {lat['p50_ms']} ms, "
          f"p95 {lat['p95_ms']} ms (/healthz, the warm request included)",
          flush=True)
    rates["served_rps"] = 64 / wall
    return rates


# -- phase 4x: the training CLI ------------------------------------------------

CLI_CLIPS = 24      # AudioSet-style train clips of 5-10 s (every fourth FLAC)
CLI_EPOCHS = 2      # run (a); run (b) resumes into a third
CLI_ARGS = ("--modality", "audio", "--model", "ViT-L-14", "--train-data",
            "audioset@train", "--val-data", "esc50@fold-1::audiocaps@test",
            "--n-tower", "2", "--align-to", "text", "--unlock-cls",
            "--precision", "bf16", "--batch-size", "8", "--accum-freq", "2",
            "--log-every-n-steps", "1", "--seed", "0", "--warmup", "2",
            "--lr", "1e-4")


def write_cli_inputs(torch, np, root):
    """Phase 4x's files under ``root``: CLI_CLIPS AudioSet-style clips (16
    kHz mono, 5-10 s, every fourth one FLAC) with audioset_train.json and the
    class CSV (4 classes); an ESC50-style fold of 8 clips over 4 classes with
    its label JSON; an AudioCaps-style test tsv of 6 rows with its texts
    JSON; and a reference-layout vitlensL tri file from a seeded generator
    (the audio tower under visual., the image tower under image., the text
    tower, logit_scale; fp16). -> (env, path of the pretrained file)."""
    from tools.reference_layout import (pcm_from_float, text_tower_state_dict,
                                        vision_tower_state_dict, write_flac,
                                        write_wav)
    from vitlens_tpu_torch.config import image_tower_config, make_model_config

    meta = os.path.join(root, "meta", "modal_audio", "data")
    os.makedirs(meta)
    os.makedirs(os.path.join(root, "audio"))
    rng = np.random.RandomState(SEED + 13)
    paths = []
    for i in range(CLI_CLIPS):
        secs = 5.0 + 5.0 * rng.rand()
        pcm = pcm_from_float(_tone(np, 16000, secs, 1, i), 16)
        name = f"audio/clip{i:02d}." + ("flac" if i % 4 == 3 else "wav")
        (write_flac if name.endswith("flac") else write_wav)(
            os.path.join(root, name), pcm, 16000)
        paths.append(name)
    classes = ["dog", "rain", "siren", "engine"]

    def dump(name, obj):
        with open(os.path.join(meta, name), "w") as f:
            json.dump(obj, f) if not isinstance(obj, str) else f.write(obj)

    dump("audioset_train.json", [{"uniq_id": i, "audio_path": p,
                                  "labels": [i % 4] + ([(i + 1) % 4] if i % 3 == 0 else [])}
                                 for i, p in enumerate(paths)])
    dump("audioset_class_labels_indices.csv", "index,mid,display_name\n" + "".join(
        f"{c},/m/{c},{n}\n" for c, n in enumerate(classes)))
    dump("esc50_fold-1.json", [{"uniq_id": i, "audio_path": paths[i],
                                "text": classes[i % 4], "class_label": i % 4}
                               for i in range(8)])
    dump("esc50_label.json", {str(c): [n] for c, n in enumerate(classes)})
    dump("audiocaps_test_new.tsv", "uniq_id\taudio\ttext\tduration\n" + "".join(
        f"{100 + i}\t{paths[8 + i]}\tthe sound of {classes[i % 4]} {i}\t5.0\n"
        for i in range(6)))
    dump("audiocaps_test_texts.json", {str(100 + i): [
        f"the sound of {classes[i % 4]} {i}", f"a recording of {classes[i % 4]}"]
        for i in range(6)})
    cfg = make_model_config(CLI_ARGS[CLI_ARGS.index("--model") + 1], "audio")
    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    half = torch.float16
    sd = {"visual." + k: v for k, v in vision_tower_state_dict(cfg.tower, g, half).items()}
    sd.update({"image." + k: v for k, v in vision_tower_state_dict(
        image_tower_config(cfg), g, half).items()})
    sd.update(text_tower_state_dict(cfg.text, cfg.embed_dim, g, half))
    sd["logit_scale"] = torch.tensor(float(np.log(1 / 0.07)))
    pre = os.path.join(root, "vitlensL_audio_tri.pt")
    torch.save({k: v.cpu() for k, v in sd.items()}, pre)
    env = dict(os.environ, VITLENS_AUDIO_DATA_DIR=root,
               VITLENS_METADATA_DIR=os.path.join(root, "meta"))
    return env, pre


def _cli(env, argv, log, timeout=900):
    """python -m vitlens_tpu_torch.cli.train ``argv`` as a child process on
    the card, its output into ``log``; -> (exit code, seconds, stdout)."""
    cmd = [sys.executable, "-m", "vitlens_tpu_torch.cli.train", *argv]
    t0 = time.time()
    with open(log, "w") as err:
        p = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                           env=env, stdout=subprocess.PIPE, stderr=err,
                           text=True, timeout=timeout)
    return p.returncode, time.time() - t0, p.stdout


def _records(run_dir):
    with open(os.path.join(run_dir, "results.jsonl")) as f:
        return [json.loads(line) for line in f]


def _tree(path):
    import torch

    return torch.load(os.path.join(path, "tree.pt"), map_location="cpu",
                      weights_only=True)


def train_cli_phase(torch, np, counters, totals, card):
    """Phase 4x: the published vitlensL audio recipe through ``python -m
    vitlens_tpu_torch.cli.train`` on the card at full ViT-L-14 width and
    depth, from audio files (see write_cli_inputs); run (a) trains 2 epochs
    with zero-shot eval (ESC50 accuracy, AudioCaps recall) at each end and
    writes epoch_1, epoch_2, epoch_latest and checkpoint_best; run (b)
    resumes from --resume latest into epoch 3; run (c) prints
    --visual-stat-flops. In this process, through cli.train's functions: the
    AdamW moments loaded from epoch_2 bit-equal to the file's, one train step
    and one eval batch with their launches, and checkpoint_best's eval
    features against the same weights in fp32 on the CPU. Returns what
    phase 5 prints."""
    import tempfile

    from vitlens_tpu_torch.cli import train as T
    from vitlens_tpu_torch.cli.args import parse_args
    from vitlens_tpu_torch.data.loader import DevicePrefetcher
    from vitlens_tpu_torch.models import tri
    from vitlens_tpu_torch.train import checkpoint as C

    t0 = time.time()
    torch.cuda.empty_cache()  # the children allocate on the same card
    root = tempfile.mkdtemp(prefix="vitlens_4x_")
    env, pre = write_cli_inputs(torch, np, root)
    t_files = time.time() - t0
    logs = os.path.join(root, "logs")
    argv = [*CLI_ARGS, "--pretrained", pre, "--logs", logs, "--name", "a"]
    run, ckpts = os.path.join(logs, "a"), os.path.join(logs, "a", "checkpoints")

    # -- run (a): 2 epochs ------------------------------------------------------
    rc, t_a, _ = _cli(env, argv + ["--epochs", str(CLI_EPOCHS)],
                      os.path.join(root, "run_a.log"))
    if rc != 0:
        fail(f"4x run (a): exit {rc}: {open(os.path.join(root, 'run_a.log')).read()[-2000:]}")
    recs = _records(run)
    train = [r for r in recs if "train/loss" in r]
    val = [r for r in recs if "val/primary" in r]
    steps_a = len(train)
    per_epoch = CLI_CLIPS // 8
    if [r["step"] for r in train] != list(range(1, per_epoch * CLI_EPOCHS + 1)):
        fail(f"4x run (a): train steps {[r['step'] for r in train]}")
    bad = [r for r in train if not (np.isfinite(r["train/loss"])
                                    and r["train/grad_norm"] > 0)]
    if bad:
        fail(f"4x run (a): steps without a finite loss and a gradient: {bad}")
    want_keys = ("val/esc50@fold-1/accuracy", "val/audiocaps@test/r_mean",
                 "val/primary")
    if len(val) != CLI_EPOCHS or not all(k in r for r in val for k in want_keys):
        fail(f"4x run (a): val lines {val}")
    names = sorted(os.listdir(ckpts))
    for n in ("epoch_1", "epoch_2", "epoch_latest", "checkpoint_best", "best.json"):
        if n not in names:
            fail(f"4x run (a): {n} missing from {names}")
    ep2 = _tree(os.path.join(ckpts, "epoch_2"))

    # -- run (b): --resume latest into epoch 3 ------------------------------------
    rc, t_b, _ = _cli(env, argv + ["--epochs", str(CLI_EPOCHS + 1), "--resume",
                                   "latest"], os.path.join(root, "run_b.log"))
    out_log = open(os.path.join(run, "out.log")).read()
    if rc != 0 or f"(epoch {CLI_EPOCHS})" not in out_log:
        fail(f"4x run (b): exit {rc}: {open(os.path.join(root, 'run_b.log')).read()[-2000:]}")
    resumed = [r for r in _records(run) if "train/loss" in r][steps_a:]
    if ([r["step"] for r in resumed] != list(range(steps_a + 1, steps_a + per_epoch + 1))
            or any(r["train/epoch"] != CLI_EPOCHS for r in resumed)
            or not all(np.isfinite(r["train/loss"]) for r in resumed)):
        fail(f"4x run (b): resumed steps {resumed}")
    ep3 = _tree(os.path.join(ckpts, f"epoch_{CLI_EPOCHS + 1}"))
    if ep3["step"] != ep2["step"] + per_epoch:
        fail(f"4x run (b): step {ep3['step']} after epoch 3, epoch 2 ended at {ep2['step']}")

    # -- in this process, through cli.train's functions ---------------------------
    args = parse_args(argv + ["--epochs", str(CLI_EPOCHS + 1), "--device", "cuda"])
    os.environ.update({k: env[k] for k in ("VITLENS_AUDIO_DATA_DIR",
                                           "VITLENS_METADATA_DIR")})
    cfg, tok, model, mask = T.build_model(args, "cuda")
    info = T.build_train_data(args, tok, 1, cfg)
    step, ts = T.build_step(args, model, cfg, mask, info.num_batches * args.epochs)
    # frozen: the pretrained file's weights after the bf16 cast, untouched by
    # runs (a) and (b); trainable: moved by run (b)
    frozen_moved = [n for n, p in model.named_parameters()
                    if not mask[n] and not torch.equal(p.cpu(), ep3["params"][n])]
    unmoved = [n for n, p in model.named_parameters()
               if mask[n] and torch.equal(ep3["params"][n], ep2["params"][n])]
    if frozen_moved or unmoved:
        fail(f"4x: frozen tensors that differ from the pretrained file's "
             f"{frozen_moved[:5]}, trainable ones run (b) left {unmoved[:5]}")
    C.load_checkpoint(os.path.join(ckpts, "epoch_2"), ts)
    moments = [(m, n) for m in ("mu", "nu") for n, t in ts.opt_state[m].items()
               if not torch.equal(t.cpu(), ep2["opt_state"][m][n])]
    if (moments or ts.step != ep2["step"]
            or ts.opt_state["count"] != ep2["opt_state"]["count"]):
        fail(f"4x: AdamW state loaded from epoch_2 differs from the file's: "
             f"{moments[:5]}, step {ts.step} vs {ep2['step']}")
    n_moments = sum(t.numel() for t in ts.opt_state["mu"].values())
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    raw = next(iter(info.dataloader))
    batch = next(iter(DevicePrefetcher(
        [raw], device="cuda", map_fn=lambda r: T._prep_batch(r, args, tok))))
    if not (batch["visual"].is_cuda and batch["text"].is_cuda):
        fail("4x: the prefetcher handed out host tensors")
    _, counts = run_counted(torch, counters, totals,
                            lambda: step(ts, batch, fps_generator=gen))
    want = train_launches(cfg.tower, cfg.text.layers, args.accum_freq, False, False)
    if counts != want:
        fail(f"4x train step: launches {counts}, expected {want}")
    step_s = []
    for _ in range(3):
        t1 = time.perf_counter()
        _, m = step(ts, batch, fps_generator=gen)
        float(m["loss"])
        step_s.append(time.perf_counter() - t1)
    # one ESC50 eval batch (8 clips x 3) and checkpoint_best's features
    enc_visual, _ = T.eval_encoders(args, model)
    esc = T._build_real_dataset(args, "esc50@fold-1", train=False, cfg=cfg)
    x = np.stack([esc[i]["audio"] for i in range(8)])
    C.load_checkpoint(os.path.join(ckpts, "checkpoint_best"), ts, ckpt_only=True)
    flat = x.reshape((-1,) + x.shape[2:])
    feats, ecounts = run_counted(torch, counters, totals, lambda: enc_visual(flat))
    if ecounts != tower_launches(cfg.tower):
        fail(f"4x eval batch: launches {ecounts}, expected {tower_launches(cfg.tower)}")
    # the CPU fp32 copy on one sample's 3 clips (ViT-L in fp32 on the host)
    ref = copy.deepcopy(model.visual).to(device="cpu", dtype=torch.float32)
    with torch.no_grad():
        want_feats = ref(torch.from_numpy(flat[:3]), torch.float32)
    del ref
    ecos = cos_min(torch, torch.from_numpy(feats[:3]), want_feats)
    if not (np.isfinite(feats).all() and ecos >= COS_MIN):
        fail(f"4x: checkpoint_best's eval features vs CPU fp32: cosine {ecos}")
    # the host pipeline a clip: decode, mixup, fbank, SpecAugment
    ds = info.dataloader.dataset
    clip_ms = []
    for i in range(8):
        t1 = time.perf_counter()
        ds[i]
        clip_ms.append((time.perf_counter() - t1) * 1e3)
    del model, ts, step, batch

    # -- run (c): --visual-stat-flops ---------------------------------------------
    rc, t_c, out = _cli(env, [*CLI_ARGS[:4], "--visual-stat-flops", "--logs",
                              logs, "--name", "f"],
                        os.path.join(root, "run_c.log"))
    try:
        flops = json.loads(out.strip().splitlines()[-1])
    except (ValueError, IndexError):
        flops = None
    if rc != 0 or not flops or not flops["params_M"] > 0 or not flops[
            "gflops_per_sample"] > 0:
        fail(f"4x run (c): exit {rc}, stdout {out[-500:]!r}")
    shutil.rmtree(root, ignore_errors=True)
    print(f"[4x train CLI] {card} | python -m vitlens_tpu_torch.cli.train "
          f"{' '.join(CLI_ARGS)} --pretrained <reference-layout vitlensL tri "
          f"file, fp16> on {CLI_CLIPS} AudioSet-style clips (6 FLAC) with ESC50 "
          f"(8 clips) and AudioCaps (6 rows) val: run (a) {CLI_EPOCHS} epochs, "
          f"{steps_a} steps, exit 0 in {t_a:.1f} s, losses "
          f"{[round(r['train/loss'], 4) for r in train]}, grad_norm "
          f"{[round(r['train/grad_norm'], 4) for r in train]}, val "
          + "; ".join(f"epoch {i + 1}: accuracy {r[want_keys[0]]:.4f} r_mean "
                      f"{r[want_keys[1]]:.4f} primary {r[want_keys[2]]:.4f}"
                      for i, r in enumerate(val))
          + f"; checkpoints {names}; run (b) --resume latest: epoch "
          f"{CLI_EPOCHS} steps {[r['step'] for r in resumed]}, exit 0 in "
          f"{t_b:.1f} s; frozen tensors bit-identical to the pretrained file's "
          f"after the bf16 cast, every trainable one moved by run (b); AdamW "
          f"moments ({n_moments} elements each) loaded from epoch_2 bit-equal "
          f"to the file's; in-process B = 8 accum_freq 2 step launches "
          f"{dict((k, v) for k, v in counts.items() if v)}, eval batch (8 x 3 "
          f"clips) {dict((k, v) for k, v in ecounts.items() if v)}; "
          f"checkpoint_best eval features vs CPU fp32 min cosine {ecos:.6f}; "
          f"run (c) --visual-stat-flops {flops} in {t_c:.1f} s; files written "
          f"in {t_files:.1f} s; phase took {time.time() - t0:.1f} s", flush=True)
    return {"step_s": step_s, "clip_ms": clip_ms, "flops": flops}


def train_cli_timings(card, ctx):
    """Phase 5's lines of phase 4x: the host-timed seconds of the B = 8
    accum_freq 2 train step of the recipe through cli.train's step, and the
    host ms a clip of the AudioSet train pipeline (decode, mixup, fbank,
    SpecAugment), one thread."""
    s = ctx["step_s"]
    print(f"[5 timing] {card} | train CLI step (vitlensL audio recipe, B = 8 "
          f"accum_freq 2, bf16; batch on the card): {min(s):.4f} s best of "
          f"{len(s)}, all {[round(x, 4) for x in s]}; host AudioSet train "
          f"pipeline a clip (decode, mixup, fbank, SpecAugment): "
          f"{min(ctx['clip_ms']):.2f} ms best, all "
          f"{[round(x, 2) for x in ctx['clip_ms']]}", flush=True)


def host_library_timings(torch, np, card, ctx):
    """Phase 5's native host library lines: PointCloudProcessor (8192
    points) on raw .npy clouds of 9000 and 10000 points with FPS through the
    library beside the plain numpy loop; a 10 s FLAC decoded by the library
    beside the pure-Python decoder; and a closed served loop of FLAC
    requests (64 requests of one 5 s FLAC from 16 client threads)."""
    import tempfile
    import threading

    from tools.reference_layout import pcm_from_float, write_flac
    from vitlens_tpu_torch.data import processors as P
    from vitlens_tpu_torch.data.audio_decode import decode_flac, load_audio_file
    from vitlens_tpu_torch.serve import make_server

    def best_ms(fn, runs):
        fn()
        times = []
        for _ in range(runs):
            t1 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t1) * 1e3)
        return min(times)

    files, root = ctx["files"], tempfile.mkdtemp(prefix="vitlens_5h_")
    rng = np.random.RandomState(SEED + 21)
    cloud10k = os.path.join(root, "cloud10k.npy")
    np.save(cloud10k, (rng.randn(10000, 3) * 0.3).astype(np.float32))
    proc = P.PointCloudProcessor(n_sample_points=8192)
    for label, path in (("9000", files["npy0"]), ("10000", cloud10k)):
        pc = np.load(path)
        nat = best_ms(lambda: proc([path]), 5)
        plain = best_ms(lambda: P.farthest_point_sample_plain(pc, 8192), 1)
        same = np.array_equal(P.farthest_point_sample_np(pc, 8192),
                              P.farthest_point_sample_plain(pc, 8192))
        print(f"[5 timing] {card} | host PointCloudProcessor, one .npy cloud of "
              f"{label} points -> [1, 8192, 3] (FPS through the native "
              f"library): {nat:.2f} ms best of 5; the plain numpy FPS loop "
              f"alone on the same cloud: {plain:.2f} ms; same points: {same}",
              flush=True)
    flac10 = os.path.join(root, "ten.flac")
    write_flac(flac10, pcm_from_float(_tone(np, 16000, 10.0, 1, 3), 16), 16000)
    nat = best_ms(lambda: load_audio_file(flac10), 5)
    py = best_ms(lambda: decode_flac(flac10), 1)
    if not np.array_equal(load_audio_file(flac10)[0], decode_flac(flac10)[0]):
        fail("5: the native FLAC decode differs from the pure-Python one")
    print(f"[5 timing] {card} | FLAC decode of a 10 s 16 kHz mono file: native "
          f"library {nat:.3f} ms best of 5, pure-Python decoder {py:.1f} ms "
          f"(bit-equal)", flush=True)
    flac5 = os.path.join(root, "five.flac")
    write_flac(flac5, pcm_from_float(_tone(np, 16000, 5.0, 1, 4), 16), 16000)
    srv, th = _serve(make_server, ctx["model"], B, 50)
    port = srv.server_address[1]
    _post(port, {"inputs": {"audio": [flac5]}})
    errors = []

    def client():
        for _ in range(4):
            try:
                _post(port, {"inputs": {"audio": [flac5]}})
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

    clients = [threading.Thread(target=client) for _ in range(16)]
    t1 = time.perf_counter()
    for c in clients:
        c.start()
    for c in clients:
        c.join(600)
    wall = time.perf_counter() - t1
    health = _healthz(port)
    _stop(srv, th)
    shutil.rmtree(root, ignore_errors=True)
    if errors:
        fail(f"FLAC served run: {len(errors)} requests failed: {errors[0]!r}")
    lat = health["latency"]
    print(f"[5 timing] {card} | served closed loop, FLAC: 64 audio requests "
          f"(one 5 s 16 kHz FLAC each, decoded by the native library) from 16 "
          f"client threads, max_batch {B}, max_wait 50 ms: {64 / wall:.2f} "
          f"requests/s ({wall:.2f} s), latency p50 {lat['p50_ms']} ms, p95 "
          f"{lat['p95_ms']} ms (/healthz, the warm request included)", flush=True)


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
    from vitlens_tpu_torch.ops.fused_ln_proj import (fused_ln_proj,
                                                     ln_proj_reference)
    from vitlens_tpu_torch.ops.fused_mlp import (fused_mlp, fused_mlp_reference,
                                                 fused_mlp_save_preact)
    from vitlens_tpu_torch.ops.fused_mlp_chain import (fused_attnout_mlp,
                                                       fused_mlp_chunked)
    from vitlens_tpu_torch.ops.fused_point_encoder import (
        fused_point_encoder, point_encoder_reference)
    from vitlens_tpu_torch.ops.int8_matmul import (int8_matmul,
                                                   int8_matmul_dequant,
                                                   int8_quantize)
    from vitlens_tpu_torch.ops.row_gather import row_gather

    # The kernels of the JSON line (the save-preact variant is kernel 1's; the
    # LN + qkv prototype's kernel is the fused LN + projection, held and timed
    # at the prototype's shape under its own name; kernel 10's two epilogues
    # are two entries) and every launch counter, by variant.
    kernels = {"fused_mlp": fused_mlp, "flash_attention": flash_attention,
               "fps": fps_indices, "point_encoder": fused_point_encoder,
               "fused_ln_proj": fused_ln_proj, "int8_matmul": int8_matmul,
               "int8_matmul_dequant": int8_matmul_dequant,
               "int8_quantize": int8_quantize,
               "row_gather": row_gather, "fused_mlp_chunked": fused_mlp_chunked,
               "fused_attnout_mlp": fused_attnout_mlp,
               "fused_ln_qkv": fused_ln_proj}
    counters = dict(zip(COUNTED, (fused_mlp, fused_mlp_save_preact,
                                  flash_attention, fps_indices,
                                  fused_point_encoder, fused_ln_proj,
                                  int8_matmul, int8_matmul_dequant,
                                  int8_quantize, row_gather, fused_mlp_chunked,
                                  fused_attnout_mlp)))
    if len(counters) != len(COUNTED):
        fail("a launch counter is missing")
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
    # the last: the video distill step's image tower at B64 (8 frames of
    # 257 tokens a sample), the largest M on any path
    for m, d, h in ((6168, 1024, 4096), (616, 768, 3072), (1001, 1024, 4096),
                    (4100, 1024, 4096), (4100, 1664, 8192), (154, 1280, 5120),
                    (B * 8 * 257, 1024, 4096)):
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
    # the main paths' shapes, then the video Lens cross (8 frames x 256
    # tokens), a ragged NK beside it, the EEG (and pc) Lens cross at B64 and
    # the video distill step's image tower at B64 (512 frames)
    for b, h, nq, nk in ((12, 16, 257, 257), (12, 1, 256, 600),
                         (12, 16, 256, 256), (8, 1, 256, 512),
                         (B, 1, 256, 2048), (B, 1, 256, 2040), (B, 1, 256, 512),
                         (B * 8, 16, 257, 257)):
        q, k, v = qkv_inputs(torch, g, b, h, nq, nk)
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        want = attention_reference(q, k, v)
        e = rel_err(got, want)
        err["flash_attention"] = max(err["flash_attention"], abs_err(got, want))
        checks.append(f"attn{b}x{h}x{nq}x{nk}={e:.2e}")
        if not (torch.isfinite(got).all() and e <= ATTN_TOL):
            fail(f"flash_attention {b}x{h}x{nq}x{nk}: rel err {e} > {ATTN_TOL}")
    check_attention_edges(torch, g, err, checks)
    check_head_dims(torch, g, err, checks)
    fps_timed = {}
    for b, n, npoint, cloud, starts in FPS_CASES:
        xyz, start = fps_inputs(torch, g, b, n, cloud, starts)
        if (n, npoint, cloud, starts) == (8192, 512, "random", "zero"):
            fps_timed[b] = (xyz, start)
        got = fps_indices(xyz, npoint, start)
        torch.cuda.synchronize()
        want = fps_indices_reference(xyz, npoint, start)
        n_diff = (got != want).sum().item()
        err["fps"] = max(err["fps"], abs_err(got, want))
        checks.append(f"fps{b}x{n}/{npoint}/{cloud}/{starts}:{n_diff}-differ")
        if n_diff:
            fail(f"fps_indices B{b} N{n} npoint {npoint} {cloud} cloud, {starts} "
                 f"starts: {n_diff} indices differ from the plain version")
        del xyz, start, got, want
    err["point_encoder"] = 0.0
    # Every M on 21 groups (a ragged last tile); then many tiles a CTA (more
    # than 2 x 132) with groups straddling the two consumers (M = 48, 80,
    # 128); C4 = 384 (three passes of 128 columns) and 512 (two of 256);
    # last the pc encode's B64 shape, timed in phase 5.
    for bg_shape, m, c4 in (((3, 7), 16, 256), ((3, 7), 32, 256),
                            ((3, 7), 48, 256), ((3, 7), 64, 256),
                            ((3, 7), 128, 256), ((B, 512), 48, 256),
                            ((3, 101), 80, 256), ((3, 101), 128, 256),
                            ((3, 101), 48, 384), ((3, 7), 128, 512),
                            ((B, 64), 32, 512), ((B, 512), 32, 256)):
        args = enc_inputs(torch, g, bg_shape, m, c4)
        got = fused_point_encoder(*args)
        torch.cuda.synchronize()
        want = point_encoder_reference(*args)
        e = rel_err(got, want)
        err["point_encoder"] = max(err["point_encoder"], abs_err(got, want))
        label = "x".join(map(str, bg_shape))
        checks.append(f"enc{label}x{m}/{c4}={e:.2e}")
        if not (torch.isfinite(got).all() and e <= ENC_TOL):
            fail(f"fused_point_encoder {label} M={m} C4={c4}: rel err {e} > "
                 f"{ENC_TOL}")
    enc_args = args  # [B, 512, 32]: timed in phase 5
    for m, d, h in ((6168, 1024, 4096), (1001, 1024, 4096), (4100, 1024, 4096),
                    (616, 768, 3072), (4100, 1664, 8192)):
        for act in ("gelu", "quick_gelu"):
            a = mlp_inputs(torch, g, m, d, h)
            got, pre = fused_mlp_save_preact(*a, act=act)
            torch.cuda.synchronize()
            want, want_pre = fused_mlp_reference(*a, act=act, save_preact=True)
            e, e_pre = rel_err(got, want), rel_err(pre, want_pre)
            err["fused_mlp"] = max(err["fused_mlp"], abs_err(got, want),
                                   abs_err(pre, want_pre))
            checks.append(f"preact{m}x{d}x{h}/{act}=out {e:.2e},a {e_pre:.2e}")
            if not (torch.isfinite(got).all() and torch.isfinite(pre).all()
                    and e <= MLP_TOL and e_pre <= PREACT_TOL):
                fail(f"fused_mlp_save_preact {m}x{d}x{h} {act}: rel err out {e}, a "
                     f"{e_pre} > {MLP_TOL}, {PREACT_TOL}")
    err["fused_ln_proj"] = 0.0
    for m, d, n in ((6168, 1024, 3072), (1001, 1024, 3072), (6168, 768, 2304),
                    (1001, 768, 2304), (4100, 1664, 4992), (77, 1664, 4992)):
        a = ln_proj_inputs(torch, g, m, d, n)
        got = fused_ln_proj(*a)
        torch.cuda.synchronize()
        want = ln_proj_reference(*a)
        e = rel_err(got, want)
        err["fused_ln_proj"] = max(err["fused_ln_proj"], abs_err(got, want))
        checks.append(f"lnproj{m}x{d}x{n}={e:.2e}")
        if not (torch.isfinite(got).all() and e <= LNP_TOL):
            fail(f"fused_ln_proj {m}x{d}x{n}: rel err {e} > {LNP_TOL}")
    check_new_kernels(torch, g, err, checks)
    check_int8_epilogues(torch, g, err, checks)
    digests = kernel1_digests(torch, np)
    if digests != {k: tuple(v) for k, v in KERNEL1_DIGESTS.items()}:
        fail(f"kernel 1's outputs changed: digests {digests}, the parent "
             f"build's {KERNEL1_DIGESTS}")
    checks.append("kernel1-acts0,1-bit-identical-to-parent")
    print(f"[3 kernels] all within bound (mlp <= {MLP_TOL}, save-preact a <= "
          f"{PREACT_TOL}, attn <= {ATTN_TOL} at head dims 64 and {OTHER_HEAD_DIMS}, "
          f"ln_proj <= {LNP_TOL}, encoder <= {ENC_TOL}, chained mlp <= "
          f"{CHAIN_TOL} relative, fps index-exact, int8 product (both "
          f"epilogues), quantise and row gather bit-equal): {' '.join(checks)}",
          flush=True)

    grad_checks = {
        "fused_mlp M1001 gelu": (
            fused_mlp, fused_mlp_reference, mlp_inputs(torch, g, 1001, 1024, 4096),
            GRAD_TOL, ("dx", "dlnw", "dlnb", "dw1", "db1", "dw2", "db2")),
        "fused_ln_proj M1001 1024->3072": (
            fused_ln_proj, ln_proj_reference,
            ln_proj_inputs(torch, g, 1001, 1024, 3072), GRAD_TOL,
            ("dx", "dlnw", "dlnb", "dw", "db")),
        "attention [2,16,257,257]": (
            flash_attention, attention_reference,
            qkv_inputs(torch, g, 2, 16, 257, 257), ATTN_GRAD_TOL,
            ("dq", "dk", "dv")),
        "attention [2,1,256,600]": (
            flash_attention, attention_reference,
            qkv_inputs(torch, g, 2, 1, 256, 600), ATTN_GRAD_TOL,
            ("dq", "dk", "dv"))}
    lines = []
    for label, (fn, plain, args, tol, names) in grad_checks.items():
        errs = grad_errs(torch, g, fn, plain, args)
        lines.append(f"{label}: " + ", ".join(
            f"{n} {e:.2e}" for n, e in zip(names, errs)))
        if max(errs) > tol:
            fail(f"gradients of {label}: {dict(zip(names, errs))} > {tol}")
    del grad_checks
    print(f"[3 gradients] each Function's gradients against autograd of its "
          f"plain version, bf16 (<= {GRAD_TOL}, attention <= {ATTN_GRAD_TOL} "
          f"relative): " + "; ".join(lines), flush=True)

    # -- 4: the slices through the port's entry point -----------------------
    t0 = time.time()
    model = ViTLens("vitlensL", ("audio", "pc", "text"), device="cuda",
                    compute_dtype=torch.bfloat16, seed=SEED)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    acfg, pcfg = model.towers["audio"].cfg, model.towers["pc"].cfg
    n_layers, n_text = acfg.arch.layers, model.towers["text"].cfg.layers

    want_launches = {"audio": tower_launches(acfg),
                     "pc": tower_launches(pcfg, fps=1, point_encoder=1),
                     "text": launch_counts(fused_mlp=n_text)}
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
    launches = dict.fromkeys(COUNTED, 0)
    outs, per_call = [], []
    for path, b, inputs, pre in requests:
        emb, counts = run_counted(
            torch, counters, launches,
            lambda: model.encode(inputs, preprocessed=pre)[path])
        per_call.append((path, b, tuple(counts[k] for k in (
            "fused_mlp", "flash_attention", "fps", "point_encoder"))))
        outs.append((path, b, pre, emb))
        if counts != want_launches[path]:
            fail(f"{path} B={b}: launches {counts}, expected {want_launches[path]}")
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
    # A group size the point-encoder kernel does not take (M = 24): the
    # tokenizer's gate sends the groups to the plain encoder, on both.
    tok_card, tok_ref = model.towers["pc"].adapter, ref.towers["pc"].adapter
    saved = (tok_card.cfg, tok_ref.cfg)
    tok_card.cfg = tok_ref.cfg = dataclasses.replace(tok_card.cfg, group_size=24)
    try:
        emb24, counts24 = run_counted(
            torch, counters, launches,
            lambda: model.encode({"pc": clouds[1]}, preprocessed=True)["pc"])
        want24 = ref.encode({"pc": clouds[1].cpu()}, preprocessed=True)["pc"]
    finally:
        tok_card.cfg, tok_ref.cfg = saved
    if counts24 != tower_launches(pcfg, fps=1):
        fail(f"pc B=1 at group size 24: launches {counts24}, expected no "
             "point-encoder launch")
    cos["pc group size 24"] = torch.nn.functional.cosine_similarity(
        emb24.float().cpu(), want24.float(), dim=-1).min().item()
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
          + f"; pc B=1 FPS indices equal on card and CPU ({n_group} centers); "
          f"pc B=1 at group size 24 through the plain encoder, launches "
          f"{tuple(counts24[k] for k in ('fused_mlp', 'flash_attention', 'fps', 'point_encoder'))}",
          flush=True)

    # -- 4v: served from files -------------------------------------------------
    served = served_phase(torch, np, counters, launches, card)
    transformer_lens_phase(torch, counters, launches)

    # -- 4f: the fp32 default; 4h: head dims other than 64 --------------------
    fp32_phase(torch, counters, launches, fbanks[4][:2], clouds[4][:2],
               captions[:2])
    head_dim_phase(torch, counters, launches, fbanks[1])

    # -- 4g: the vitlensG pc encode (PNSA, bigG) from files, and served -------
    g_model = vitlensG_phase(torch, np, counters, launches)

    # -- 4q: the int8 quantized audio encode; 4s: the bench entry points -----
    fb64 = torch.randn(B, 3, acfg.audio.target_length, acfg.audio.mel_bins,
                       generator=g, device="cuda") * 0.5
    qmodel = quant_phase(
        torch, model, counters, launches, fbanks[1], fb64, captions,
        {"audio": launch_counts(int8_matmul_dequant=4 * n_layers,
                                int8_quantize=4 * n_layers,
                                flash_attention=want_launches["audio"][
                                    "flash_attention"]),
         "text": want_launches["text"],
         "text_int8": launch_counts(int8_matmul_dequant=4 * n_text,
                                    int8_quantize=4 * n_text)})
    by_script = scripts_phase(torch, counters, launches)

    # -- 4b, 4c: the audio train step -----------------------------------------
    trainer, state, tx, mask, sc, train_batch = train_phase(torch, np, counters,
                                                            launches)

    # -- 4d: the depth tri step; 4e: the video distill-tokens step ----------
    from vitlens_tpu_torch.train.step import StepConfig

    tri_depth = tri_train_phase(
        torch, np, counters, launches, "4d tri train", "depth",
        dict(lock_image=True, lock_text=True, lock_visual=True,
             unlock_trans_first_n_layers=4),
        StepConfig(n_tower=3, compute_dtype=torch.bfloat16),
        [("B=8", 8, 1)] * 3 + [("B=8 accum_freq 4", 8, 4)] * 2)
    tri_video = tri_train_phase(
        torch, np, counters, launches, "4e video distill", "video",
        dict(lock_image=True, lock_text=True, lock_visual=True),
        StepConfig(n_tower=3, video_distill=True,
                   contra_loss_type="distill_token",
                   compute_dtype=torch.bfloat16),
        [("B=4 accum_freq 2", 4, 2)] * 2, frames=8)
    # -- 4p: the pc tri step (batch BatchNorm, random FPS starts) -----------
    tri_pc = tri_train_phase(
        torch, np, counters, launches, "4p pc tri train", "pc",
        dict(lock_image=True, lock_text=True, lock_visual=True),
        StepConfig(n_tower=3, compute_dtype=torch.bfloat16),
        [("B=8", 8, 1)] * 2 + [("B=8 accum_freq 4", 8, 4)] * 2)
    # -- 4x: the training CLI (files, eval, checkpoints, resume) ----------
    cli = train_cli_phase(torch, np, counters, launches, card)

    # -- 5: timing at the B64 shapes -----------------------------------------
    timings = {name: [] for name in kernels}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, (m, d, h) in (("audio trunk", (257 * B * 3, 1024, 4096)),
                             ("pc trunk", (257 * B, 1024, 4096)),
                             ("text", (77 * B, 768, 3072))):
        a = mlp_inputs(torch, g, m, d, h)
        k_ms, p_ms = paired_ms(lambda: fused_mlp(*a), lambda: fused_mlp_reference(*a))
        bd, by = mlp_bound(m, d, h)
        x, lnw, lnb, w1, b1, w2, b2 = a
        y = torch.nn.functional.layer_norm(x.float(), (d,), lnw, lnb).bfloat16()
        hid = torch.empty(m, h, dtype=torch.bfloat16, device="cuda")
        b1h, b2h = b1.bfloat16(), b2.bfloat16()
        gemm_ms = cuda_ms(lambda: (torch.addmm(b1h, y, w1, out=hid),
                                   torch.addmm(b2h, hid, w2)))
        timings["fused_mlp"].append(
            {"shape": f"{label} M={m} D={d} H={h}", "ms": k_ms, "plain_ms": p_ms,
             "gemm_only_ms": gemm_ms, "bound_ms": bd, "bound_by": by,
             "library_ms": None, "tflops": 4 * m * d * h / k_ms / 1e9})
        del a, x, y, hid
    m = 257 * B  # the B64 train step's audio trunk
    a = mlp_inputs(torch, g, m, 1024, 4096)
    k_ms, p_ms = paired_ms(lambda: fused_mlp_save_preact(*a),
                           lambda: fused_mlp_reference(*a, save_preact=True))
    bd, by = preact_bound(m, 1024, 4096)
    timings["fused_mlp"].append(
        {"shape": f"save-preact variant, train trunk M={m} D=1024 H=4096",
         "ms": k_ms, "plain_ms": p_ms, "bound_ms": bd, "bound_by": by,
         "library_ms": None, "plain_variant_ms": cuda_ms(lambda: fused_mlp(*a)),
         "tflops": 4 * m * 1024 * 4096 / k_ms / 1e9})
    del a
    for label, (m, d, n) in (("audio encode trunk", (257 * B * 3, 1024, 3072)),
                             ("train trunk", (257 * B, 1024, 3072)),
                             ("text", (77 * B, 768, 2304))):
        a = ln_proj_inputs(torch, g, m, d, n)
        k_ms, p_ms = paired_ms(lambda: fused_ln_proj(*a),
                               lambda: ln_proj_reference(*a), plain_iters=5)
        x, lnw, lnb, w, b = a
        y = torch.nn.functional.layer_norm(x.float(), (d,), lnw, lnb).bfloat16()
        gemm_ms = cuda_ms(lambda: torch.addmm(b.bfloat16(), y, w))
        bd, by = ln_proj_bound(m, d, n)
        timings["fused_ln_proj"].append(
            {"shape": f"{label} M={m} D={d} N={n}", "ms": k_ms, "plain_ms": p_ms,
             "gemm_only_ms": gemm_ms, "bound_ms": bd, "bound_by": by,
             "library_ms": None, "tflops": 2 * m * d * n / k_ms / 1e9})
        del a, x, y, w
    for label, (b, h, nq, nk, dh) in (("audio trunk", (B * 3, 16, 257, 257, 64)),
                                      ("audio lens cross", (B * 3, 1, 256, 600, 64)),
                                      ("audio lens self", (B * 3, 16, 256, 256, 64)),
                                      ("pc and EEG lens cross", (B, 1, 256, 512, 64)),
                                      ("video lens cross", (B, 1, 256, 2048, 64)),
                                      ("bigG trunk", (B * 3, 16, 257, 257, 104))):
        q, k, v = qkv_inputs(torch, g, b, h, nq, nk, dh)
        k_ms, p_ms = paired_ms(lambda: flash_attention(q, k, v),
                               lambda: attention_reference(q, k, v))
        bf16_ms = cuda_ms(lambda: plain_attention(q, k, v, None, dh ** -0.5))
        lib_ms = cuda_ms(lambda: sdpa(q, k, v))
        bd, by = attn_bound(b, h, nq, nk, dh)
        # the kernel's device time beside the call's: a short call through
        # the Python wrapper can be bound by the host's enqueue
        row = {"shape": f"{label} [{b},{h},{nq},{nk},{dh}]", "ms": k_ms,
               "device_ms": device_ms(torch, lambda: flash_attention(q, k, v)),
               "plain_ms": p_ms, "plain_bf16_ms": bf16_ms, "bound_ms": bd,
               "bound_by": by, "library_ms": lib_ms}
        if label == "audio trunk":  # as the trunk calls it: packed-qkv views
            qkv = torch.randn(b, nq, 3 * h * 64, generator=g,
                              device="cuda").bfloat16()
            qv, kv_, vv = qkv.view(b, nq, 3, h, 64).permute(2, 0, 3, 1, 4)
            row["packed_views_ms"] = cuda_ms(lambda: flash_attention(qv, kv_, vv))
            del qkv, qv, kv_, vv
        timings["flash_attention"].append(row)
        del q, k, v
    for b in (B, 1):  # the pc encode's batch (C = 2), and one request (C = 4)
        xyz, start = fps_timed[b]
        k_ms, p_ms = paired_ms(lambda: fps_indices(xyz, 512, start),
                               lambda: fps_indices_reference(xyz, 512, start),
                               plain_iters=3)
        bd, by = fps_bound(b, 8192, 512)
        timings["fps"].append({"shape": f"B{b} N8192 npoint512", "ms": k_ms,
                               "plain_ms": p_ms, "bound_ms": bd, "bound_by": by,
                               "library_ms": None})
    k_ms, p_ms = paired_ms(lambda: fused_point_encoder(*enc_args),
                           lambda: point_encoder_reference(*enc_args),
                           plain_iters=5)
    bd, by = enc_bound(B * 512, 32, *ENC_WIDTHS)
    timings["point_encoder"].append(
        {"shape": f"[{B},512,32,3] -> [{B},512,256]", "ms": k_ms,
         "plain_ms": p_ms, "bound_ms": bd, "bound_by": by, "library_ms": None})
    del enc_args, fps_timed
    time_new_kernels(torch, g, timings)
    timings["fused_ln_qkv"] = [timings["fused_ln_proj"][1]]  # M=16448, 1024->3072
    for name, rows in timings.items():
        for r in rows:
            print(f"[5 timing] {card} | {name} {r['shape']}: kernel "
                  f"{r['ms']:.4f} ms"
                  + (f" (device {r['device_ms']:.4f} ms)" if "device_ms" in r else "")
                  + f", plain {r['plain_ms']:.4f} ms"
                  + (f", plain bf16 {r['plain_bf16_ms']:.4f} ms"
                     if "plain_bf16_ms" in r else "")
                  + (f", plain variant {r['plain_variant_ms']:.4f} ms"
                     if "plain_variant_ms" in r else "")
                  + (f", cuBLAS addmm on the normalised input (GEMM only) "
                     f"{r['gemm_only_ms']:.4f} ms" if "gemm_only_ms" in r else "")
                  + (f", kernel on the packed-qkv views {r['packed_views_ms']:.4f} ms"
                     if "packed_views_ms" in r else "")
                  + (f", through the wrapper back to back {r['wrapper_ms']:.4f} ms"
                     f" (host {r['host_us']:.2f} us a call; index_select device "
                     f"{r['library_device_ms']:.4f} ms, host {r['library_host_us']:.2f} us)"
                     if "wrapper_ms" in r else "")
                  + (f", library {r['library_ms']:.4f} ms"
                     if r["library_ms"] is not None else "")
                  + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
                  + (f", kernel {r['tflops']:.1f} TFLOP/s" if "tflops" in r else "")
                  + (f", kernel {r['tops']:.1f} TOP/s" if "tops" in r else "")
                  + (f", three-launch fused MLP on the same function "
                     f"{r['three_launch_ms']:.4f} ms" if "three_launch_ms" in r else "")
                  + (f", today's split (library out-projection + residual, "
                     f"then the three-launch fused MLP) {r['today_split_ms']:.4f} ms"
                     if "today_split_ms" in r else ""),
                  flush=True)

    pc64 = torch.randn(B, npts, 3, generator=g, device="cuda") * 0.3

    def audio64():
        return model.encode({"audio": fb64}, preprocessed=True)["audio"]

    def pc64_encode():
        return model.encode({"pc": pc64}, preprocessed=True)["pc"]

    def qaudio64():
        return qmodel.encode({"audio": fb64}, preprocessed=True)["audio"]

    audio_rate = encode_rate(torch, card, f"audio encode B{B} x 3 clips bf16",
                             audio64, B, rows_note=f" ({B * 3} clips per call)")
    pc_rate = encode_rate(torch, card, f"pc encode B{B} x {npts} points bf16",
                          pc64_encode, B)
    pc1_ms = encode_latency(
        torch, card, f"pc encode B=1 x {npts} points bf16 (one request)",
        lambda: model.encode({"pc": clouds[1]}, preprocessed=True)["pc"])
    os.environ["VITLENS_ENABLE_FUSED_LNQKV"] = "1"
    try:
        encode_rate(torch, card, f"audio encode B{B} x 3 clips bf16, opt-in "
                    "fused LN + qkv", audio64, B,
                    rows_note=f" ({B * 3} clips per call)")
    finally:
        del os.environ["VITLENS_ENABLE_FUSED_LNQKV"]
    q_rates = [encode_rate(torch, card, f"audio encode B{B} x 3 clips, int8 "
                           "(W8A8) quantized trunk, bf16 elsewhere", qaudio64, B,
                           rows_note=f" ({B * 3} clips per call)")]
    audio_again = encode_rate(torch, card, f"audio encode B{B} x 3 clips bf16 "
                              "(again, default)", audio64, B,
                              rows_note=f" ({B * 3} clips per call)")
    q_rates.append(encode_rate(torch, card, f"audio encode B{B} x 3 clips, int8 "
                               "(W8A8) quantized trunk (again)", qaudio64, B,
                               rows_note=f" ({B * 3} clips per call)"))
    profile_encode(torch, card, f"B{B} audio encode", audio64)
    profile_encode(torch, card, f"B{B} int8 quantized audio encode", qaudio64)
    del qmodel
    profile_encode(torch, card, f"B{B} pc encode", pc64_encode)

    from vitlens_tpu_torch.train.step import make_train_step

    train_step = make_train_step(trainer.cfg, tx, mask, sc)
    batch64 = {k: v.cuda() for k, v in train_batch(B).items()}

    def step64():
        train_step(state, batch64)

    train_rates = {False: [], True: []}
    for opt_in in (False, True, True, False):
        if opt_in:
            os.environ["VITLENS_ENABLE_FUSED_LNQKV"] = "1"
        try:
            train_rates[opt_in] += [train_rate(torch, card, f"audio train step B{B} bf16 (recipe: "
                       f"lock visual + text, unlock CLS; no remat)"
                       + (", opt-in fused LN + qkv" if opt_in else ""), step64, B)]
        finally:
            os.environ.pop("VITLENS_ENABLE_FUSED_LNQKV", None)
    profile_encode(torch, card, f"B{B} audio train step", step64)
    del trainer, state, train_step, batch64
    tri_rates = tri_timings(torch, np, card, [(tri_depth, 0, (B,)),
                                              (tri_video, 8, (B, 32)),
                                              (tri_pc, 0, (B, 32))])
    del tri_depth, tri_video, tri_pc
    g_rate = vitlensG_timings(torch, card, g_model)
    del g_model
    served_rates = served_timings(torch, np, card, served)
    host_library_timings(torch, np, card, served)
    train_cli_timings(card, cli)
    shutil.rmtree(served["root"], ignore_errors=True)
    del served

    replaces = {
        "fused_mlp": "vitlens_tpu/ops/fused_mlp.py:105",
        "flash_attention": "vitlens_tpu/ops/flash_attention.py:53",
        "fps": "vitlens_tpu/ops/fps.py:120, vitlens_tpu/ops/fps.py:175",
        "point_encoder": "vitlens_tpu/ops/fused_point_encoder.py:116",
        "fused_ln_proj": "vitlens_tpu/ops/fused_ln_proj.py:56",
        "int8_matmul": "scripts/bench_int8_native.py:64",
        "int8_matmul_dequant": "scripts/bench_int8_native.py:64 (with the XLA-fused "
                               "tail of vitlens_tpu/quant.py:84)",
        "int8_quantize": "vitlens_tpu/quant.py:77 (the XLA-fused head of "
                         "int8_matmul; no pallas_call)",
        "row_gather": "scripts/bench_dma_gather.py:49",
        "fused_mlp_chunked": "scripts/fused_mlp_pallas.py:91",
        "fused_attnout_mlp": "scripts/fused_attnout_mlp_pallas.py:62",
        "fused_ln_qkv": "scripts/fused_ln_qkv_pallas.py:48"}
    sources = {"fused_mlp": "fused_mlp.cu", "flash_attention": "flash_attention.cu",
               "fps": "fps.cu", "point_encoder": "fused_point_encoder.cu",
               "fused_ln_proj": "fused_ln_proj.cu", "int8_matmul": "int8_matmul.cu",
               "int8_matmul_dequant": "int8_matmul.cu",
               "int8_quantize": "int8_matmul.cu",
               "row_gather": "row_gather.cu",
               "fused_mlp_chunked": "fused_mlp.cu",
               "fused_attnout_mlp": "fused_mlp_chain.cu",
               "fused_ln_qkv": "fused_ln_proj.cu"}
    # kernel 1's count is both variants'; the split is beside it
    by_variant = {"plain": launches["fused_mlp"],
                  "save_preact": launches["fused_mlp_save_preact"]}
    launches["fused_mlp"] += launches["fused_mlp_save_preact"]
    # the LN + qkv prototype's path is its entry point's run
    launches["fused_ln_qkv"] = by_script["fused_ln_qkv"]
    line = []
    for name in kernels:
        main = timings[name][0]
        line.append({
            "name": name, "route": "cuda",
            "source": f"vitlens_tpu_torch/csrc/{sources[name]}",
            "replaces": replaces[name], "launches": launches[name],
            **({"launches_by_variant": by_variant} if name == "fused_mlp" else {}),
            "max_abs_err": err[name], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shapes": timings[name]})
    for name, n in launches.items():
        if n == 0:
            fail(f"{name}: no launch on any main path")
    print(f"[done] {card} | audio encode B{B}: {audio_rate:.2f} and "
          f"{audio_again:.2f} samples/s float bf16, {q_rates[0]:.2f} and "
          f"{q_rates[1]:.2f} int8 quantized "
          f"({max(q_rates) / max(audio_rate, audio_again):.3f}x); pc encode "
          f"B{B}: {pc_rate:.2f} samples/s, B=1 latency {pc1_ms:.2f} ms; audio "
          f"train step B{B}: {max(train_rates[False]):.2f} samples/s, opt-in "
          f"{max(train_rates[True]):.2f}; "
          + "; ".join(f"{k} train step B{b}: {r:.2f} samples/s"
                      for k, (b, r) in tri_rates.items())
          + f"; vitlensG pc encode B16: {g_rate:.2f} samples/s"
          + f"; image, depth, EEG, video encode B{B}: "
          + ", ".join(f"{served_rates[m]:.2f}" for m in ("image", "depth", "eeg", "video"))
          + f" samples/s; served audio closed loop: "
          f"{served_rates['served_rps']:.2f} requests/s; whole run "
          f"{time.time() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
