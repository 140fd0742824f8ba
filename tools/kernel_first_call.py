#!/usr/bin/env python3
"""First call of new kernels on the card: compile every csrc/*.cu with
``-Xptxas -v`` (registers, shared memory, spills), then hold kernels against
their plain versions at their paths' shapes and at edge shapes, with one
timing each: FPS and the point encoder (ragged N, partial group tiles, other
group sizes and widths), the fused MLP, both variants (a small square
product first, ragged M, both trunk widths, bigG's D = 1664, and the audio
trunk's M = 49344 beside cuBLAS), attention (NQ and NK from 1 to 600, NK past
the resident limit, the packed-qkv and Lens views bit-equal to contiguous
copies, the four main shapes beside SDPA; CoCa's pooler at head dim 96, the
decoder's cross NQ 1/29/76 by NK 256/257 and their gradients, a broadcast
query refused, the three CoCa shapes beside SDPA), attention at head dims
other than 64 (8 to 128: NQ, NK in {1, 77, 257, 600}, the packed-qkv views, and
[192, 16, 257, 257] at D = 104 beside SDPA), the fused LN + projection
(ragged M, both trunk widths), the int8 product's two epilogues (INT32 and
DEQUANT, bit-equal: ragged M, the smallest legal K and N, a K that is not a
multiple of the k-step, with and without bias, bf16 and fp32 output), the
int8 quantise kernel (bit-equal: all-zero rows, exact .5 ties, bf16 and fp32
input), the row gather (a single row, repeated and boundary ids, rows of 16
bytes; its device time from the profiler and the wrapper's host time a call
beside index_select's) and the chained fused MLP with and without the
out-projection (ragged M, both widths and activations).

    python3 tools/kernel_first_call.py [fps] [encoder] [mlp] [attn] [attn_hd] [ln_proj] [int8] [quantize] [gather] [chain]

With no names it checks all ten. Needs one CUDA device and nvcc. Exits
non-zero if a kernel disagrees.
"""

import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402

from vitlens_tpu_torch.ops import _build  # noqa: E402
from vitlens_tpu_torch.ops.flash_attention import (  # noqa: E402
    attention_reference, flash_attention)
from vitlens_tpu_torch.ops.fps import (  # noqa: E402
    cluster_size, fps_indices, fps_indices_reference)
from vitlens_tpu_torch.ops.fused_ln_proj import (  # noqa: E402
    fused_ln_proj, ln_proj_reference)
from vitlens_tpu_torch.ops.fused_mlp_chain import (  # noqa: E402
    fused_attnout_mlp, fused_mlp_chain_reference, fused_mlp_chunked)
from vitlens_tpu_torch.ops.int8_matmul import (  # noqa: E402
    dequant_reference, int8_matmul, int8_matmul_dequant, int8_matmul_reference,
    int8_quantize, int8_quantize_reference)
from vitlens_tpu_torch.ops.row_gather import (  # noqa: E402
    row_gather, row_gather_reference)
from vitlens_tpu_torch.ops.fused_mlp import (  # noqa: E402
    fused_mlp, fused_mlp_reference, fused_mlp_save_preact)
from vitlens_tpu_torch.ops.fused_point_encoder import (  # noqa: E402
    fused_point_encoder, point_encoder_reference)


def ms(fn, iters=5):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def encoder_inputs(g, shape, widths):
    c1, c2, c3, c4 = widths

    def r(*sh, std=1.0):
        return torch.randn(*sh, generator=g, device="cuda") * std

    def bn(n):
        return r(n, std=0.2), 0.5 + r(n).abs(), 1 + r(n, std=0.2), r(n, std=0.1)

    return ((r(*shape, 3, std=0.1)).bfloat16(), r(3, c1, std=0.5).bfloat16(),
            r(c1, std=0.1), bn(c1), r(c1, c2, std=c1 ** -0.5).bfloat16(),
            r(c2, std=0.1), r(2 * c2, c3, std=(2 * c2) ** -0.5).bfloat16(),
            r(c3, std=0.1), bn(c3), r(c3, c4, std=c3 ** -0.5).bfloat16(),
            r(c4, std=0.1))


# (B, N, npoint, cloud, start): the pc encode's shape, one row (a cluster of
# 4), N past 16384 (B64: a partition of 8193 points puts one in shared
# memory; 100000 points reach the global-memory tier at B = 1 and B64, 30000
# at B = 133, one CTA a row), npoint past N, and clouds with exact ties.
FPS_CASES = ((64, 8192, 512, "random", "zero"), (1, 8192, 512, "random", "zero"),
             (8, 10000, 512, "random", "random"), (3, 100, 64, "random", "random"),
             (2, 31, 36, "random", "random"), (64, 16385, 512, "random", "zero"),
             (1, 100000, 512, "random", "random"), (64, 100000, 32, "random", "zero"),
             (133, 30000, 16, "random", "random"), (1, 8192, 512, "lattice", "zero"),
             (64, 8192, 512, "lattice", "random"), (2, 5000, 300, "duplicates", "random"))
# (groups shape with M, widths): every M the kernel takes at a group count
# that fills no whole last tile, C4 = 128, 384 and 512 (conv4 in passes),
# many tiles a CTA with groups straddling its two consumers, then the pc
# encode's B64 shape.
ENC_CASES = (((1, 25, 16), (128, 256, 512, 256)),
             ((3, 7, 32), (128, 256, 512, 256)),
             ((2, 9, 48), (128, 256, 512, 256)),
             ((3, 7, 64), (128, 256, 512, 256)),
             ((1, 3, 80), (128, 256, 512, 256)),
             ((2, 5, 128), (128, 256, 512, 256)),
             ((2, 9, 32), (128, 256, 512, 128)),
             ((2, 9, 48), (128, 256, 512, 384)),
             ((3, 7, 128), (128, 256, 512, 512)),
             ((1, 1, 16), (128, 256, 512, 256)),
             ((1, 1000, 32), (128, 256, 512, 256)),
             ((3, 101, 80), (128, 256, 512, 256)),
             ((64, 512, 48), (128, 256, 512, 256)),
             ((64, 512, 32), (128, 256, 512, 512)),
             ((64, 512, 32), (128, 256, 512, 256)))


def rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def mlp_args(g, m, d, h):
    def r(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

    f32 = torch.float32
    return (r(m, d, std=0.5), 1 + r(d, std=0.1, dtype=f32),
            r(d, std=0.1, dtype=f32), r(d, h, std=d ** -0.5),
            r(h, std=0.1, dtype=f32), r(h, d, std=h ** -0.5),
            r(d, std=0.1, dtype=f32))


MLP_CASES = ((256, 256, 256), (6168, 1024, 4096), (4100, 1024, 4096),
             (1001, 1024, 4096), (77, 768, 3072), (616, 768, 3072),
             (4100, 1664, 8192), (1, 1024, 4096))


def check_mlp(g):
    """Both variants of the fused MLP against the plain version: out within
    2.5e-2 and the pre-activation a (the first product alone, with b1)
    within 1e-2 relative (bf16), the plain variant's out equal to the
    save-preact variant's; small square first, then the paths' shapes, a
    ragged M, both trunk widths and bigG's D = 1664; then the audio trunk's
    M = 49344 timed beside cuBLAS on the same two products."""
    ok = True
    for m, d, h in MLP_CASES:
        args = mlp_args(g, m, d, h)
        for act in ("gelu", "quick_gelu"):
            out, a = fused_mlp_save_preact(*args, act=act)
            plain_out = fused_mlp(*args, act=act)
            torch.cuda.synchronize()
            want_out, want_a = fused_mlp_reference(*args, act=act, save_preact=True)
            e_out, e_a = rel_err(out, want_out), rel_err(a, want_a)
            same = torch.equal(out, plain_out)
            ok &= e_out <= 2.5e-2 and e_a <= 1e-2 and same
            print(f"mlp M{m} D{d} H{h} {act}: out {e_out:.2e}, a {e_a:.2e}, out "
                  f"equal to the plain variant's: {same}; save-preact "
                  f"{ms(lambda: fused_mlp_save_preact(*args, act=act)):.4f} ms, "
                  f"plain variant {ms(lambda: fused_mlp(*args, act=act)):.4f} ms",
                  flush=True)
    m, d, h = 257 * 64 * 3, 1024, 4096
    x, lnw, lnb, w1, b1, w2, b2 = args = mlp_args(g, m, d, h)
    y = torch.nn.functional.layer_norm(x.float(), (d,), lnw, lnb).bfloat16()
    hid = torch.empty(m, h, dtype=torch.bfloat16, device="cuda")
    b1h, b2h = b1.bfloat16(), b2.bfloat16()
    t = ms(lambda: fused_mlp(*args), 10)
    t_lib = ms(lambda: (torch.addmm(b1h, y, w1, out=hid), torch.addmm(b2h, hid, w2)), 10)
    print(f"mlp M{m} D{d} H{h}: kernel {t:.4f} ms "
          f"({4 * m * d * h / t / 1e9:.1f} TFLOP/s); cuBLAS addmm on the "
          f"normalised input, the two products only, {t_lib:.4f} ms", flush=True)
    return ok


ATTN_CASES = tuple((2, 3, nq, nk) for nq in (1, 7, 77, 257, 600)
                   for nk in (1, 7, 77, 257, 600)) + (
    (2, 2, 257, 833), (1, 2, 130, 2048), (3, 1, 256, 4100))
ATTN_MAIN = (("audio trunk", 192, 16, 257, 257), ("audio lens cross", 192, 1, 256, 600),
             ("audio lens self", 192, 16, 256, 256), ("pc lens cross", 64, 1, 256, 512))


def check_attn(g):
    """Attention against its plain version (bf16, 1e-2 relative) at every
    NQ, NK in {1, 7, 77, 257, 600} and at NK past the resident limit (833
    keys need 14 chunks of 64); the packed-qkv views of the trunk and the
    Lens's q / to_kv views bit-equal to the same call on contiguous copies;
    then the four main shapes timed beside SDPA (contiguous inputs) and the
    trunk call on the packed-qkv views."""
    ok = True
    for b, h, nq, nk in ATTN_CASES:
        q, k, v = (torch.randn(b, h, n, 64, generator=g, device="cuda").bfloat16()
                   for n in (nq, nk, nk))
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        e = rel_err(got, attention_reference(q, k, v))
        good = bool(torch.isfinite(got).all()) and e <= 1e-2
        ok &= good
        if not good or (nq, nk) in ((1, 1), (257, 257), (600, 600)) or nk > 600:
            print(f"attn B{b} H{h} NQ{nq} NK{nk}: rel err {e:.2e}", flush=True)
    for b, n, heads in ((3, 257, 16), (2, 77, 12)):  # trunk: packed qkv views
        qkv = torch.randn(b, n, 3 * heads * 64, generator=g, device="cuda").bfloat16()
        q, k, v = qkv.view(b, n, 3, heads, 64).permute(2, 0, 3, 1, 4)
        got = flash_attention(q, k, v)
        want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        ok &= same
        print(f"attn packed-qkv views B{b} N{n} H{heads}: bit-equal to "
              f"contiguous copies: {same}", flush=True)
    for b, nq, nk, heads in ((3, 256, 600, 1), (2, 256, 256, 16)):  # Lens
        q = torch.randn(b, nq, heads * 64, generator=g, device="cuda").bfloat16()
        kv = torch.randn(b, nk, 2 * heads * 64, generator=g, device="cuda").bfloat16()
        q = q.view(b, nq, heads, 64).transpose(1, 2)
        k, v = kv.view(b, nk, 2, heads, 64).permute(2, 0, 3, 1, 4)
        got = flash_attention(q, k, v)
        want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        ok &= same
        print(f"attn Lens views B{b} NQ{nq} NK{nk} H{heads}: bit-equal to "
              f"contiguous copies: {same}", flush=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, b, h, nq, nk in ATTN_MAIN:
        q, k, v = (torch.randn(b, h, n, 64, generator=g, device="cuda").bfloat16()
                   for n in (nq, nk, nk))
        e = rel_err(flash_attention(q, k, v), attention_reference(q, k, v))
        ok &= e <= 1e-2
        line = (f"attn {label} [{b},{h},{nq},{nk}]: rel err {e:.2e}; kernel "
                f"{ms(lambda: flash_attention(q, k, v), 20):.4f} ms, SDPA "
                f"{ms(lambda: sdpa(q, k, v), 20):.4f} ms")
        if label == "audio trunk":
            qkv = torch.randn(b, nq, 3 * h * 64, generator=g, device="cuda").bfloat16()
            qv, kv_, vv = qkv.view(b, nq, 3, h, 64).permute(2, 0, 3, 1, 4)
            line += (f", kernel on the packed-qkv views "
                     f"{ms(lambda: flash_attention(qv, kv_, vv), 20):.4f} ms")
        print(line, flush=True)
    # CoCa's shapes: the pooler's head dim 96, the decoder's cross NQ/NK, the
    # broadcast query refused (chip_smoke.py phase 3's checks; they raise)
    err, checks = {"flash_attention": 0.0}, []
    chip_smoke.check_coca_kernels(torch, g, err, checks)
    print("attn CoCa: " + " ".join(checks), flush=True)
    for label, (fn, plain, args, tol, names) in chip_smoke.coca_grad_checks(
            torch, g).items():
        errs = chip_smoke.grad_errs(torch, g, fn, plain, args)
        ok &= max(errs) <= tol
        print(f"{label} gradients: " + ", ".join(
            f"{n} {e:.2e}" for n, e in zip(names, errs)), flush=True)
    for label, (b, h, nq, nk, d) in chip_smoke.COCA_ATTN:
        q, k, v = chip_smoke.qkv_inputs(torch, g, b, h, nq, nk, d)
        print(f"attn {label} [{b},{h},{nq},{nk},{d}]: kernel "
              f"{ms(lambda: flash_attention(q, k, v), 20):.4f} ms, SDPA "
              f"{ms(lambda: sdpa(q, k, v), 20):.4f} ms", flush=True)
    return ok


HD_CASES = tuple((2, 3, nq, nk) for nq in (1, 77, 257, 600) for nk in (1, 77, 257, 600))


def check_attn_hd(g):
    """Attention at head dims 8 to 128 against its plain version (bf16, 1e-2
    relative) at NQ, NK in {1, 77, 257, 600}; the packed-qkv views bit-equal
    to contiguous copies; the bigG trunk's shape at D = 104 timed beside
    SDPA."""
    ok = True
    for d in (8, 32, 80, 88, 96, 104, 112, 128):
        worst = 0.0
        for b, h, nq, nk in HD_CASES:
            q, k, v = (torch.randn(b, h, n, d, generator=g, device="cuda").bfloat16()
                       for n in (nq, nk, nk))
            got = flash_attention(q, k, v)
            torch.cuda.synchronize()
            e = rel_err(got, attention_reference(q, k, v))
            good = bool(torch.isfinite(got).all()) and e <= 1e-2
            ok &= good
            worst = max(worst, e)
            if not good:
                print(f"attn D{d} B{b} H{h} NQ{nq} NK{nk}: rel err {e:.2e}", flush=True)
        qkv = torch.randn(3, 257, 3 * 16 * d, generator=g, device="cuda").bfloat16()
        q, k, v = qkv.view(3, 257, 3, 16, d).permute(2, 0, 3, 1, 4)
        got = flash_attention(q, k, v)
        want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        ok &= same
        print(f"attn D{d}: worst rel err {worst:.2e} over NQ, NK in 1..600; "
              f"packed-qkv views bit-equal: {same}", flush=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for d in (104, 64):
        q, k, v = (torch.randn(192, 16, 257, d, generator=g, device="cuda").bfloat16()
                   for _ in range(3))
        e = rel_err(flash_attention(q, k, v), attention_reference(q, k, v))
        ok &= e <= 1e-2
        print(f"attn [192,16,257,257,{d}]: rel err {e:.2e}; kernel "
              f"{ms(lambda: flash_attention(q, k, v), 20):.4f} ms, SDPA "
              f"{ms(lambda: sdpa(q, k, v), 20):.4f} ms", flush=True)
    return ok


def check_ln_proj(g):
    """The fused LN + projection against its plain version, bf16, 1e-2
    relative: ragged M, the three trunk widths, bigG's ragged N = 4992, and
    the trunk's M = 16448 and 49344."""
    ok = True
    for m, d, n in ((6168, 1024, 3072), (1001, 1024, 3072), (1001, 768, 2304),
                    (1, 768, 2304), (77, 1664, 4992), (4100, 1664, 4992),
                    (16448, 1024, 3072), (49344, 1024, 3072)):
        x = (torch.randn(m, d, generator=g, device="cuda") * 0.5
             + torch.randn(d, generator=g, device="cuda")).bfloat16()
        lnw = 1 + torch.randn(d, generator=g, device="cuda") * 0.1
        lnb = torch.randn(d, generator=g, device="cuda") * 0.1
        w = (torch.randn(d, n, generator=g, device="cuda") * d ** -0.5).bfloat16()
        b = torch.randn(n, generator=g, device="cuda") * 0.1
        got = fused_ln_proj(x, lnw, lnb, w, b)
        torch.cuda.synchronize()
        e = rel_err(got, ln_proj_reference(x, lnw, lnb, w, b))
        ok &= bool(torch.isfinite(got).all()) and e <= 1e-2
        print(f"ln_proj M{m} D{d} N{n}: rel err {e:.2e}; kernel "
              f"{ms(lambda: fused_ln_proj(x, lnw, lnb, w, b)):.4f} ms, plain "
              f"{ms(lambda: ln_proj_reference(x, lnw, lnb, w, b), 2):.4f} ms",
              flush=True)
    return ok


def check_int8(g):
    """The int8 product's two epilogues against their plain versions: INT32
    equal element for element (extreme operands, all +-127, hold the
    accumulator's range); DEQUANT bit-equal to the plain dequantise of the
    plain product, with and without bias, in bf16 and fp32."""
    ok = True
    for m, k, n in ((1, 32, 128), (130, 160, 384), (77, 4096, 128),
                    (4096, 4096, 4096), (49344, 1024, 4096), (49344, 1024, 3072),
                    (49344, 4096, 1024), (4928, 768, 2304), (1001, 1024, 1024)):
        a = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                          dtype=torch.int8)
        if (m, k, n) == (77, 4096, 128):
            a.fill_(-127)
            b.fill_(127)
        b_t = b.t().contiguous()
        got = int8_matmul(a, b, b_t)
        torch.cuda.synchronize()
        acc = int8_matmul_reference(a, b)
        n_diff = (got != acc).sum().item()
        ok &= n_diff == 0
        xs = torch.rand(m, 1, generator=g, device="cuda") * 0.02 + 1e-4
        ws = torch.rand(1, n, generator=g, device="cuda") * 0.01 + 1e-5
        bias = torch.randn(n, generator=g, device="cuda")
        dq = []
        for bb, dt in ((bias, torch.bfloat16), (None, torch.bfloat16),
                       (bias, torch.float32)):
            y = int8_matmul_dequant(a, b, xs, ws, bb, dt, b_t)
            torch.cuda.synchronize()
            want = dequant_reference(acc, xs, ws, bb, dt)
            dq.append(int((y.view(torch.int16 if dt == torch.bfloat16 else torch.int32)
                           != want.view(torch.int16 if dt == torch.bfloat16
                                        else torch.int32)).sum().item()))
        ok &= not any(dq)
        t = ms(lambda: int8_matmul(a, b, b_t))
        t_dq = ms(lambda: int8_matmul_dequant(a, b, xs, ws, bias, torch.bfloat16, b_t))
        print(f"int8 M{m} K{k} N{n}: INT32 {n_diff} elements differ, DEQUANT "
              f"(bias bf16, no bias bf16, bias fp32) {dq} differ; INT32 {t:.4f} ms "
              f"({2 * m * k * n / t / 1e9:.1f} TOP/s), DEQUANT {t_dq:.4f} ms, "
              "torch._int_mm "
              + (f"{ms(lambda: torch._int_mm(a, b)):.4f} ms" if m > 16 and k % 8 == 0
                 and n % 8 == 0 else "n/a"), flush=True)
    return ok


def check_quantize(g):
    """The quantise kernel against its plain version: xi and xs equal, bf16
    and fp32 input, at the quantized encode's four shapes' K and ragged M."""
    ok = True
    for m, k in ((49344, 1024), (49344, 4096), (4928, 768), (1001, 3072), (3, 32)):
        for dt in (torch.bfloat16, torch.float32):
            x = chip_smoke.quant_rows(torch, g, m, k, dt)
            xi, xs = int8_quantize(x)
            torch.cuda.synchronize()
            want_i, want_s = int8_quantize_reference(x)
            n_i = (xi != want_i).sum().item()
            n_s = (xs.view(torch.int32) != want_s.view(torch.int32)).sum().item()
            ok &= n_i == 0 and n_s == 0
            t = ms(lambda: int8_quantize(x), 20)
            bd = chip_smoke.quantize_bound(m, k, x.element_size())[0]
            print(f"quantize M{m} K{k} {dt}: {n_i} of xi and {n_s} of xs differ; "
                  f"kernel {t:.4f} ms, plain {ms(lambda: int8_quantize_reference(x), 3):.4f}"
                  f" ms, bound {bd:.4f} ms (bytes)", flush=True)
    return ok


def check_gather(g):
    """The row gather against its plain version: bit-equal; at the bench's
    shape, the kernel's device time (profiler) and the wrapper's host time a
    call beside index_select's, and both timed back to back."""
    ok = True
    for v, d, j, dtype in ((49408, 512, 9856, torch.bfloat16),
                           (49408, 512, 1, torch.bfloat16),
                           (100, 8, 333, torch.bfloat16),
                           (1000, 768, 4928, torch.float32),
                           (1000, 64, 300000, torch.bfloat16)):
        table = torch.randn(v, d, generator=g, device="cuda").to(dtype)
        ids = torch.randint(0, v, (j,), generator=g, device="cuda",
                            dtype=torch.int32)
        ids[0] = v - 1
        if j > 3:
            ids[1], ids[2], ids[3] = 0, 0, v - 1
        got = row_gather(table, ids)
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.uint8),
                           row_gather_reference(table, ids).view(torch.uint8))
        ok &= same
        line = (f"gather V{v} D{d} J{j} {dtype}: bit-equal {same}; kernel "
                f"{ms(lambda: row_gather(table, ids), 20):.4f} ms, index_select "
                f"{ms(lambda: torch.index_select(table, 0, ids), 20):.4f} ms back to back")
        if j == 9856:
            def gather():
                return row_gather(table, ids)

            def index_select():
                return torch.index_select(table, 0, ids)

            line += (f"; device ms: kernel {chip_smoke.device_ms(torch, gather):.4f}, "
                     f"index_select {chip_smoke.device_ms(torch, index_select):.4f}"
                     f"; host us a call: wrapper {chip_smoke.host_us(torch, gather):.2f}, "
                     f"index_select {chip_smoke.host_us(torch, index_select):.2f}"
                     f"; bound {chip_smoke.gather_bound(j, 2 * d)[0]:.4f} ms")
        print(line, flush=True)
    return ok


def check_chain(g):
    """The chained fused MLP (with and without the out-projection) against
    its plain version, bf16, 2.5e-2 relative."""
    ok = True
    for m, d, h in ((16448, 1024, 4096), (1001, 1024, 4096), (1, 1024, 128),
                    (77, 256, 1024), (300, 128, 512), (129, 192, 320)):
        def r(*shape, std=1.0, dtype=torch.bfloat16):
            return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

        f32 = torch.float32
        mlp = (1 + r(d, std=0.1, dtype=f32), r(d, std=0.1, dtype=f32),
               r(d, h, std=d ** -0.5), r(h, std=0.1, dtype=f32),
               r(h, d, std=h ** -0.5), r(d, std=0.1, dtype=f32))
        x = r(m, d, std=0.5)
        proj = (r(m, d, std=0.5), r(d, d, std=d ** -0.5), r(d, std=0.1, dtype=f32))
        for act in ("gelu_tanh", "gelu"):
            got = fused_mlp_chunked(x, *mlp, act=act)
            got_o = fused_attnout_mlp(x, *proj, *mlp, act=act)
            torch.cuda.synchronize()
            e = rel_err(got, fused_mlp_chain_reference(x, *mlp, act=act))
            e_o = rel_err(got_o, fused_mlp_chain_reference(x, *mlp, act=act,
                                                           outproj=proj))
            ok &= (bool(torch.isfinite(got).all() and torch.isfinite(got_o).all())
                   and e <= 2.5e-2 and e_o <= 2.5e-2)
            print(f"chain M{m} D{d} H{h} {act}: chunked {e:.2e}, attn-out "
                  f"{e_o:.2e}; chunked "
                  f"{ms(lambda: fused_mlp_chunked(x, *mlp, act=act)):.4f} ms, "
                  f"attn-out {ms(lambda: fused_attnout_mlp(x, *proj, *mlp, act=act)):.4f}"
                  f" ms, three-launch fused_mlp "
                  + (f"{ms(lambda: fused_mlp(x, *mlp, act='gelu')):.4f} ms"
                     if d % 64 == 0 else "n/a"), flush=True)
    return ok


def main() -> int:
    which = set(sys.argv[1:]) or {"fps", "encoder", "mlp", "attn", "attn_hd",
                                  "ln_proj", "int8", "quantize", "gather", "chain"}
    nvcc = _build.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:  # one nvcc a source, in parallel
        srcs = sorted(_build.CSRC.glob("*.cu"))
        procs = [subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
             "-o", os.path.join(tmp, src.stem + ".o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in srcs]
        for src, proc in zip(srcs, procs):
            out = proc.communicate()[0]
            lines = [ln.strip() for ln in out.splitlines()
                     if any(w in ln for w in ("registers", "spill", "error", "warning",
                                             "entry function"))]
            print(src.name, proc.returncode, lines, flush=True)
    t0 = time.time()
    _build.library()
    print(f"build {time.time() - t0:.1f} s", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    if "mlp" in which:
        ok &= check_mlp(g)
    if "attn" in which:
        ok &= check_attn(g)
    if "attn_hd" in which:
        ok &= check_attn_hd(g)
    if "ln_proj" in which:
        ok &= check_ln_proj(g)
    if "int8" in which:
        ok &= check_int8(g)
    if "quantize" in which:
        ok &= check_quantize(g)
    if "gather" in which:
        ok &= check_gather(g)
    if "chain" in which:
        ok &= check_chain(g)
    for b, n, npoint, cloud, starts in FPS_CASES if "fps" in which else ():
        xyz, start = chip_smoke.fps_inputs(torch, g, b, n, cloud, starts)
        got = fps_indices(xyz, npoint, start)
        torch.cuda.synchronize()
        n_diff = (got != fps_indices_reference(xyz, npoint, start)).sum().item()
        ok &= n_diff == 0
        print(f"fps B{b} N{n} npoint{npoint} {cloud} {starts} starts (C = "
              f"{cluster_size(b, torch.cuda.get_device_properties(0).multi_processor_count, n)}"
              f"): {n_diff} indices differ; kernel "
              f"{ms(lambda: fps_indices(xyz, npoint, start)):.4f} ms, plain "
              f"{ms(lambda: fps_indices_reference(xyz, npoint, start), 2):.4f} ms",
              flush=True)
    for shape, widths in ENC_CASES if "encoder" in which else ():
        args = encoder_inputs(g, shape, widths)
        got = fused_point_encoder(*args)
        torch.cuda.synchronize()
        want = point_encoder_reference(*args)
        err = ((got.float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        ok &= bool(torch.isfinite(got).all()) and err <= 2e-2
        print(f"encoder {shape} widths {widths}: rel err {err:.2e}, "
              f"{(got != want).float().mean().item():.2e} of outputs differ; "
              f"kernel {ms(lambda: fused_point_encoder(*args)):.4f} ms, plain "
              f"{ms(lambda: point_encoder_reference(*args), 3):.4f} ms", flush=True)
    print("ok" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
