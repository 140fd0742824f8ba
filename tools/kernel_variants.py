#!/usr/bin/env python3
"""Times variants of a kernel against the committed source, in one process on
one card, at its main path's shapes.

    python3 tools/kernel_variants.py fps         # FPS at B = 1 and B64 (N 8192, npoint 512), every cluster size C, its exchanges and floor
    python3 tools/kernel_variants.py encoder     # the point encoder, [64, 512, 32, 3] and M = 48
    python3 tools/kernel_variants.py lnproj      # the fused LN + projection beside its in-place design (tools/ln_proj_variants/)
    python3 tools/kernel_variants.py lnproj '{"inplace_no_norm": {"@source": "tools/ln_proj_variants/fused_ln_proj_inplace.cu", "ln_normalise\\(smem \\+ s \\* STAGE_BYTES[^;]*;": ";"}}'
    python3 tools/kernel_variants.py attn        # attention, its main shapes and bigG's D = 104
    python3 tools/kernel_variants.py mlp         # the fused MLP, M = 49344 and 16448
    python3 tools/kernel_variants.py int8        # the int8 DEQUANT product, fc and proj
    python3 tools/kernel_variants.py int8 '{"pingpong": {"@source": "tools/int8_variants/int8_pingpong.cu"}}'
    python3 tools/kernel_variants.py quantize    # the quantise kernel, K = 1024 and 4096
    python3 tools/kernel_variants.py gather '{"old": {"@source": "path/to/row_gather.cu"}}'
    python3 tools/kernel_variants.py attn '{"cw8": {"return w9 < w8 \\? 9 : 8;": "return 8;"}}'
    python3 tools/kernel_variants.py attn '{"mma_sync": {"@source": "tools/attention_variants/flash_attention_both.cu", "constexpr bool USE_WGMMA = true;": "constexpr bool USE_WGMMA = false;"}}'

Each variant is a copy of the kernel's source (or of the file named by its
"@source" key) and of the headers under csrc/ with regex substitutions applied
to all of them (a variant may remove a stage
to measure its cost, in which case its output is wrong and its error says
so); all are compiled in parallel into libraries under a temporary directory
and timed in turns, twice. Prints each variant's registers and spills, time
(back to back through ctypes, and the profiler's device time) and relative
error against the plain version; a variant that fails to build
or launch is reported and skipped.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPO = __import__("pathlib").Path(__file__).resolve().parents[1]

import torch  # noqa: E402

import chip_smoke  # noqa: E402

from vitlens_tpu_torch.ops import _build  # noqa: E402
from vitlens_tpu_torch.ops.flash_attention import (  # noqa: E402
    _strides, attention_reference)
from vitlens_tpu_torch.ops.fused_mlp import fused_mlp_reference  # noqa: E402
from vitlens_tpu_torch.ops.fused_point_encoder import (  # noqa: E402
    _bn_fold, point_encoder_reference)

WIDTHS = (128, 256, 512, 256)

# The point encoder's knobs (csrc/fused_point_encoder.cu): the g-product on
# CUDA cores instead of a padded m64 wgmma (the W3[:C2] tiles then leave the
# ring, and the kernel reads W3 through L1), the ring's depth and the
# consumers' register share; then the committed kernel with its products
# cut out (its output is wrong; its time is that of everything but the wgmma
# instructions), also without its weight loads, or with half the weight
# bytes. Rows a tile (128) and clusters (none) are fixed in this design.
_ENC_G_CORES = r"""
    for (int col = 2 * t2; col < C3; col += 2 * 128 * CONSUMERS) {
      float acc[MAX_GROUPS][2] = {};
      for (int k = 0; k < C2; ++k) {
        const float2 w = __bfloat1622float2(
            *reinterpret_cast<const bf162*>(a.w3 + k * C3 + col));
#pragma unroll
        for (int t = 0; t < MAX_GROUPS; ++t)
          if (t < ng) {
            const float gv =
                __bfloat162float(*reinterpret_cast<const bf16*>(R + swz(t, k, G_ATOM)));
            acc[t][0] = fmaf(gv, w.x, acc[t][0]);
            acc[t][1] = fmaf(gv, w.y, acc[t][1]);
          }
      }
#pragma unroll
      for (int t = 0; t < MAX_GROUPS; ++t)
        if (t < ng) {
          GT[t * C3 + col] = acc[t][0];
          GT[t * C3 + col + 1] = acc[t][1];
        }
    }"""
_ENC_NO_MMA = {r"wgmma_m64n128k16\(d, da[^;]*;": "(void)da;",
               r"wgmma_m64n128k16_first\(d, da, db\);": "(void)db;",
               r"wgmma_m64n64k16(_first)?\(a3, da, db\);": "(void)db;"}
ENCODER_VARIANTS = {
    "g_cores": {
        r"for \(int kt = 0; kt < C2 / 64; \+\+kt\)\s*for \(int q = 0; q < NB3; \+\+q\)"
        r"[^\n]*\n\s*load\(&map_w3, [^;]*;": "",
        r"(?s)(// 3\. gterm = g @ W3\[:C2\] -> GT \[groups, C3\] fp32\n).*?"
        r"(\n\s*named_sync\(1, 128 \* CONSUMERS\);  // GT complete)":
        r"\1" + _ENC_G_CORES + r"\2",
        r"  bf16\* out;\n  int BG, M, C4;": "  bf16* out;\n  const bf16* w3;\n  int BG, M, C4;",
        r"static_cast<bf16\*>\(out\), BG, M, c4\}":
        "static_cast<bf16*>(out), static_cast<const bf16*>(w3), BG, M, c4}"},
    "nst4": {"constexpr int NST = 5;": "constexpr int NST = 4;"},
    "reg232": {r"setmaxnreg\.inc\.sync\.aligned\.u32 240": "setmaxnreg.inc.sync.aligned.u32 232",
               r"setmaxnreg\.dec\.sync\.aligned\.u32 24": "setmaxnreg.dec.sync.aligned.u32 40"},
    "no_mma": _ENC_NO_MMA,
    "no_mma_no_load": {**_ENC_NO_MMA, r"tma_load_2d\(st(, | \+ BOX_BYTES)[^;]*;": ";",
                       r"it\+\+, STAGE,": "it++, 0,"},
    "half_load": {r"it\+\+, STAGE,(\s*\[&\]\(unsigned char\* st, uint64_t\* bar\) \{"
                  r"\s*tma_load_2d\(st, map, bar, ncol, krow\);)"
                  r"\s*tma_load_2d\(st \+ BOX_BYTES, map, bar,\s*ncol \+ 64, krow\);":
                  r"it++, BOX_BYTES,\1"},
}


def build_variants(source, entry, variants, tmp):
    nvcc = _build.find_nvcc()
    base = {p.name: p.read_text() for p in _build.CSRC.glob("*.cuh")}
    base[source] = (_build.CSRC / source).read_text()
    procs = {}
    for name, subs in [("committed", {}), *variants.items()]:
        vdir = os.path.join(tmp, name)
        os.makedirs(vdir)
        subs = dict(subs)
        files = dict(base)
        if "@source" in subs:  # a whole other source file, from the repo root
            files[source] = (REPO / subs.pop("@source")).read_text()
        hits = dict.fromkeys(subs, 0)
        for fname, text in files.items():
            for pattern, repl in subs.items():
                text, n = re.subn(pattern, repl, text)
                hits[pattern] += n
            with open(os.path.join(vdir, fname), "w") as f:
                f.write(text)
        missing = [pat for pat, n in hits.items() if not n]
        if missing:
            raise SystemExit(f"{name}: pattern(s) {missing!r} not found")
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
             os.path.join(vdir, "lib.so"), os.path.join(vdir, source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, p in procs.items():
        out = p.communicate()[0]
        print(name, p.returncode, [ln.strip() for ln in out.splitlines()
                                   if "registers" in ln or "spill" in ln
                                   or "error" in ln or "C75" in ln][:6], flush=True)
        if p.returncode == 0:
            fn = getattr(ctypes.CDLL(os.path.join(tmp, name, "lib.so")), entry)
            fn.argtypes = _build._SIGNATURES[entry]
            fn.restype = ctypes.c_int
            fns[name] = fn
    return fns


def ms(fn, iters=20):
    for _ in range(3):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def encoder_cases(g):
    """(label, call(fn), want, out) at the point-cloud path's B64 shape."""
    def r(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    def bn(n):
        return r(n, std=0.2), 0.5 + r(n).abs(), 1 + r(n, std=0.2), r(n, std=0.1)

    c1, c2, c3, c4 = WIDTHS
    w = (r(3, c1, std=0.5).bfloat16(), r(c1, std=0.1), bn(c1),
         r(c1, c2, std=c1 ** -0.5).bfloat16(), r(c2, std=0.1),
         r(2 * c2, c3, std=(2 * c2) ** -0.5).bfloat16(), r(c3, std=0.1), bn(c3),
         r(c3, c4, std=c3 ** -0.5).bfloat16(), r(c4, std=0.1))
    m1, i1, s1 = _bn_fold(w[2], 1e-5)
    m2, i2, s2 = _bn_fold(w[7], 1e-5)
    cases = []
    for m in (32, 48):
        nb = r(64, 512, m, 3, std=0.1).bfloat16()
        out = torch.empty(64, 512, c4, dtype=torch.bfloat16, device="cuda")

        def call(fn, nb=nb, out=out, m=m):
            return fn(nb.data_ptr(), w[0].data_ptr(), w[1].data_ptr(), m1.data_ptr(),
                      i1.data_ptr(), s1.data_ptr(), w[3].data_ptr(), w[4].data_ptr(),
                      w[5].data_ptr(), w[6].data_ptr(), m2.data_ptr(), i2.data_ptr(),
                      s2.data_ptr(), w[8].data_ptr(), w[9].data_ptr(), out.data_ptr(),
                      64 * 512, m, c1, c2, c3, c4, _stream())

        cases.append((f"[64,512,{m},3]", call, point_encoder_reference(nb, *w), out))
    return cases


# The in-place design (A normalised in shared memory inside the GEMM, its
# source under tools/ln_proj_variants/), against which the committed
# two-launch kernel was chosen.
LNPROJ_VARIANTS = {
    "inplace": {"@source": "tools/ln_proj_variants/fused_ln_proj_inplace.cu"}}


def lnproj_cases(g):
    """The trunk's qkv shapes: M = 49344 (B64 x 3 clips) and 16448 (B64),
    D 1024, N 3072."""
    from vitlens_tpu_torch.ops.fused_ln_proj import ln_proj_reference

    cases = []
    for m in (49344, 16448):
        d, n = 1024, 3072
        x, lnw, lnb, w, b = chip_smoke.ln_proj_inputs(torch, g, m, d, n)
        y = torch.empty(m, d, dtype=torch.bfloat16, device="cuda")
        out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")

        def call(fn, x=x, lnw=lnw, lnb=lnb, w=w, b=b, y=y, out=out, m=m):
            return fn(x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), w.data_ptr(),
                      b.data_ptr(), y.data_ptr(), out.data_ptr(), m, d, n, 1e-5,
                      _stream())

        cases.append((f"M={m} D={d} N={n}", call,
                      ln_proj_reference(x, lnw, lnb, w, b), out))
    return cases


ATTN_SHAPES = (("trunk", 192, 16, 257, 257, 64), ("lens cross", 192, 1, 256, 600, 64),
               ("lens self", 192, 16, 256, 256, 64), ("pc lens cross", 64, 1, 256, 512, 64),
               ("trunk packed-qkv views", 192, 16, 257, 257, 64),
               ("bigG trunk", 192, 16, 257, 257, 104))

# Attention with its P V products run over every 16-key step of a chunk
# (the keys past NK hold P = 0 and zero-filled V).
ATTN_VARIANTS = {"pv_all": {r"if \(kt \* 16 < valid\)\s*\n\s*": ""}}


def attn_cases(g):
    cases = []
    for label, b, h, nq, nk, d in ATTN_SHAPES:
        if "views" in label:
            qkv = torch.randn(b, nq, 3 * h * d, generator=g, device="cuda").bfloat16()
            q, k, v = qkv.view(b, nq, 3, h, d).permute(2, 0, 3, 1, 4)
        else:
            q, k, v = (torch.randn(b, h, n, d, generator=g, device="cuda").bfloat16()
                       for n in (nq, nk, nk))
        out = torch.empty(b, nq, h, d, dtype=torch.bfloat16, device="cuda")

        def call(fn, q=q, k=k, v=v, out=out, b=b, h=h, nq=nq, nk=nk, d=d):
            return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                      h, nq, nk, d, *_strides(q), *_strides(k), *_strides(v),
                      d ** -0.5, _stream())

        cases.append((f"{label} [{b},{h},{nq},{nk}]", call,
                      attention_reference(q, k, v).transpose(1, 2), out))
    return cases


def mlp_cases(g):
    cases = []
    for m in (257 * 64 * 3, 257 * 64):
        d, h = 1024, 4096

        def r(*shape, std=1.0, dtype=torch.bfloat16):
            return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

        f32 = torch.float32
        args = (r(m, d, std=0.5), 1 + r(d, std=0.1, dtype=f32),
                r(d, std=0.1, dtype=f32), r(d, h, std=d ** -0.5),
                r(h, std=0.1, dtype=f32), r(h, d, std=h ** -0.5),
                r(d, std=0.1, dtype=f32))
        y = torch.empty(m, d, dtype=torch.bfloat16, device="cuda")
        hid = torch.empty(m, h, dtype=torch.bfloat16, device="cuda")
        out = torch.empty(m, d, dtype=torch.bfloat16, device="cuda")

        def call(fn, args=args, y=y, hid=hid, out=out, m=m):
            return fn(*(t.data_ptr() for t in args), y.data_ptr(), hid.data_ptr(),
                      out.data_ptr(), m, 1024, 4096, 0, 1e-5, _stream())

        cases.append((f"M={m} D=1024 H=4096", call, fused_mlp_reference(*args), out))
    return cases


# The int8 product with its epilogue or its products cut out (the output is
# wrong; the time is that of the rest); then, with the products cut out, the
# epilogue without each of its parts: the TMA store, the wait for the
# staging buffer, the writes into it, the column scale and bias reads.
_NO_MMA = {r"wgmma_m64n256k32_s8\(d, da[^;]*;": "(void)da; (void)db;"}
INT8_VARIANTS = {
    "no_epilogue": {r"pass < BN / PASS_COLS; \+\+pass": "pass < 0; ++pass"},
    "no_mma": _NO_MMA,
    "epi_no_store": {**_NO_MMA, r"tma_store_2d\(&map_c, out[^;]*;": ";"},
    "epi_no_wait": {**_NO_MMA, r"if \(tid == 0\) bulk_wait_read\(\);": ";"},
    "epi_no_put": {**_NO_MMA, r"put2\(dst, from_float[^;]*;": "(void)dst;"},
    "epi_no_wsb": {**_NO_MMA,
                   r"w = \*reinterpret_cast<const float2\*>\(wsb \+ 8[^;]*;":
                   "w = make_float2(1.f, 1.f);",
                   r"bias = \*reinterpret_cast<const float2\*>\(wsb[^;]*;": ";"},
}


def int8_cases(g):
    from vitlens_tpu_torch.ops.int8_matmul import (dequant_reference,
                                                   int8_matmul_reference)

    cases = []
    for label, m, k, n in (("fc", 49344, 1024, 4096), ("proj", 49344, 4096, 1024)):
        a = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=g, device="cuda", dtype=torch.int8)
        bt = b.t().contiguous()
        xs = torch.rand(m, 1, generator=g, device="cuda") * 0.02 + 1e-4
        ws = torch.rand(1, n, generator=g, device="cuda") * 0.01 + 1e-5
        bias = torch.randn(n, generator=g, device="cuda")
        out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")

        def call(fn, a=a, bt=bt, xs=xs, ws=ws, bias=bias, out=out, m=m, k=k, n=n):
            return fn(a.data_ptr(), bt.data_ptr(), xs.data_ptr(), ws.data_ptr(),
                      bias.data_ptr(), out.data_ptr(), m, n, k, 1, _stream())

        want = dequant_reference(int8_matmul_reference(a, b), xs, ws, bias,
                                 torch.bfloat16)
        cases.append((f"DEQUANT {label} M={m} K={k} N={n}", call, want, out))
    return cases


# The quantise kernel's row loops unrolled, to keep more loads in flight a
# lane.
QUANT_VARIANTS = {
    f"unroll{u}": {r"(\n\s*)for \(int c = lane \* V; c < K; c \+= 32 \* V\)":
                   f"\\1#pragma unroll {u}\\1for (int c = lane * V; c < K; c += 32 * V)"}
    for u in (2, 4)}


def quantize_cases(g):
    """The quantized encode's activations: [49344, 1024] and [49344, 4096]
    bf16 rows (the int8 rows are held to the plain version's)."""
    from vitlens_tpu_torch.ops.int8_matmul import int8_quantize_reference

    cases = []
    for k in (1024, 4096):
        x = chip_smoke.quant_rows(torch, g, 49344, k, torch.bfloat16)
        xi = torch.empty(49344, k, dtype=torch.int8, device="cuda")
        xs = torch.empty(49344, 1, device="cuda")

        def call(fn, x=x, xi=xi, xs=xs, k=k):
            return fn(x.data_ptr(), xi.data_ptr(), xs.data_ptr(), 49344, k, 1,
                      _stream())

        cases.append((f"[49344,{k}] bf16", call, int8_quantize_reference(x)[0], xi))
    return cases


def gather_cases(g):
    """The bench's row gather: 9856 ids into the [49408, 512] bf16 table."""
    table = torch.randn(49408, 512, generator=g, device="cuda").bfloat16()
    ids = torch.randint(0, 49408, (9856,), generator=g, device="cuda",
                        dtype=torch.int32)
    out = torch.empty(9856, 512, dtype=torch.bfloat16, device="cuda")

    def call(fn):
        return fn(table.data_ptr(), ids.data_ptr(), out.data_ptr(), 9856, 49408,
                  1024, _stream())

    return [("[49408,512] bf16, 9856 ids", call, table[ids.long()], out)]


# FPS: the two other exchanges, plain stores
# (st.shared::cluster) in place of st.async followed by a cluster barrier
# ("cluster_barrier") or each by a remote mbarrier arrive, release at cluster
# scope ("remote_arrive"); a CTA of 512 threads instead of 256; 16 register
# points a thread at most instead of 32 (the B = 133 row then puts half of
# each partition in shared memory); and each exchange with the distance
# update cut out: the chain of 511 row-wide argmaxes alone, the kernel's
# dependency floor (the indices are then wrong).
_FPS_PLAIN_STORES = {
    r"st\.async\.shared::cluster\.mbarrier::complete_tx::bytes\.v4\.b32 "
    r"(\[%0(?:\+16)?\]), (\{[^}]*\}), \[%1\];": r"st.shared::cluster.v4.b32 \1, \2;",
    r"if \(tid == 0\) arm_tx\([^;]*;": ""}
_FPS_EXCHANGES = {
    "st_async": {},
    "cluster_barrier": {**_FPS_PLAIN_STORES,
                        r"mbar_wait\(&bar\[p\], \(s >> 1\) & 1\);": "cluster_sync();"},
    "remote_arrive": {**_FPS_PLAIN_STORES,
                      r'(st\.shared::cluster\.v4\.b32 \[%0\+16\], [^"]*")':
                      r'\1\n      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%1];\\n"',
                      r"const int arrivals = 1;": "const int arrivals = slots;"}}
_FPS_NO_UPDATE = {r"\n\s*lower\(\);": "\n"}
FPS_VARIANTS = {"cluster_barrier": _FPS_EXCHANGES["cluster_barrier"],
                "remote_arrive": _FPS_EXCHANGES["remote_arrive"],
                "threads512": {r"constexpr int THREADS = 256;": "constexpr int THREADS = 512;"},
                "kr16": {r"constexpr int MAX_KR = 32;": "constexpr int MAX_KR = 16;"},
                **{f"{name}_exchange_only": {**subs, **_FPS_NO_UPDATE}
                   for name, subs in _FPS_EXCHANGES.items()}}


def fps_cases(g):
    """B = 1 and B64 rows of 8192 points, 512 samples, at every cluster size
    C the kernel takes (the wrapper picks 16 and 2 on 132 SMs); then B = 133
    at C = 1."""
    from vitlens_tpu_torch.ops.fps import fps_indices_reference

    cases = []
    for b in (1, 64):
        n = 8192
        xyz = torch.randn(b, n, 3, generator=g, device="cuda") * 0.3
        start = torch.zeros(b, dtype=torch.int32, device="cuda")
        want = fps_indices_reference(xyz, 512, start)
        work = torch.empty(b, n, device="cuda")
        for c in (1, 2, 4, 8, 16):
            out = torch.empty(b, 512, dtype=torch.int32, device="cuda")

            def call(fn, xyz=xyz, start=start, work=work, out=out, b=b, c=c):
                return fn(xyz.data_ptr(), start.data_ptr(), out.data_ptr(),
                          work.data_ptr(), b, n, 512, c, _stream())

            cases.append((f"B{b} N{n} C{c}", call, want, out))
    b, n, c = 133, 8192, 1  # past the SMs: one CTA a row, 8192 points each
    xyz = torch.randn(b, n, 3, generator=g, device="cuda") * 0.3
    start = torch.zeros(b, dtype=torch.int32, device="cuda")
    want = fps_indices_reference(xyz, 512, start)
    work = torch.empty(b, n, device="cuda")
    out = torch.empty(b, 512, dtype=torch.int32, device="cuda")

    def call(fn):
        return fn(xyz.data_ptr(), start.data_ptr(), out.data_ptr(), work.data_ptr(),
                  b, n, 512, c, _stream())

    cases.append((f"B{b} N{n} C{c}", call, want, out))
    return cases


def _stream():
    return torch.cuda.current_stream().cuda_stream


KERNELS = {  # source, entry point, cases, default variants
    "fps": ("fps.cu", "vitlens_fps_fwd", fps_cases, FPS_VARIANTS),
    "encoder": ("fused_point_encoder.cu", "vitlens_point_encoder_fwd",
                encoder_cases, ENCODER_VARIANTS),
    "lnproj": ("fused_ln_proj.cu", "vitlens_fused_ln_proj_fwd", lnproj_cases,
               LNPROJ_VARIANTS),
    "attn": ("flash_attention.cu", "vitlens_flash_attention_fwd", attn_cases,
             ATTN_VARIANTS),
    "mlp": ("fused_mlp.cu", "vitlens_fused_mlp_fwd", mlp_cases, {}),
    "int8": ("int8_matmul.cu", "vitlens_int8_matmul_dequant_fwd", int8_cases,
             INT8_VARIANTS),
    "gather": ("row_gather.cu", "vitlens_row_gather_fwd", gather_cases, {}),
    "quantize": ("int8_matmul.cu", "vitlens_int8_quantize_fwd", quantize_cases,
                 QUANT_VARIANTS),
}


def main() -> int:
    source, entry, make_cases, defaults = KERNELS[sys.argv[1]]
    variants = json.loads(sys.argv[2]) if len(sys.argv) > 2 else defaults
    cases = make_cases(torch.Generator(device="cuda").manual_seed(0))
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(source, entry, variants, tmp)
        best = {}
        for rep in range(2):
            for name, fn in list(fns.items()):
                for label, call, want, out in cases:
                    err = call(fn)
                    torch.cuda.synchronize()
                    if err:
                        print(f"{name}: does not launch (CUDA error {err})", flush=True)
                        del fns[name]
                        break
                    e = rel(out, want)
                    t = ms(lambda: call(fn))
                    key = f"{name} {label}"
                    best[key] = min(best.get(key, t), t)
                    print(f"pass {rep} {key}: {t:.4f} ms (device "
                          f"{chip_smoke.device_ms(torch, lambda: call(fn)):.4f} ms), "
                          f"rel err {e:.2e}", flush=True)
    print({k: round(v, 4) for k, v in best.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
