#!/usr/bin/env python3
"""Times variants of the point-encoder kernel against the committed source,
in one process on one card, at the point-cloud path's B64 shape
([64, 512, 32, 3] -> [64, 512, 256]).

    python3 tools/kernel_variants.py            # the variants in VARIANTS
    python3 tools/kernel_variants.py '{"bk64": {"constexpr int BK = 32;": "constexpr int BK = 64;"}}'

Each variant is a copy of csrc/fused_point_encoder.cu with regex
substitutions applied (a variant may remove a stage to measure its cost, in
which case its output is wrong and its error says so); all are compiled in
parallel into libraries under a temporary directory and timed in turns, twice.
Prints each variant's registers and spills, time and relative error against
the plain version; a variant that fails to launch is reported and skipped.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from vitlens_tpu_torch.ops import _build  # noqa: E402
from vitlens_tpu_torch.ops.fused_point_encoder import (  # noqa: E402
    _bn_fold, point_encoder_reference)

WIDTHS = (128, 256, 512, 256)

# Tile shapes around the committed one, and the committed kernel with its
# tensor-core products replaced by a register op (its output is wrong; its
# time is that of everything but the mma.sync instructions).
VARIANTS = {
    "bk64": {"constexpr int BK = 32;": "constexpr int BK = 64;"},
    "nc256_s2": {"constexpr int NC = 128;": "constexpr int NC = 256;",
                 "constexpr int STAGES = 3;": "constexpr int STAGES = 2;"},
    "no_mma": {r"mma_bf16\(acc\[i\]\[j\], af\[i\], bfr\[j\]\[0\], bfr\[j\]\[1\]\);":
               "acc[i][j][0] += __uint_as_float(af[i][0] ^ bfr[j][0]);"},
}


def build_variants(variants, tmp):
    nvcc = _build.find_nvcc()
    src = (_build.CSRC / "fused_point_encoder.cu").read_text()
    procs = {}
    for name, subs in [("committed", {}), *variants.items()]:
        text = src
        for pattern, repl in subs.items():
            text, n = re.subn(pattern, repl, text)
            if not n:
                raise SystemExit(f"{name}: pattern {pattern!r} not found")
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
             os.path.join(tmp, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, p in procs.items():
        out = p.communicate()[0]
        print(name, p.returncode, [ln.strip() for ln in out.splitlines()
                                   if "registers" in ln or "spill" in ln
                                   or "error" in ln][:4], flush=True)
        if p.returncode == 0:
            fn = ctypes.CDLL(os.path.join(tmp, f"lib{name}.so")).vitlens_point_encoder_fwd
            fn.argtypes = _build._SIGNATURES["vitlens_point_encoder_fwd"]
            fn.restype = ctypes.c_int
            fns[name] = fn
    return fns


def main() -> int:
    variants = json.loads(sys.argv[1]) if len(sys.argv) > 1 else VARIANTS
    g = torch.Generator(device="cuda").manual_seed(0)

    def r(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    def bn(n):
        return r(n, std=0.2), 0.5 + r(n).abs(), 1 + r(n, std=0.2), r(n, std=0.1)

    c1, c2, c3, c4 = WIDTHS
    w = (r(3, c1, std=0.5).bfloat16(), r(c1, std=0.1), bn(c1),
         r(c1, c2, std=c1 ** -0.5).bfloat16(), r(c2, std=0.1),
         r(2 * c2, c3, std=(2 * c2) ** -0.5).bfloat16(), r(c3, std=0.1), bn(c3),
         r(c3, c4, std=c3 ** -0.5).bfloat16(), r(c4, std=0.1))
    nb = r(64, 512, 32, 3, std=0.1).bfloat16()
    want = point_encoder_reference(nb, *w)
    m1, i1, s1 = _bn_fold(w[2], 1e-5)
    m2, i2, s2 = _bn_fold(w[7], 1e-5)
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, out):
        err = fn(nb.data_ptr(), w[0].data_ptr(), w[1].data_ptr(), m1.data_ptr(),
                 i1.data_ptr(), s1.data_ptr(), w[3].data_ptr(), w[4].data_ptr(),
                 w[5].data_ptr(), w[6].data_ptr(), m2.data_ptr(), i2.data_ptr(),
                 s2.data_ptr(), w[8].data_ptr(), w[9].data_ptr(), out.data_ptr(),
                 64 * 512, 32, c1, c2, c3, c4, stream)
        _build.check(err, "variant")

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

    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(variants, tmp)
        best = {}
        for rep in range(2):
            for name, fn in list(fns.items()):
                out = torch.empty(64, 512, c4, dtype=torch.bfloat16, device="cuda")
                try:
                    call(fn, out)
                except RuntimeError as e:
                    print(f"{name}: does not launch ({e})", flush=True)
                    del fns[name]
                    continue
                torch.cuda.synchronize()
                err = ((out.float() - want.float()).abs().max()
                       / want.float().abs().max()).item()
                t = ms(lambda: call(fn, out))
                best[name] = min(best.get(name, t), t)
                print(f"pass {rep} {name}: {t:.4f} ms, rel err {err:.2e}", flush=True)
    print({k: round(v, 4) for k, v in best.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
