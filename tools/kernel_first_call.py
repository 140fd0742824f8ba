#!/usr/bin/env python3
"""First call of new kernels on the card: compile every csrc/*.cu with
``-Xptxas -v`` (registers, shared memory, spills), then hold the FPS and
point-encoder kernels against their plain versions at the point-cloud path's
shapes and at edge shapes (ragged N, partial group tiles, other group sizes
and widths), with one timing each.

    python3 tools/kernel_first_call.py

Needs one CUDA device and nvcc. Exits non-zero if a kernel disagrees.
"""

import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from vitlens_tpu_torch.ops import _build  # noqa: E402
from vitlens_tpu_torch.ops.fps import fps_indices, fps_indices_reference  # noqa: E402
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


def main() -> int:
    nvcc = _build.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        for src in sorted(_build.CSRC.glob("*.cu")):
            out = subprocess.run(
                [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                 "-o", os.path.join(tmp, src.stem + ".o")],
                capture_output=True, text=True)
            lines = [ln.strip() for ln in (out.stdout + out.stderr).splitlines()
                     if "registers" in ln or "spill" in ln or "error" in ln]
            print(src.name, out.returncode, lines, flush=True)
    t0 = time.time()
    _build.library()
    print(f"build {time.time() - t0:.1f} s", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for b, n, npoint, random_start in ((64, 8192, 512, False), (8, 10000, 512, True),
                                       (3, 100, 64, True), (2, 16384, 512, False)):
        xyz = torch.randn(b, n, 3, generator=g, device="cuda") * 0.3
        start = (torch.randint(0, n, (b,), generator=g, device="cuda", dtype=torch.int32)
                 if random_start else torch.zeros(b, dtype=torch.int32, device="cuda"))
        got = fps_indices(xyz, npoint, start)
        torch.cuda.synchronize()
        n_diff = (got != fps_indices_reference(xyz, npoint, start)).sum().item()
        ok &= n_diff == 0
        print(f"fps B{b} N{n} npoint{npoint}: {n_diff} indices differ; kernel "
              f"{ms(lambda: fps_indices(xyz, npoint, start)):.4f} ms, plain "
              f"{ms(lambda: fps_indices_reference(xyz, npoint, start), 2):.4f} ms",
              flush=True)
    for shape, widths in ((((64, 512, 32)), (128, 256, 512, 256)),
                          ((1, 25, 16), (128, 256, 512, 256)),
                          ((3, 7, 64), (128, 256, 512, 256)),
                          ((2, 9, 32), (64, 192, 320, 192))):
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
