"""Is the hand-written int8 product exact, and how fast (counterpart of
scripts/bench_int8_native.py)?

    python -m vitlens_tpu_torch.scripts.bench_int8_native [--device cpu]

1. Exactness: int8 x int8 -> int32 on random +-127 inputs has one right
   answer; the kernel and its plain version are held to numpy's int64
   product on a [512, 1024] x [1024, 512] case.
2. Speed at 4096^3: the kernel in TOP/s beside the library's int8 product
   (``torch._int_mm``) and the library's bf16 product in TFLOP/s. The kernel
   reads B transposed; that copy is made once, outside the timed loop, as a
   quantized module makes it once when it is quantized.
Prints one JSON line per row.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from vitlens_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_reference
from vitlens_tpu_torch.scripts import _common as C

SIZE, ITERS = 4096, 50


def main(argv=None) -> int:
    p = C.parser(__doc__.splitlines()[0], ITERS)
    p.add_argument("--size", type=int, default=SIZE, help="M = K = N")
    args = p.parse_args(argv)
    dev = C.device_of(args)
    rng = np.random.RandomState(args.seed)
    base = {"device": C.device_name(dev)}

    sa = rng.randint(-127, 128, (512, 1024)).astype(np.int8)
    sb = rng.randint(-127, 128, (1024, 512)).astype(np.int8)
    want = sa.astype(np.int64) @ sb.astype(np.int64)
    ta, tb = torch.from_numpy(sa).to(dev), torch.from_numpy(sb).to(dev)
    bad = {"kernel": int8_matmul(ta, tb), "plain": int8_matmul_reference(ta, tb)}
    bad = {k: int((v.cpu().numpy().astype(np.int64) != want).sum())
           for k, v in bad.items()}
    C.emit({**base, "name": "exactness_512x1024x512", "wrong_elements": bad,
            "of": want.size})

    n = args.size
    a = torch.from_numpy(rng.randint(-127, 128, (n, n)).astype(np.int8)).to(dev)
    b = torch.from_numpy(rng.randint(-127, 128, (n, n)).astype(np.int8)).to(dev)
    b_t = b.t().contiguous()  # once, outside the timed loop
    ops = 2.0 * n ** 3
    rows = {"kernel_int8": lambda: int8_matmul(a, b, b_t)}
    if dev.type == "cuda":
        rows["library_int8(torch._int_mm)"] = lambda: torch._int_mm(a, b)
    abf, bbf = a.bfloat16(), b.bfloat16()
    rows["library_bf16(torch.matmul)"] = lambda: abf @ bbf
    for name, fn in rows.items():
        ms = C.time_ms(fn, args.iters, dev)
        C.emit({**base, "name": name, "shape": [n, n, n], **C.timing(ms, dev, tera_ops_per_s=ops / ms / 1e9)})
    exact = not any(bad.values())
    C.emit({**base, "exact": exact})
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
