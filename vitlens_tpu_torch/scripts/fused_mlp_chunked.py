"""The resblock MLP as the chained-MLP prototype computes it (counterpart of
scripts/fused_mlp_pallas.py; on the card, kernel 1's launches with its tanh GELU).

    python -m vitlens_tpu_torch.scripts.fused_mlp_chunked [--device cpu]

At the ViT-L shape of the prototype (M = 64 * 257 rows, D = 1024, H = 4096):
the chained kernels against their plain version with the tanh GELU the prototype
computes and with the exact GELU of the resblock, then its time beside the
three-launch fused MLP kernel (``ops.fused_mlp``, the same function with the
exact GELU) and the plain PyTorch MLP. Prints one JSON line per row and a
verdict line. The prototype's tile sweep is not carried over.
"""

from __future__ import annotations

import sys

import numpy as np

from vitlens_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_reference
from vitlens_tpu_torch.ops.fused_mlp_chain import (fused_mlp_chain_reference,
                                                   fused_mlp_chunked)
from vitlens_tpu_torch.scripts import _common as C

D, HIDDEN, M, ITERS = 1024, 4096, 64 * 257, 30
TOL = 2e-2  # the prototype's own bound, relative to max|want|, bf16


def main(argv=None) -> int:
    p = C.parser(__doc__.splitlines()[0], ITERS)
    p.add_argument("--rows", type=int, default=M)
    p.add_argument("--dim", type=int, default=D)
    p.add_argument("--hidden", type=int, default=HIDDEN)
    args = p.parse_args(argv)
    dev = C.device_of(args)
    m, d, hidden = args.rows, args.dim, args.hidden
    a = C.mlp_inputs(np.random.RandomState(args.seed), m, d, hidden, dev)
    flops = 4 * m * d * hidden
    base = {"device": C.device_name(dev), "shape": [m, d, hidden]}

    errs = {"gelu_tanh": C.rel_err(
                fused_mlp_chunked(*a, act="gelu_tanh"),
                fused_mlp_chain_reference(*a, act="gelu_tanh")),
            "gelu": C.rel_err(fused_mlp_chunked(*a, act="gelu"),
                              fused_mlp_reference(*a, act="gelu"))}
    rows = {"chunked_gelu_tanh": lambda: fused_mlp_chunked(*a, act="gelu_tanh"),
            "chunked_gelu": lambda: fused_mlp_chunked(*a, act="gelu"),
            "three_launch_fused_mlp": lambda: fused_mlp(*a, act="gelu"),
            "plain_mlp": lambda: fused_mlp_reference(*a, act="gelu")}
    ms = {}
    ok = True
    for name, fn in rows.items():
        err = errs.get(name.replace("chunked_", ""))
        if err is not None and not err <= TOL:
            C.emit({**base, "name": name, "error": f"numerics {err:.3e}"})
            ok = False
            continue
        ms[name] = C.time_ms(fn, args.iters, dev)
        C.emit({**base, "name": name, **C.timing(ms[name], dev, tflops=flops / ms[name] / 1e9),
                **({"max_rel_err": err} if err is not None else {})})
    best = min(ms, key=ms.get)
    C.emit({**base, "verdict": best,
            "speedup_vs_plain": ms["plain_mlp"] / ms[best],
            "chunked_vs_three_launch": (ms["three_launch_fused_mlp"]
                                        / ms["chunked_gelu"]
                                        if "chunked_gelu" in ms else None)})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
