"""The attention out-projection, its residual and the resblock MLP with the
fp32 row kept between them (counterpart of scripts/fused_attnout_mlp_pallas.py).

    python -m vitlens_tpu_torch.scripts.fused_attnout_mlp [--device cpu]

(x, ctx) -> y = x + ctx @ Wo + bo -> y + MLP(LN(y)) at the prototype's shape
(M = 64 * 257, D = 1024, H = 4096): the fused kernel against its plain
version (tanh GELU, which the prototype computes, and the exact GELU), then
its time beside today's split (the library's out-projection and residual,
then the three-launch fused MLP kernel) and the plain split. Prints one JSON
line per row and a verdict line.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from vitlens_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_reference
from vitlens_tpu_torch.ops.fused_mlp_chain import (fused_attnout_mlp,
                                                   fused_mlp_chain_reference)
from vitlens_tpu_torch.scripts import _common as C

D, HIDDEN, M, ITERS = 1024, 4096, 64 * 257, 30
TOL = 2.5e-2  # the prototype's own bound, relative to max|want|, bf16


def main(argv=None) -> int:
    p = C.parser(__doc__.splitlines()[0], ITERS)
    p.add_argument("--rows", type=int, default=M)
    p.add_argument("--dim", type=int, default=D)
    p.add_argument("--hidden", type=int, default=HIDDEN)
    args = p.parse_args(argv)
    dev = C.device_of(args)
    m, d, hidden = args.rows, args.dim, args.hidden
    rng = np.random.RandomState(args.seed)
    x, *mlp = C.mlp_inputs(rng, m, d, hidden, dev)

    def t(a, dtype):
        return torch.from_numpy(a.astype(np.float32)).to(device=dev, dtype=dtype)

    proj = (t(rng.randn(m, d) * 0.02, torch.bfloat16),
            t(rng.randn(d, d) * 0.02, torch.bfloat16),
            t(rng.randn(d) * 0.01, torch.float32))
    ctx, wo, bo = proj
    flops = 2 * m * d * d + 4 * m * d * hidden
    base = {"device": C.device_name(dev), "shape": [m, d, hidden]}

    def split(mlp_fn):
        y = x + (ctx @ wo + bo.to(x.dtype))
        return mlp_fn(y, *mlp, act="gelu")

    errs = {act: C.rel_err(
        fused_attnout_mlp(x, *proj, *mlp, act=act),
        fused_mlp_chain_reference(x, *mlp, act=act, outproj=proj))
        for act in ("gelu_tanh", "gelu")}
    rows = {"fused_gelu_tanh": lambda: fused_attnout_mlp(x, *proj, *mlp,
                                                         act="gelu_tanh"),
            "fused_gelu": lambda: fused_attnout_mlp(x, *proj, *mlp, act="gelu"),
            "library_outproj_plus_fused_mlp(today)": lambda: split(fused_mlp),
            "library_outproj_plus_plain_mlp": lambda: split(fused_mlp_reference)}
    ms = {}
    ok = True
    for name, fn in rows.items():
        err = errs.get(name.replace("fused_", "", 1))
        if err is not None and not err <= TOL:
            C.emit({**base, "name": name, "error": f"numerics {err:.3e}"})
            ok = False
            continue
        ms[name] = C.time_ms(fn, args.iters, dev)
        C.emit({**base, "name": name, **C.timing(ms[name], dev, tflops=flops / ms[name] / 1e9),
                **({"max_rel_err": err} if err is not None else {})})
    best = min(ms, key=ms.get)
    C.emit({**base, "verdict": best, "speedup_vs_plain_split":
            ms["library_outproj_plus_plain_mlp"] / ms[best]})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
