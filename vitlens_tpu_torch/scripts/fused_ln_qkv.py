"""LayerNorm + the packed qkv projection in one kernel (counterpart of
scripts/fused_ln_qkv_pallas.py).

    python -m vitlens_tpu_torch.scripts.fused_ln_qkv [--device cpu]

The prototype's body is that of the fused LN + projection kernel, so this
calls ``ops.fused_ln_proj`` directly (not through the resblock's opt-in
dispatch) at the prototype's shape, [64 * 257, 1024] -> [.., 3072]: against
its plain version first, then its time beside the plain version's. Prints one
JSON line per row and a verdict line.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from vitlens_tpu_torch.ops.fused_ln_proj import fused_ln_proj, ln_proj_reference
from vitlens_tpu_torch.scripts import _common as C

D, M, ITERS = 1024, 64 * 257, 30
TOL = 2.5e-2  # the prototype's own bound, relative to max|want|, bf16


def main(argv=None) -> int:
    p = C.parser(__doc__.splitlines()[0], ITERS)
    p.add_argument("--rows", type=int, default=M)
    p.add_argument("--dim", type=int, default=D)
    args = p.parse_args(argv)
    dev = C.device_of(args)
    m, d = args.rows, args.dim
    out = 3 * d
    rng = np.random.RandomState(args.seed)
    x, lnw, lnb, w, _, _, _ = C.mlp_inputs(rng, m, d, out, dev)
    b = torch.from_numpy((rng.randn(out) * 0.01).astype(np.float32)).to(dev)
    a = (x, lnw, lnb, w, b)
    flops = 2 * m * d * out
    base = {"device": C.device_name(dev), "shape": [m, d, out]}

    err = C.rel_err(fused_ln_proj(*a), ln_proj_reference(*a))
    if not err <= TOL:
        C.emit({**base, "name": "fused_ln_qkv", "error": f"numerics {err:.3e}"})
        return 1
    ms = {"fused_ln_qkv": C.time_ms(lambda: fused_ln_proj(*a), args.iters, dev),
          "plain_ln_qkv": C.time_ms(lambda: ln_proj_reference(*a), args.iters, dev)}
    for name, t in ms.items():
        C.emit({**base, "name": name, **C.timing(t, dev, tflops=flops / t / 1e9),
                **({"max_rel_err": err} if name == "fused_ln_qkv" else {})})
    best = min(ms, key=ms.get)
    C.emit({**base, "verdict": best,
            "speedup_vs_plain": ms["plain_ln_qkv"] / ms[best]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
