"""A hand-written row gather against the library's (counterpart of
scripts/bench_dma_gather.py).

    python -m vitlens_tpu_torch.scripts.bench_dma_gather [--device cpu]

The token-embedding table of the text tower, [49408, 512] bf16, and B128 x 77
ids: the kernel (``ops.row_gather``) must be bit-equal to ``table[ids]``; then
its time beside ``torch.index_select``'s. Prints one JSON line.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from vitlens_tpu_torch.ops.row_gather import row_gather, row_gather_reference
from vitlens_tpu_torch.scripts import _common as C

V, D, B, T, ITERS = 49408, 512, 128, 77, 200


def main(argv=None) -> int:
    p = C.parser(__doc__.splitlines()[0], ITERS)
    p.add_argument("--batch", type=int, default=B)
    args = p.parse_args(argv)
    dev = C.device_of(args)
    rng = np.random.RandomState(args.seed)
    table = torch.from_numpy(rng.randn(V, D).astype(np.float32)).to(
        device=dev, dtype=torch.bfloat16)
    ids = torch.from_numpy(rng.randint(0, V, size=(args.batch * T,))
                           .astype(np.int32)).to(dev)
    got = row_gather(table, ids)
    exact = torch.equal(got.view(torch.int16),
                        row_gather_reference(table, ids).view(torch.int16))
    unit = "ms" if dev.type == "cuda" else "host_ms"
    C.emit({"device": C.device_name(dev), "rows": args.batch * T, "exact": exact,
            f"index_select_{unit}": C.time_ms(
                lambda: torch.index_select(table, 0, ids), args.iters, dev),
            f"row_gather_{unit}": C.time_ms(lambda: row_gather(table, ids),
                                            args.iters, dev)})
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
