#!/usr/bin/env python3
"""FPS at B64 and B = 1 (N 8192, npoint 512; CUDA events, 20 calls) and the
host-timed latency of a B = 1 pc encode (ViTLens("vitlensL", ("pc",)), bf16,
best of 5 ending in torch.cuda.synchronize()) with the vitlens_tpu_torch
package of the tree given, e.g. an unpacked archive of another commit; run it
on each tree in turns to compare them on one card.

    python3 tools/fps_latency.py path/to/tree

Needs one CUDA device and nvcc. Prints one JSON line."""
import json
import os
import sys
import time

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
import torch  # noqa: E402

import vitlens_tpu_torch  # noqa: E402
from vitlens_tpu_torch.api import ViTLens  # noqa: E402
from vitlens_tpu_torch.ops.fps import fps_indices  # noqa: E402

g = torch.Generator(device="cuda").manual_seed(0)
res = {"tree": tree, "package": vitlens_tpu_torch.__file__}
for b in (64, 1):
    xyz = torch.randn(b, 8192, 3, generator=g, device="cuda") * 0.3
    start = torch.zeros(b, dtype=torch.int32, device="cuda")
    for _ in range(3):
        fps_indices(xyz, 512, start)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(20):
        fps_indices(xyz, 512, start)
    e1.record()
    torch.cuda.synchronize()
    res[f"fps_B{b}_ms"] = e0.elapsed_time(e1) / 20
model = ViTLens("vitlensL", ("pc",), device="cuda", compute_dtype=torch.bfloat16, seed=0)
cloud = (torch.randn(1, 8192, 3, generator=g, device="cuda") * 0.3)
for _ in range(2):
    model.encode({"pc": cloud}, preprocessed=True)
torch.cuda.synchronize()
times = []
for _ in range(5):
    t0 = time.perf_counter()
    model.encode({"pc": cloud}, preprocessed=True)["pc"]
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
res["pc_B1_latency_ms"] = min(times)
res["pc_B1_all_ms"] = [round(t, 3) for t in times]
print(json.dumps(res), flush=True)
