#!/usr/bin/env python3
"""Kernel 1's output digests (chip_smoke.kernel1_digests of this checkout) with
the vitlens_tpu_torch package of the tree given, e.g. an unpacked archive of
another commit: the constants KERNEL1_DIGESTS come from it.

    python3 tools/kernel1_digests.py path/to/tree

Needs one CUDA device and nvcc. Prints one JSON line."""
import importlib.util
import json
import os
import sys

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location(
    "cs_here", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import numpy as np  # noqa: E402
import torch  # noqa: E402
import vitlens_tpu_torch  # noqa: E402
print(json.dumps({"tree": tree, "package": vitlens_tpu_torch.__file__,
                  "digests": cs.kernel1_digests(torch, np)}), flush=True)
