"""One-stop inference CLI (port of vitlens_tpu/cli/infer.py): encode files
across modalities and print the softmax similarity matrices of each pair:

  python -m vitlens_tpu_torch.cli.infer \\
      --audio a.flac b.flac --text "a dog" "sea waves" \\
      --ckpt audio=/path/vitlensL_audio.pt --ckpt text=/path/clip.bin

The JAX CLI's flags, plus ``--device`` (default: the CUDA device) and
``--precision`` (fp32, as JAX, or bf16). ``--data-parallel N`` splits each
encode over the first N cards, a replica of each tower on each (with
``--device cpu``, N chunks on the host).
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np

MODALITIES = ("image", "audio", "pc", "depth", "tactile", "eeg", "video")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("vitlens-tpu inference")
    p.add_argument("--model-var", default="vitlensL",
                   choices=["vitlensL", "vitlensB"])
    for m in MODALITIES:
        p.add_argument(f"--{m}", nargs="*", default=None)
    p.add_argument("--text", nargs="*", default=None)
    p.add_argument("--ckpt", action="append", default=[],
                   help="modality=path (repeatable); use all=path for merged")
    p.add_argument("--logit-scale", type=float, default=100.0)
    p.add_argument("--data-parallel", type=int, default=0, metavar="N",
                   help="shard encode batches over an N-device data mesh "
                        "(0 = single device)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    p.add_argument("--precision", default="fp32", choices=["fp32", "bf16"])
    return p


def similarity_matrices(out: Dict[str, np.ndarray], logit_scale: float):
    """{(a, b): softmax(logit_scale * a @ b.T) over each row} for every pair
    of modalities in ``out``'s order: the product in the features' dtype,
    the softmax in float64, as the JAX CLI computes them."""
    mods = list(out)
    res = {}
    for i in range(len(mods)):
        for j in range(i + 1, len(mods)):
            a, b = mods[i], mods[j]
            sim = np.asarray(out[a] @ out[b].T, np.float64) * logit_scale
            sm = np.exp(sim - sim.max(axis=-1, keepdims=True))
            res[(a, b)] = sm / sm.sum(axis=-1, keepdims=True)
    return res


def main(argv=None) -> int:
    import torch

    parser = build_parser()
    args = parser.parse_args(argv)
    inputs = {m: getattr(args, m) for m in (*MODALITIES, "text")
              if getattr(args, m)}
    if not inputs:
        parser.error("no inputs given")
    from vitlens_tpu_torch.cli.serve import data_parallel_mesh

    mesh = data_parallel_mesh(args.data_parallel, args.device)
    ckpts = {}
    for spec in args.ckpt:
        k, _, v = spec.partition("=")
        ckpts[k] = v

    from vitlens_tpu_torch.api import ViTLens

    model = ViTLens(model_var=args.model_var, modality_loaded=list(inputs),
                    checkpoints=ckpts, device=None if mesh else args.device,
                    mesh=mesh,
                    compute_dtype=(torch.bfloat16 if args.precision == "bf16"
                                   else torch.float32))
    out = model.encode(inputs, normalize=True)
    out = {m: v.float().cpu().numpy() for m, v in out.items()}
    np.set_printoptions(precision=5, suppress=False)
    for (a, b), sm in similarity_matrices(out, args.logit_scale).items():
        print(f"\n{a} x {b} softmax({args.logit_scale:g} * sim):")
        print(sm)
    return 0


if __name__ == "__main__":
    sys.exit(main())
