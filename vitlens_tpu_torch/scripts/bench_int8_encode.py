"""End to end: the int8 (W8A8) quantized audio-Lens encode against the float
one (counterpart of scripts/bench_int8_encode.py).

    python -m vitlens_tpu_torch.scripts.bench_int8_encode [--device cpu]

The same ViT-L audio model (random weights from the seed) and the same
[64, 512, 128] fbank through the bf16 path (fused MLP kernel on) and through
its copy with the visual trunk quantized by ``quant.quantize_model``: first
the fidelity of the features (cosine, computed in fp32), then samples/s of
each, best of 3 loops of ``--iters`` encodes. Prints one JSON line per row
and the ratio.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from vitlens_tpu_torch.factory import create_model
from vitlens_tpu_torch.models import tri
from vitlens_tpu_torch.quant import quantize_model
from vitlens_tpu_torch.scripts import _common as C

BATCH, ITERS = 64, 20


def main(argv=None) -> int:
    p = C.parser(__doc__.splitlines()[0], ITERS)
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--model", default="ViT-L-14")
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    args = p.parse_args(argv)
    dev = C.device_of(args)
    dtype = getattr(torch, args.dtype)
    model = create_model(args.model, "audio", seed=args.seed, device=dev,
                         dtype=dtype)
    models = {"float": model, "int8": quantize_model(model, towers=("visual",))}
    audio = model.cfg.tower.audio
    fbank = torch.from_numpy(
        np.random.RandomState(args.seed)
        .randn(args.batch, audio.target_length, audio.mel_bins)
        .astype(np.float32)).to(dev)

    @torch.inference_mode()
    def encode(m):
        return tri.encode_visual(m, fbank, normalize=True, compute_dtype=dtype)

    feats = {name: encode(m).float() for name, m in models.items()}
    cos = torch.nn.functional.cosine_similarity(feats["float"], feats["int8"],
                                                dim=-1)
    base = {"device": C.device_name(dev), "model": args.model,
            "batch": args.batch, "dtype": args.dtype}
    C.emit({**base, "name": "feature_cos_int8_vs_float",
            "min": cos.min().item(), "mean": cos.mean().item()})
    rate = {}
    for name, m in models.items():
        ms = C.time_ms(lambda: encode(m), args.iters, dev)
        rate[name] = args.batch / ms * 1e3
        C.emit({**base, "name": name, **C.timing(ms, dev, samples_per_s=rate[name])})
    C.emit({**base, "int8_over_float": rate["int8"] / rate["float"],
            "cos_min": cos.min().item()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
