"""FLOPs statistics of the Lens tower (port of vitlens_tpu/utils/flops.py), for
--visual-stat-flops (the reference counts ptflops over model.visual,
audio_tri_main.py:349-371).

The count is ``torch.utils.flop_counter.FlopCounterMode`` over one forward
of the plain path (fp32 compute, where every call site takes its plain
PyTorch version): the hand kernels launch through ctypes, where no counter
sees them. FlopCounterMode counts the products (matmuls, convolutions,
attention), two FLOPs a multiply-add; JAX's count is XLA's cost analysis,
which adds the elementwise work, so the JAX number is the larger
(``tests/test_torch_cli_train.py`` holds the gap at ViT-Tiny-Test).
"""

from __future__ import annotations

from typing import Any, Dict

import torch


def count_params(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


@torch.no_grad()
def model_flops_report(model, modality_input: torch.Tensor) -> Dict[str, Any]:
    """FLOPs of one ``encode_visual`` forward of ``model`` (a TriModel) on
    ``modality_input`` [B, ...], in fp32 on the model's device: {flops,
    params_total (the Lens tower's), gflops_per_sample}."""
    from torch.utils.flop_counter import FlopCounterMode

    from vitlens_tpu_torch.models import tri

    x = modality_input.to(model.logit_scale.device, torch.float32)
    counter = FlopCounterMode(display=False)
    with counter:
        tri.encode_visual(model, x, compute_dtype=torch.float32)
    flops = float(counter.get_total_flops())
    return {"flops": flops, "params_total": count_params(model.visual),
            "gflops_per_sample": flops / x.shape[0] / 1e9}
