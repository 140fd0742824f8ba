"""The forward kernels an encode reaches, as ``torch.library`` custom ops,
for ``torch.export`` (``utils/export.py``).

The kernels are ctypes calls on ``data_ptr()``, which a trace with fake
tensors cannot enter. While :func:`tracing` is active, each wrapper
(``fused_mlp``, ``flash_attention``, ``fps_indices``,
``fused_point_encoder``, ``fused_ln_proj``) calls its op
``torch.ops.vitlens.*`` instead: the trace records the op with the output its fake says, and the op's
body, when the traced program runs, is the wrapper's own dispatch, so a CUDA
tensor launches the kernel (and counts the launch) and a CPU tensor takes the
plain version, as in eager code. The ops carry no autograd: an export runs
the forward only.
"""

from __future__ import annotations

import contextlib

_TRACING = False


@contextlib.contextmanager
def tracing():
    """Route the wrappers through their custom ops while the block runs."""
    global _TRACING
    prev, _TRACING = _TRACING, True
    try:
        yield
    finally:
        _TRACING = prev


def through_ops() -> bool:
    return _TRACING
