"""Model export (port of vitlens_tpu/utils/export.py), as ``torch.export``.

The JAX package serialises a jitted function to StableHLO; the port exports
an ``ExportedProgram`` and serialises it with ``torch.export.save``. The
hand kernels an encode reaches are recorded as the custom ops of
``ops/custom.py``, so a loaded program launches the same kernels on the card
(their launch counters advance) and the plain versions on the CPU; the trace
captures no plain version in their place. Export runs without gradients.

  blob = export_encoder(tower, example_input, compute_dtype=torch.bfloat16)
  program = load_exported(blob)
  feats = program.call(x)
"""

from __future__ import annotations

import io
from typing import Callable

import torch
import torch.nn as nn

from vitlens_tpu_torch.ops import custom


class _Fn(nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_program(fn, *example_args) -> torch.export.ExportedProgram:
    """Trace ``fn`` (a module or a function of tensors) at the example
    arguments' shapes, the kernels as their custom ops."""
    module = fn if isinstance(fn, nn.Module) else _Fn(fn)
    with torch.no_grad(), custom.tracing():
        return torch.export.export(module, tuple(example_args), strict=False)


def export_stablehlo(fn, *example_args) -> bytes:
    """Trace and serialise ``fn`` for the example arguments' shapes (the JAX
    package's name; the artifact is a serialised ``ExportedProgram``). It
    takes no platform list: the program runs where its weights and inputs
    lie."""
    buf = io.BytesIO()
    torch.export.save(export_program(fn, *example_args), buf)
    return buf.getvalue()


class Loaded:
    """A deserialised program: ``call(*args)`` runs it."""

    def __init__(self, program: torch.export.ExportedProgram):
        self.program = program
        self._module = program.module()

    def call(self, *args):
        with torch.no_grad():
            return self._module(*args)


def load_exported(blob: bytes) -> Loaded:
    # the ops must be registered before the program is read
    from vitlens_tpu_torch.ops import (flash_attention, fps,  # noqa: F401
                                       fused_ln_proj, fused_mlp,
                                       fused_point_encoder)

    return Loaded(torch.export.load(io.BytesIO(blob)))


class _Encoder(nn.Module):
    def __init__(self, tower: nn.Module, compute_dtype: torch.dtype):
        super().__init__()
        self.tower, self.compute_dtype = tower, compute_dtype

    def forward(self, x):
        feats = self.tower(x, self.compute_dtype)
        n = torch.linalg.vector_norm(feats.float(), dim=-1, keepdim=True)
        return feats / n.clamp_min(1e-12)


def export_encoder(tower: nn.Module, example_input: torch.Tensor,
                   compute_dtype: torch.dtype = torch.float32) -> bytes:
    """Serialise a tower's normalised encode (``encode_visual`` of one
    tower, e.g. ``ViTLens(...).towers["audio"]``) for serving. The weights
    are saved with the program, on their device."""
    return export_stablehlo(_Encoder(tower, compute_dtype), example_input)
