"""Sequence parallelism of the trunks' inter-block activations (port of
vitlens_tpu/parallel/sp.py).

JAX constrains the [B, N, D] carry of every trunk to be sequence-sharded
over the ``model`` mesh axis at each block boundary and lets GSPMD place the
collectives; the numbers are the unconstrained trunk's. The port runs one
process a rank: inside :func:`sequence_sharded_activations` every
``models.layers.Transformer`` keeps model rank r's rows [r * ceil(N / tp),
(r + 1) * ceil(N / tp)) of its carry between blocks (N padded with zero rows
to a multiple of tp), and its blocks run on those rows
(``ResBlock.model_axis_forward``: the keys and values gathered, or with
tensor parallelism the rows gathered in front of each column-parallel
product and reduce-scattered after each row-parallel one). The trunk's
output is gathered whole again, so what follows it is unchanged. A carry
whose ``ndim`` is not 3 passes through, as in JAX.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from vitlens_tpu_torch.models.layers import (SequenceFrame,
                                             set_activation_constraint)
from vitlens_tpu_torch.parallel.mesh import Mesh, model_split, model_unsplit


class SequenceSharding:
    """The hook :func:`sequence_sharded_activations` sets: ``shard`` cuts a
    Transformer's input to this model rank's rows (the backward gathers the
    rows' cotangents), ``unshard`` gathers its output whole (the backward
    keeps this rank's rows)."""

    def __init__(self, mesh: Mesh):
        if not mesh.spans_processes or mesh.model_group is None:
            raise ValueError("sequence parallelism needs a mesh with a model "
                             "axis over processes: make_mesh(n_model=tp)")
        self.mesh = mesh

    def shard(self, x: torch.Tensor):
        frame = SequenceFrame(self.mesh, x.shape[1])
        return model_split(frame.pad(x), self.mesh, 1), frame

    def unshard(self, x: torch.Tensor, frame: SequenceFrame) -> torch.Tensor:
        return model_unsplit(x, self.mesh, 1)[:, :frame.n]


@contextmanager
def sequence_sharded_activations(mesh: Mesh):
    """Every trunk run inside carries sequence-sharded activations over
    ``mesh``'s model axis between its blocks (the batch stays split over
    the data axis, as each rank's rows). The hook is always reset::

        with sequence_sharded_activations(mesh):
            feats = tower(x)
    """
    set_activation_constraint(SequenceSharding(mesh))
    try:
        yield
    finally:
        set_activation_constraint(None)
