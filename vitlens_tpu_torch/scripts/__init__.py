"""Bench entry points of the port: the counterparts of the JAX package's
prototype and bench scripts under ``scripts/`` whose kernels were ported.

Each runs as ``python -m vitlens_tpu_torch.scripts.<name>``, on the card unless
given ``--device cpu`` (where the kernels' plain versions run and the times are
the host's, labelled so). Correctness comes first, against the plain version;
then the timings, one JSON line per row.
"""
