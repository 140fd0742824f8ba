"""PyTorch port of vitlens_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package's module layout. Imports torch and numpy only, never
jax and never the JAX package. Kernels under ``csrc/`` are built at first use
by ``ops/_build.py``.
"""
