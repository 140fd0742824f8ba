"""Thread-safe per-dataset RNG (a copy of vitlens_tpu/data/rng.py, which the
port may not import).

``np.random.RandomState`` is not thread-safe: concurrent MT19937 state
updates corrupt the stream. A processor that loader or server threads share
therefore holds a ``ThreadLocalRNG``: each thread gets its own RandomState
sub-stream. The first thread to touch it (ordinal 0, the main thread in
single-threaded use) gets ``RandomState(seed)`` exactly, so single-threaded
draws are bit-identical to a plain RandomState; later threads get
decorrelated sub-streams.
"""

from __future__ import annotations

import threading

import numpy as np


class ThreadLocalRNG:
    """Duck-types ``np.random.RandomState`` by attribute proxying."""

    def __init__(self, seed: int):
        self._seed = int(seed) & 0xFFFFFFFF
        self._local = threading.local()
        self._next_ordinal = 0
        self._lock = threading.Lock()

    def _stream(self) -> np.random.RandomState:
        rs = getattr(self._local, "rs", None)
        if rs is None:
            with self._lock:
                ordinal = self._next_ordinal
                self._next_ordinal += 1
            # a golden-ratio stride decorrelates the per-thread seeds
            rs = np.random.RandomState(
                (self._seed + 0x9E3779B9 * ordinal) & 0xFFFFFFFF)
            self._local.rs = rs
        return rs

    def __getattr__(self, name):
        return getattr(self._stream(), name)
