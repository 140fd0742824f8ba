"""Host-side processors (port of vitlens_tpu/data/processors.py).

Ported: ``TextProcessor`` (caption cleanup plus CLIP BPE) and
``PointCloudProcessor`` (host FPS to the tower's point count, unit-sphere
normalisation), the latter on its numpy path only.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np


def _wrap_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


class TextProcessor:
    def __init__(self, prompt: str = "", max_words: int = 70,
                 context_length: int = 77, tokenizer=None):
        self.prompt = prompt
        self.max_words = max_words
        self.context_length = context_length
        if tokenizer is None:
            from vitlens_tpu_torch.text.tokenizer import get_tokenizer

            tokenizer = get_tokenizer()
        self.tokenizer = tokenizer

    def pre_caption(self, caption: str) -> str:
        caption = re.sub(r"([.!\"()*#:;~])", " ", caption.lower())
        caption = re.sub(r"\s{2,}", " ", caption)
        caption = caption.rstrip("\n").strip(" ")
        words = caption.split(" ")
        if len(words) > self.max_words:
            caption = " ".join(words[: self.max_words])
        return caption

    def __call__(self, captions) -> np.ndarray:
        caps = [self.prompt + self.pre_caption(c) for c in _wrap_list(captions)]
        return self.tokenizer(caps, self.context_length)


def farthest_point_sample_np(points: np.ndarray, npoint: int,
                             seed: Optional[int] = None) -> np.ndarray:
    """Host FPS of one cloud [N, >=3] -> [npoint, C]. The start is 0, or
    random from ``seed``; distances use xyz only."""
    n = points.shape[0]
    xyz = points[:, :3]
    farthest = int(np.random.RandomState(seed).randint(0, n)) \
        if seed is not None else 0
    dist = np.full(n, 1e10, dtype=np.float64)
    idxs = np.zeros(npoint, dtype=np.int64)
    for i in range(npoint):
        idxs[i] = farthest
        d = np.sum((xyz - xyz[farthest]) ** 2, axis=-1)
        np.minimum(dist, d, out=dist)
        farthest = int(np.argmax(dist))
    return points[idxs]


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Center, then scale into the unit sphere."""
    pc = pc - pc.mean(axis=0)
    m = np.max(np.sqrt(np.sum(pc ** 2, axis=1)))
    return pc / m


class PointCloudProcessor:
    """Cloud arrays (or ``.npy`` paths) -> [B, n, channels] float32: FPS down
    to ``n`` points (or a seeded permutation when ``uniform`` is off or the
    cloud is small), xyz normalised, extra columns passed through and missing
    rgb columns filled with 0.4 gray."""

    def __init__(self, n_sample_points: int = 8192, uniform: bool = True,
                 identity: bool = False, seed: Optional[int] = None,
                 channels: int = 3):
        self.n = n_sample_points
        self.uniform = uniform
        self.identity = identity
        self.seed = seed
        self.channels = channels

    def process_array(self, pc: np.ndarray) -> np.ndarray:
        if self.identity:
            return pc.astype(np.float32)
        if self.uniform and self.n < pc.shape[0]:
            pc = farthest_point_sample_np(pc, self.n, self.seed)
        elif pc.shape[0] != self.n:
            perm = np.random.RandomState(self.seed).permutation(pc.shape[0])
            pc = pc[perm[: self.n]]
        xyz = pc_normalize(pc[:, :3]).astype(np.float32)
        rest = pc[:, 3:self.channels].astype(np.float32)
        if 3 + rest.shape[1] < self.channels:
            fill = np.full((pc.shape[0], self.channels - 3 - rest.shape[1]),
                           0.4, np.float32)
            rest = np.concatenate([rest, fill], axis=1)
        return np.concatenate([xyz, rest], axis=1) if self.channels > 3 \
            else xyz

    def __call__(self, clouds) -> np.ndarray:
        return np.stack([self.process_array(
            c if isinstance(c, np.ndarray) else np.load(c))
            for c in _wrap_list(clouds)])
