"""Video frame sampling and transforms, on the host (port of
vitlens_tpu/data/video_processors.py).

Frame indices: uniform segments, each segment's centre (eval) or a uniform
draw within it (train). Eval, each sampled frame: resize of the smaller
edge (bicubic), centre crop (or three crops along the long edge), scale to
[0, 1], OpenAI mean/std. Train (the reference lavis train processor,
vt_processors.py:756-772): ONE RandomResizedCrop box a clip at scale (0.5,
1.0), ONE horizontal-flip coin a clip (p = 0.5), clip-level RandAugment (n
= 2, m = 5) over the reference's 10-op list, then the same normalisation.
There is no video decoder: clips come as directories of pre-extracted
frames (jpg/png per frame, in file-name order), as frame arrays [T, H, W, 3]
uint8, lists of PIL images, or video files through a caller's
``decode_fn(path) -> [T, H, W, 3]``.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np
from PIL import Image

from vitlens_tpu_torch.config import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
from vitlens_tpu_torch.data.augment import random_resized_crop_params
from vitlens_tpu_torch.data.processors import (_normalize_chw,
                                               _resize_smaller_edge)
from vitlens_tpu_torch.data.rng import ThreadLocalRNG
from vitlens_tpu_torch.data.video_randaugment import (VIDEO_TRAIN_AUG_LIST,
                                                      VideoRandAugment)


def sample_frame_indices(total: int, n_frames: int, train: bool = False,
                         rng: Optional[np.random.RandomState] = None,
                         fix_start: Optional[int] = None) -> np.ndarray:
    """``n_frames`` indices into a clip of ``total`` frames: uniform
    segments; eval takes each segment's centre, train (with ``rng``) a
    uniform draw within it, ``fix_start`` a fixed offset from its start. A
    clip shorter than ``n_frames`` repeats frames."""
    if total <= 0:
        raise ValueError("empty video")
    edges = np.linspace(0, total, n_frames + 1)
    lo = np.floor(edges[:-1]).astype(int)
    hi = np.maximum(np.ceil(edges[1:]).astype(int) - 1, lo)
    if fix_start is not None:
        idx = np.minimum(lo + fix_start, hi)
    elif train and rng is not None:
        idx = np.array([rng.randint(l, h + 1) for l, h in zip(lo, hi)])
    else:
        idx = (lo + hi) // 2
    return np.clip(idx, 0, total - 1)


def load_frame_dir(path: str) -> List[Image.Image]:
    """Pre-extracted frames: the jpg/png files of a directory, sorted by
    name, as RGB images."""
    files = sorted(f for f in os.listdir(path)
                   if f.lower().endswith((".jpg", ".jpeg", ".png")))
    frames = []
    for f in files:
        with Image.open(os.path.join(path, f)) as img:
            frames.append(img.convert("RGB"))
    return frames


def _to_chw_norm(img: Image.Image, mean, std) -> np.ndarray:
    arr = np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0
    return _normalize_chw(arr, mean, std)


def spatial_three_crop(img: Image.Image, size: int) -> List[Image.Image]:
    """Three ``size`` crops along the long edge (start, centre, end) of the
    image resized on its smaller edge."""
    img = _resize_smaller_edge(img, size)
    w, h = img.size
    if w >= h:
        return [img.crop((x, 0, x + size, size))
                for x in (0, (w - size) // 2, w - size)]
    return [img.crop((0, y, size, y + size))
            for y in (0, (h - size) // 2, h - size)]


class VideoProcessor:
    """Clips -> [B, n_frames, 3, S, S] float32 (``three_crop``: [B, 3,
    n_frames, 3, S, S], grouped by crop). A clip is a frame directory, a
    frame array [T, H, W, 3] uint8, a list of PIL images, or a video file
    read by ``decode_fn``; a file with no ``decode_fn`` raises, as in JAX.
    ``train`` takes the train transforms; ``rand_aug=False`` and
    ``hflip=False`` turn off their RandAugment and flip."""

    def __init__(self, n_frames: int = 8, size: int = 224,
                 mean=None, std=None, train: bool = False, seed: int = 0,
                 decode_fn: Optional[Callable] = None,
                 three_crop: bool = False,
                 rand_aug: bool = True, rand_aug_n: int = 2,
                 rand_aug_m: float = 5.0, hflip: bool = True,
                 crop_scale=(0.5, 1.0)):
        self.n_frames = n_frames
        self.size = size
        self.mean = mean or OPENAI_DATASET_MEAN
        self.std = std or OPENAI_DATASET_STD
        self.train = train
        self.rng = ThreadLocalRNG(seed)  # loader and server threads share it
        self.decode_fn = decode_fn
        self.three_crop = three_crop
        self.hflip = hflip
        self.crop_scale = tuple(crop_scale)
        self.rand_aug = (VideoRandAugment(n=rand_aug_n, m=rand_aug_m,
                                          aug_list=VIDEO_TRAIN_AUG_LIST)
                         if train and rand_aug else None)

    def _get_frames(self, src) -> List[Image.Image]:
        if isinstance(src, str):
            if os.path.isdir(src):
                return load_frame_dir(src)
            if self.decode_fn is None:
                raise RuntimeError(
                    "video files need a decode_fn (there is no video decoder "
                    "here); pass pre-extracted frame directories")
            return [Image.fromarray(f) for f in self.decode_fn(src)]
        if isinstance(src, np.ndarray):
            return [Image.fromarray(f) for f in src]
        return list(src)

    def process_one(self, src) -> np.ndarray:
        frames = self._get_frames(src)
        idx = sample_frame_indices(len(frames), self.n_frames,
                                   train=self.train, rng=self.rng)
        picked = [frames[i] for i in idx]
        if self.train:
            return self._train_clip(picked)
        if self.three_crop:
            # resize and crop each frame once, then group by crop
            per_frame = [[_to_chw_norm(c, self.mean, self.std)
                          for c in spatial_three_crop(f, self.size)]
                         for f in picked]
            return np.stack([np.stack([pf[ci] for pf in per_frame])
                             for ci in range(3)])
        out = []
        for f in picked:
            f = _resize_smaller_edge(f, self.size)
            w, h = f.size
            left, top = (w - self.size) // 2, (h - self.size) // 2
            f = f.crop((left, top, left + self.size, top + self.size))
            out.append(_to_chw_norm(f, self.mean, self.std))
        return np.stack(out)

    def _train_clip(self, picked: List[Image.Image]) -> np.ndarray:
        """One crop box and one flip coin for the whole clip (its frames
        share one size, as decoded video does), then RandAugment."""
        w, h = picked[0].size
        left, top, cw, ch = random_resized_crop_params(
            w, h, self.rng, scale=self.crop_scale)
        clip = np.stack([np.asarray(f.resize((self.size, self.size),
                                             Image.BICUBIC,
                                             box=(left, top, left + cw, top + ch)),
                                    np.uint8)
                         for f in picked])  # [T, S, S, 3] uint8
        if self.hflip and self.rng.rand() < 0.5:
            clip = clip[:, :, ::-1]
        if self.rand_aug is not None:
            clip = self.rand_aug(np.ascontiguousarray(clip), self.rng)
        arr = clip.astype(np.float32).transpose(0, 3, 1, 2) / 255.0
        return _normalize_chw(arr, self.mean, self.std)

    def __call__(self, srcs) -> np.ndarray:
        if not isinstance(srcs, (list, tuple)):
            srcs = [srcs]
        return np.stack([self.process_one(s) for s in srcs])
