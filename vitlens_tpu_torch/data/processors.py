"""Host-side processors: raw files -> model-ready arrays (port of
vitlens_tpu/data/processors.py).

Ported: ``TextProcessor`` (caption cleanup plus CLIP BPE),
``ImageProcessor`` (bicubic resize of the smaller edge, center crop, OpenAI
mean/std), ``TrainImageProcessor`` (the random train crop and its extras),
``TactileProcessor`` (resize 256, crop 224), ``DepthProcessor``
(disparity clamp and scale, mode-F bicubic resize, center crop, depth
mean/std), ``AudioProcessor`` (decode, resample, constant clip grid, Kaldi
fbank), ``EEGProcessor`` (crop t[20:460], linear resample to 512) and
``PointCloudProcessor`` (host FPS to the tower's point count, unit-sphere
normalisation), the latter on its numpy path only; the video processor is in
``data/video_processors.py``. Decoding is numpy, PIL, ``torch.load`` (the
``.pt`` depth and EEG files) and the stdlib.
"""

from __future__ import annotations

import re
from fractions import Fraction
from typing import List, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from vitlens_tpu_torch.config import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
from vitlens_tpu_torch.data.augment import (AugmentationCfg,
                                            train_image_transform)
from vitlens_tpu_torch.data.rng import ThreadLocalRNG

AST_MEAN = -4.2677393
AST_STD = 4.5689974
# the AudioSet + VGGSound audio variant's statistics
AS_VGGS_MEAN = -5.081
AS_VGGS_STD = 4.485
AUDIO_STATS = {"audioset": (AST_MEAN, AST_STD),
               "as_vggs": (AS_VGGS_MEAN, AS_VGGS_STD)}


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


def _resize_smaller_edge(img: Image.Image, size: int) -> Image.Image:
    w, h = img.size
    if w <= h:
        new = (size, max(1, round(h * size / w)))
    else:
        new = (max(1, round(w * size / h)), size)
    return img.resize(new, Image.BICUBIC)


def _center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[-2:]
    top = max(0, (h - size) // 2)
    left = max(0, (w - size) // 2)
    return arr[..., top:top + size, left:left + size]


def _normalize_chw(arr: np.ndarray, mean, std) -> np.ndarray:
    mean = np.asarray(mean, np.float32)[:, None, None]
    std = np.asarray(std, np.float32)[:, None, None]
    return (arr - mean) / std


class ImageProcessor:
    """Eval transform: resize the smaller edge to ``resize_size`` (bicubic),
    center-crop ``image_size``, scale to [0, 1], OpenAI mean/std. Takes paths
    or PIL images -> [B, 3, image_size, image_size] float32."""

    def __init__(self, image_size: int = 224, mean=None, std=None,
                 resize_size: Optional[int] = None):
        self.image_size = image_size
        self.resize_size = resize_size or image_size
        self.mean = mean or OPENAI_DATASET_MEAN
        self.std = std or OPENAI_DATASET_STD

    def process_pil(self, img: Image.Image) -> np.ndarray:
        img = _resize_smaller_edge(img.convert("RGB"), self.resize_size)
        arr = np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0
        arr = _center_crop(arr, self.image_size)
        return _normalize_chw(arr, self.mean, self.std)

    def __call__(self, paths) -> np.ndarray:
        out = []
        for p in _wrap_list(paths):
            if isinstance(p, Image.Image):
                out.append(self.process_pil(p))
            else:
                with open(p, "rb") as f:
                    out.append(self.process_pil(Image.open(f)))
        return np.stack(out)


class TrainImageProcessor(ImageProcessor):
    """Train transform (reference transform.py:90-137, the is_train branch):
    RandomResizedCrop and normalise, with the timm-style extras of
    ``AugmentationCfg(use_timm=True)`` (random interpolation, colour jitter,
    pixel-mode random erasing) from ``data/augment.py``. Draws come from a
    ``ThreadLocalRNG(seed)``: single-threaded, the same stream as JAX's."""

    def __init__(self, image_size: int = 224, mean=None, std=None,
                 aug_cfg=None, seed: int = 0):
        super().__init__(image_size=image_size, mean=mean, std=std)
        if isinstance(aug_cfg, dict):
            aug_cfg = AugmentationCfg(**aug_cfg)
        self.aug = aug_cfg or AugmentationCfg()
        self.rng = ThreadLocalRNG(seed)  # loader threads share this dataset

    def process_pil(self, img: Image.Image) -> np.ndarray:
        return train_image_transform(img, self.rng, self.image_size,
                                     self.mean, self.std, self.aug)


class TactileProcessor(ImageProcessor):
    """GelSight frames: resize the smaller edge to 256, center-crop 224 (the
    resize edge scales with ``image_size``)."""

    def __init__(self, mean=None, std=None, image_size: int = 224):
        super().__init__(image_size=image_size, mean=mean, std=std,
                         resize_size=round(image_size * 256 / 224))


def farthest_point_sample_np(points: np.ndarray, npoint: int,
                             seed: Optional[int] = None) -> np.ndarray:
    """Host FPS of one cloud [N, >=3] -> [npoint, C], through the native host
    library (``data/native.py``: fp32 distances). The start is 0, or random
    from ``seed``; distances use xyz only."""
    from vitlens_tpu_torch.data.native import fps_indices

    return points[fps_indices(points, npoint, _fps_start(points, seed))]


def _fps_start(points: np.ndarray, seed: Optional[int]) -> int:
    return (int(np.random.RandomState(seed).randint(0, points.shape[0]))
            if seed is not None else 0)


def farthest_point_sample_plain(points: np.ndarray, npoint: int,
                                seed: Optional[int] = None) -> np.ndarray:
    """The plain version of :func:`farthest_point_sample_np`: a numpy loop of
    ``npoint`` passes with float64 distances."""
    n = points.shape[0]
    xyz = points[:, :3]
    farthest = _fps_start(points, seed)
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


def _load_pt(path: str) -> np.ndarray:
    """A tensor saved with ``torch.save`` -> fp32 numpy."""
    return torch.load(path, map_location="cpu").float().numpy()


class DepthProcessor:
    """Disparity map -> normalised depth channel [1, S, S]: clamp below at
    0.01 and above at 75, / 75, resize the smaller edge to 224 (bicubic),
    center crop, then (x - 0.0418) / 0.0295. Takes arrays [H, W] or [1, H,
    W] and ``.npy``/``.npz``, 16-bit ``.png`` and ``.pt`` paths."""

    def __init__(self, depth_mean: float = 0.0418, depth_std: float = 0.0295,
                 max_depth: float = 75.0, clamp_max_before_scale: bool = True,
                 min_depth: float = 0.01, image_size: int = 224):
        self.depth_mean = depth_mean
        self.depth_std = depth_std
        self.max_depth = max_depth
        self.clamp_max = clamp_max_before_scale
        self.min_depth = min_depth
        self.image_size = image_size

    def process_array(self, disparity: np.ndarray) -> np.ndarray:
        d = np.asarray(disparity, np.float32)
        if d.ndim == 3:
            d = d[0]
        d = np.maximum(d, self.min_depth)
        if self.clamp_max:
            d = np.minimum(d, self.max_depth)
        d = d / self.max_depth
        # a float32 [H, W] array is a mode-F image: bicubic in float32
        d = np.asarray(_resize_smaller_edge(Image.fromarray(d), self.image_size),
                       np.float32)
        d = _center_crop(d[None], self.image_size)
        return (d - self.depth_mean) / self.depth_std

    def __call__(self, paths) -> np.ndarray:
        out = []
        for p in _wrap_list(paths):
            if isinstance(p, np.ndarray):
                arr = p
            elif p.endswith((".npy", ".npz")):
                arr = np.load(p)
            elif p.endswith(".png"):  # a 16-bit disparity PNG
                with Image.open(p) as img:
                    arr = np.asarray(img, np.float32)
            else:
                arr = _load_pt(p)
            out.append(self.process_array(arr))
        return np.stack(out)


def constant_clip_timepoints(duration: float, clip_duration: float,
                             n_clip: int) -> List[tuple]:
    """Evenly spaced clip starts: start_i = i * (duration - clip) / n_clip,
    stopping early past the last valid start."""
    maxs = Fraction(max(duration - clip_duration, 0))
    step = Fraction(maxs, n_clip)
    pts = []
    for i in range(n_clip):
        if i > 0 and step * i > maxs:
            break
        s = float(step * i)
        pts.append((s, s + clip_duration))
    return pts


def audio_get_clip(wf: np.ndarray, sr: int, target_duration: float,
                   start=None, end=None, sub_mean: bool = True,
                   rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Slice, repeat-pad or crop one clip of ``wf`` [C, T]."""
    orig_duration = wf.shape[1] / sr
    if start is not None and end is not None:
        if start < orig_duration and end <= orig_duration and end - start > 0.5:
            wf = wf[:, int(start * sr):int(end * sr)]
    target_t = int(sr * target_duration)
    reps = 0
    while wf.shape[1] < target_t and reps <= 5:
        wf = np.concatenate([wf, wf], axis=1)
        reps += 1
    if reps > 5:
        raise ValueError(f"audio too short ({orig_duration}s)")
    if wf.shape[1] > target_t:
        hi = wf.shape[1] - 1 - target_t
        s = (rng.randint(0, hi + 1) if rng is not None and hi > 0 else 0)
        wf = wf[:, s:s + target_t]
    if sub_mean:
        wf = wf - wf.mean()
    return wf


class AudioProcessor:
    """WAV/FLAC paths -> [B, n_clip, target_length, mel_bins] normalised
    fbank.

    The fbank runs on host CPU tensors on purpose, as the JAX package pins it
    to the CPU: the data path never sends per-sample work to the accelerator.
    This mirrors the reference; it is not a fallback. The on-device fbank is
    the tower's waveform branch (a [B, samples] input to ``ViTLens.encode``
    with ``preprocessed=True``)."""

    def __init__(self, sampling_rate: int = 16000, clip_duration: float = 5.0,
                 n_clip: int = 3, target_length: int = 512,
                 mel_bins: int = 128, mean: float = AST_MEAN,
                 std: float = AST_STD, seed: Optional[int] = 0):
        self.sr = sampling_rate
        self.clip_duration = clip_duration
        self.n_clip = n_clip
        self.target_length = target_length
        self.mel_bins = mel_bins
        self.mean = mean
        self.std = std
        self.seed = seed

    def clips(self, wf: np.ndarray, sr: int,
              rng: Optional[np.random.RandomState] = None,
              random_clip: bool = False) -> np.ndarray:
        """Resample to the processor's rate and cut the clips: -> [n_clip,
        clip samples] mono float32. ``random_clip`` samples uniformly random
        windows (the train path); the default is the eval-time constant
        grid."""
        from vitlens_tpu_torch.data.audio_decode import resample

        if wf.ndim == 1:
            wf = wf[None]
        if sr != self.sr:
            wf = resample(wf, sr, self.sr)
        duration = wf.shape[1] / self.sr
        if rng is None:
            rng = np.random.RandomState(self.seed) if self.seed is not None else None
        if duration <= self.clip_duration:
            clips = [audio_get_clip(wf, self.sr, self.clip_duration, rng=rng)
                     ] * self.n_clip
        elif random_clip and rng is not None:
            starts = rng.uniform(0.0, duration - self.clip_duration,
                                 size=self.n_clip)
            clips = [audio_get_clip(wf, self.sr, self.clip_duration, s,
                                    s + self.clip_duration, rng=rng)
                     for s in starts]
        else:
            clips = [audio_get_clip(wf, self.sr, self.clip_duration, s, e, rng=rng)
                     for s, e in constant_clip_timepoints(
                         duration, self.clip_duration, self.n_clip)]
            while len(clips) < self.n_clip:
                clips.append(clips[-1])
        return np.stack([c[0] for c in clips]).astype(np.float32)

    def fbank(self, batch: np.ndarray) -> np.ndarray:
        """[n, samples] at the processor's rate -> [n, target_length,
        mel_bins], computed on the host."""
        from vitlens_tpu_torch.ops.fbank import fbank_fixed_length

        fb = fbank_fixed_length(
            torch.from_numpy(np.ascontiguousarray(batch, np.float32)),
            target_length=self.target_length, mean=self.mean, std=self.std,
            sample_frequency=float(self.sr), num_mel_bins=self.mel_bins)
        return fb.numpy()

    def process_waveform(self, wf: np.ndarray, sr: int,
                         rng: Optional[np.random.RandomState] = None,
                         random_clip: bool = False) -> np.ndarray:
        return self.fbank(self.clips(wf, sr, rng, random_clip))

    def __call__(self, paths) -> np.ndarray:
        from vitlens_tpu_torch.data.audio_decode import load_audio_file

        out = []
        for p in _wrap_list(paths):
            wf, sr = load_audio_file(p)
            out.append(self.process_waveform(wf, sr))
        return np.stack(out)  # [B, n_clip, T, F]


class EEGProcessor:
    """Raw EEG [channels, time] -> crop t[20:460] -> linear resample of each
    channel to 512 samples. Takes arrays and ``.pt`` paths."""

    def __init__(self, time_low: int = 20, time_high: int = 460,
                 data_len: int = 512):
        self.time_low = time_low
        self.time_high = time_high
        self.data_len = data_len

    def process_array(self, eeg: np.ndarray) -> np.ndarray:
        eeg = np.asarray(eeg, np.float32)[:, self.time_low:self.time_high]
        x = np.linspace(0, 1, eeg.shape[-1])
        x2 = np.linspace(0, 1, self.data_len)
        out = np.empty((eeg.shape[0], self.data_len), np.float32)
        for c in range(eeg.shape[0]):
            out[c] = np.interp(x2, x, eeg[c])
        return out

    def __call__(self, paths) -> np.ndarray:
        return np.stack([self.process_array(
            p if isinstance(p, np.ndarray) else _load_pt(p))
            for p in _wrap_list(paths)])


def _video_processor():
    from vitlens_tpu_torch.data.video_processors import VideoProcessor

    return VideoProcessor(train=False)


def default_processors(modalities: Optional[Sequence[str]] = None):
    """{modality: processor} for the given modalities (by default all but
    video, as in JAX)."""
    all_procs = {"image": ImageProcessor, "text": TextProcessor,
                 "pc": PointCloudProcessor, "depth": DepthProcessor,
                 "audio": AudioProcessor, "tactile": TactileProcessor,
                 "eeg": EEGProcessor, "video": _video_processor}
    if modalities is None:
        modalities = [m for m in all_procs if m != "video"]
    return {m: all_procs[m]() for m in modalities}
