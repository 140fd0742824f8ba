"""Training-time augmentations on the host, numpy and PIL (port of
vitlens_tpu/data/augment.py, a copy: the port imports nothing of the JAX
package).

Mirrors the reference semantics with an explicit ``RandomState``:
  * point-cloud augs (modal_3d/datasets.py:97-211): y-axis rotation,
    point dropout, per-cloud scale/shift, per-point jitter, small-angle
    perturbation
  * audio SpecAug (modal_audio/processors/at_processor.py:336-362):
    frequency/time masking + noise + time roll on fbank
  * image train transform: RandomResizedCrop(scale=(0.9, 1.0), bicubic)
    (open_clip/transform.py:73-155)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
from PIL import Image

from vitlens_tpu_torch.config import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD


# -- point cloud ------------------------------------------------------------


def rotate_point_cloud_y(pc: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """[N,3] rotation about the up (y) axis."""
    a = rng.uniform() * 2 * np.pi
    c, s = np.cos(a), np.sin(a)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return pc @ rot


def random_point_dropout(pc: np.ndarray, rng: np.random.RandomState,
                         max_dropout_ratio: float = 0.875) -> np.ndarray:
    ratio = rng.random_sample() * max_dropout_ratio
    drop = rng.random_sample(pc.shape[0]) <= ratio
    out = pc.copy()
    out[drop] = pc[0]
    return out


def random_scale(pc: np.ndarray, rng, lo=0.8, hi=1.25) -> np.ndarray:
    return pc * rng.uniform(lo, hi)


def random_shift(pc: np.ndarray, rng, rng_shift=0.1) -> np.ndarray:
    return pc + rng.uniform(-rng_shift, rng_shift, (1, 3)).astype(pc.dtype)


def jitter(pc: np.ndarray, rng, sigma=0.01, clip=0.05) -> np.ndarray:
    return pc + np.clip(sigma * rng.randn(*pc.shape), -clip, clip).astype(pc.dtype)


def rotate_perturbation(pc: np.ndarray, rng, angle_sigma=0.06,
                        angle_clip=0.18) -> np.ndarray:
    a = np.clip(angle_sigma * rng.randn(3), -angle_clip, angle_clip)
    cx, sx = np.cos(a[0]), np.sin(a[0])
    cy, sy = np.cos(a[1]), np.sin(a[1])
    cz, sz = np.cos(a[2]), np.sin(a[2])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    # reference right-multiplies the UNtransposed composite: pc @ (Rz@Ry@Rx)
    # (modal_3d/datasets.py:201-203); a .T here would apply the inverse
    # rotation and break seeded parity with the reference aug chain
    return (pc @ (rz @ ry @ rx).astype(np.float32))


def train_point_transform(pc: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Standard ULIP-style train aug chain (dropout -> scale -> shift)."""
    pc = random_point_dropout(pc, rng)
    pc = random_scale(pc, rng)
    pc = random_shift(pc, rng)
    return pc.astype(np.float32)


# -- audio spec aug ---------------------------------------------------------


def spec_augment(fbank: np.ndarray, rng: np.random.RandomState,
                 freq_mask: int = 48, time_mask: int = 192,
                 noise: bool = True, roll: bool = True,
                 mask_value: float = 0.0) -> np.ndarray:
    """fbank [T, F] -> masked/noised/rolled. Mirrors the reference train
    transform (at_processor.py:336-362): FrequencyMasking/TimeMasking on the
    [F, T] view, then uniform noise scaled by U(0,1)/10, then time roll in
    [-10, 10) frames.

    mask_value: the reference masks the RAW fbank to 0 BEFORE Normalize,
    so on an already-normalized fbank (our on-device pipeline normalizes
    inside fbank_fixed_length) callers must pass the post-norm zero,
    (0 - mean) / std — e.g. +0.934 for the AST stats — or masked bins
    land at the dataset mean instead of the reference's constant."""
    out = fbank.copy()
    T, F = out.shape
    if freq_mask > 0:
        f = rng.randint(0, freq_mask + 1)
        f0 = rng.randint(0, max(F - f, 1))
        out[:, f0:f0 + f] = mask_value
    if time_mask > 0:
        t = rng.randint(0, time_mask + 1)
        t0 = rng.randint(0, max(T - t, 1))
        out[t0:t0 + t, :] = mask_value
    if noise:
        out = out + (rng.random_sample((T, F)).astype(out.dtype)
                     * (rng.random_sample() / 10.0))
    if roll:
        out = np.roll(out, rng.randint(-10, 10), axis=0)
    return out


def waveform_mixup(wf_a: np.ndarray, wf_b: np.ndarray,
                   rng: np.random.RandomState,
                   alpha: float = 10.0) -> Tuple[np.ndarray, float]:
    """AudioSet waveform mixup with Beta(10,10) (modal_audio/datasets.py
    audio_mix_up)."""
    lam = rng.beta(alpha, alpha)
    n = min(wf_a.shape[-1], wf_b.shape[-1])
    mixed = lam * wf_a[..., :n] + (1 - lam) * wf_b[..., :n]
    mixed = mixed - mixed.mean()
    return mixed.astype(np.float32), float(lam)


# -- image train transform --------------------------------------------------


@dataclass
class AugmentationCfg:
    """Mirror of the reference AugmentationCfg (open_clip/transform.py:22-30).

    `use_timm=False` -> plain RandomResizedCrop(scale) like the reference
    default branch. `use_timm=True` mirrors what the reference's
    timm.data.create_transform call actually enables (transform.py:102-121:
    hflip=0, re_mode='pixel', interpolation defaulting to 'random',
    color_jitter disabled by default, and NO auto-augment — AugmentationCfg
    carries no aa field): RRC with randomly alternating bicubic/bilinear,
    optional color jitter, and per-pixel-noise random erasing."""

    scale: Tuple[float, float] = (0.9, 1.0)
    ratio: Optional[Tuple[float, float]] = None
    color_jitter: Optional[object] = None  # float or (b, c, s)
    interpolation: Optional[str] = None    # None/'random'|'bicubic'|'bilinear'
    re_prob: Optional[float] = None
    re_count: Optional[int] = None
    use_timm: bool = False


_PIL_INTERP = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR}


def random_resized_crop_params(w: int, h: int, rng: np.random.RandomState,
                               scale=(0.9, 1.0), ratio=(3 / 4, 4 / 3)):
    """Sample one (left, top, cw, ch) crop box (torchvision
    RandomResizedCrop.get_params semantics). Split out so video can apply
    ONE box to every frame of a clip (reference RandomResizedCropVideo,
    transforms_video.py)."""
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(rng.uniform(*log_ratio))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = rng.randint(0, w - cw + 1)
            top = rng.randint(0, h - ch + 1)
            return left, top, cw, ch
    # fallback: center crop
    m = min(w, h)
    return (w - m) // 2, (h - m) // 2, m, m


def random_resized_crop(img: Image.Image, rng: np.random.RandomState,
                        size: int = 224, scale=(0.9, 1.0),
                        ratio=(3 / 4, 4 / 3),
                        interpolation=Image.BICUBIC) -> Image.Image:
    w, h = img.size
    left, top, cw, ch = random_resized_crop_params(w, h, rng, scale, ratio)
    return img.resize((size, size), interpolation,
                      box=(left, top, left + cw, top + ch))


def color_jitter_pil(img: Image.Image, rng: np.random.RandomState,
                     strength) -> Image.Image:
    """torchvision ColorJitter semantics for (brightness, contrast,
    saturation): factor ~ U[max(0, 1-v), 1+v], applied in random order.
    A scalar strength applies to all three (timm create_transform)."""
    from PIL import ImageEnhance

    if np.isscalar(strength):
        strength = (strength, strength, strength)
    enhancers = [ImageEnhance.Brightness, ImageEnhance.Contrast,
                 ImageEnhance.Color]
    order = rng.permutation(3)
    for i in order:
        v = float(strength[i])
        if v <= 0:
            continue
        factor = rng.uniform(max(0.0, 1.0 - v), 1.0 + v)
        img = enhancers[i](img).enhance(factor)
    return img


def random_erasing(arr: np.ndarray, rng: np.random.RandomState,
                   prob: float, count: int = 1,
                   area_range=(0.02, 1 / 3), min_aspect: float = 0.3,
                   ) -> np.ndarray:
    """timm RandomErasing, re_mode='pixel' (the reference's fixed choice,
    transform.py:119): with probability `prob`, erase `count` rectangles
    (each 0.02..1/3 of image area / count, log-uniform aspect) filling with
    per-pixel standard-normal noise. arr is normalized CHW."""
    if rng.rand() >= prob:
        return arr
    arr = arr.copy()
    _, h, w = arr.shape
    log_ar = (np.log(min_aspect), np.log(1.0 / min_aspect))
    for _ in range(max(1, count)):
        for _attempt in range(10):
            target = rng.uniform(*area_range) * h * w / max(1, count)
            aspect = np.exp(rng.uniform(*log_ar))
            eh = int(round(np.sqrt(target * aspect)))
            ew = int(round(np.sqrt(target / aspect)))
            if 0 < eh < h and 0 < ew < w:
                top = rng.randint(0, h - eh + 1)
                left = rng.randint(0, w - ew + 1)
                arr[:, top:top + eh, left:left + ew] = rng.randn(
                    arr.shape[0], eh, ew).astype(arr.dtype)
                break
    return arr


def train_image_transform(img: Image.Image, rng: np.random.RandomState,
                          size: int = 224, mean=None, std=None,
                          aug: Optional[AugmentationCfg] = None) -> np.ndarray:
    mean = mean or OPENAI_DATASET_MEAN
    std = std or OPENAI_DATASET_STD
    aug = aug or AugmentationCfg()

    interp = Image.BICUBIC
    if aug.use_timm:
        name = aug.interpolation or "random"
        if name == "random":
            interp = _PIL_INTERP[("bicubic", "bilinear")[rng.randint(2)]]
        else:
            interp = _PIL_INTERP[name]
    img = random_resized_crop(img.convert("RGB"), rng, size,
                              scale=tuple(aug.scale),
                              ratio=tuple(aug.ratio or (3 / 4, 4 / 3)),
                              interpolation=interp)
    if aug.use_timm and aug.color_jitter:
        img = color_jitter_pil(img, rng, aug.color_jitter)
    arr = np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0
    mean = np.asarray(mean, np.float32)[:, None, None]
    stdv = np.asarray(std, np.float32)[:, None, None]
    arr = (arr - mean) / stdv
    if aug.use_timm and aug.re_prob:
        arr = random_erasing(arr, rng, float(aug.re_prob),
                             int(aug.re_count or 1))
    return arr
