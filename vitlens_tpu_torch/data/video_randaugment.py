"""Video train-time RandAugment on the host, pure numpy (port of
vitlens_tpu/data/video_randaugment.py, a copy: the port imports nothing of
the JAX package).

The op set and the N-of-M clip-level sampling of the reference's
VideoRandomAugment (modal_video/processors/randaugment.py:288-392), which
its lavis video train processor applies with N=2, M=5 over a 10-op list
(vt_processors.py:76-89, :766).

The reference implements the ops with cv2 (LUTs and warpAffine); these are
numpy. The LUT and arithmetic ops (AutoContrast, Equalize, Solarize, Color,
Contrast, Brightness, Posterize) reproduce the reference tables, including
its uint8 truncation on ``.astype``, except AutoContrast, which keeps the
PIL.ImageOps.autocontrast semantics the reference's docstring claims (its
``offset = -low * scale`` wraps the uint8 ``low``). The geometric ops
(Rotate, ShearX/Y, TranslateX/Y) re-derive cv2.warpAffine's inverse-map
bilinear sampling with a constant (128, 128, 128) border in float
arithmetic, within +-1/255 of cv2's 5-bit fixed point. Sharpness
reproduces cv2.filter2D's REFLECT_101 border and round-half-to-even
(np.rint).

Clip semantics (randaugment.py:363-384): ONE op list (N drawn without
replacement, at level M) and ONE keep-mask (each op kept with probability
1-p, p=0.0 by default) a clip, applied to every frame; the level -> args
mapping re-rolls per frame, so the sign of a shear, translate or rotate can
differ from frame to frame.

Every function takes and returns uint8 [H, W, 3] arrays (clips: uint8 [T, H,
W, 3]).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

FILL: Tuple[int, int, int] = (128, 128, 128)   # randaugment.py:307
MAX_LEVEL = 10                                 # randaugment.py:306
TRANSLATE_CONST = 10                           # randaugment.py:305

# the reference lavis video train processor's op list (vt_processors.py:78-89)
VIDEO_TRAIN_AUG_LIST = (
    "Identity", "AutoContrast", "Brightness", "Sharpness", "Equalize",
    "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
)


# ---------------------------------------------------------------------------
# per-op functions (uint8 HWC -> uint8 HWC)
# ---------------------------------------------------------------------------

def identity(img: np.ndarray) -> np.ndarray:
    return img


def _lut(table: np.ndarray, img: np.ndarray) -> np.ndarray:
    # reference tables end in .clip(0,255).astype(np.uint8): truncation, not
    # rounding — keep that exact behaviour
    return np.clip(table, 0, 255).astype(np.uint8)[img]


def autocontrast(img: np.ndarray, cutoff: int = 0) -> np.ndarray:
    """Per-channel linear stretch to [0,255] (randaugment.py:19-49)."""
    out = np.empty_like(img)
    for c in range(img.shape[2]):
        ch = img[..., c]
        if cutoff == 0:
            low, high = int(ch.min()), int(ch.max())
        else:
            cut = cutoff * ch.size // 100
            hist = np.bincount(ch.ravel(), minlength=256)
            lo_nz = np.nonzero(np.cumsum(hist) > cut)[0]
            low = int(lo_nz[0]) if lo_nz.size else 0
            hi_nz = np.nonzero(np.cumsum(hist[::-1]) > cut)[0]
            high = 255 - int(hi_nz[0]) if hi_nz.size else 255
        if high <= low:
            table = np.arange(256)
        else:
            scale = 255.0 / (high - low)
            table = np.arange(256) * scale - low * scale
            table[table < 0] = 0
            table[table > 255] = 255
        out[..., c] = _lut(table, ch)
    return out


def equalize(img: np.ndarray) -> np.ndarray:
    """PIL-style histogram equalization (randaugment.py:52-73): step from
    the non-zero histogram, LUT = cumsum//step. float32 to match the
    reference's cv2.calcHist float arithmetic exactly."""
    out = np.empty_like(img)
    for c in range(img.shape[2]):
        ch = img[..., c]
        hist = np.bincount(ch.ravel(), minlength=256).astype(np.float32)
        nz = hist[hist != 0]
        step = np.sum(nz[:-1]) // 255
        if step == 0:
            out[..., c] = ch
            continue
        shifted = np.empty_like(hist)
        shifted[0] = step // 2
        shifted[1:] = hist[:-1]
        out[..., c] = _lut(np.cumsum(shifted) // step, ch)
    return out


def solarize(img: np.ndarray, thresh: int = 128) -> np.ndarray:
    x = np.arange(256)
    return _lut(np.where(x < thresh, x, 255 - x), img)


def posterize(img: np.ndarray, bits: int) -> np.ndarray:
    """Keep the top `bits` bits per channel (randaugment.py:192-197; the
    reference's `255 << (8-bits)` is masked to uint8 here so bits=4 keeps
    0xF0 instead of overflowing)."""
    return img & np.uint8((255 << (8 - bits)) & 0xFF)


def color(img: np.ndarray, factor: float) -> np.ndarray:
    """PIL ImageEnhance.Color as one channel-mixing matmul
    (randaugment.py:97-112): blend toward the BT.601 luma replicated to all
    channels (the reference weights assume BGR channel order; preserved)."""
    luma = np.float32([0.114, 0.587, 0.299])
    mix = (np.eye(3, dtype=np.float32) - luma[:, None]) * np.float32(factor) \
        + luma[:, None]
    return np.clip(img @ mix, 0, 255).astype(np.uint8)


def contrast(img: np.ndarray, factor: float) -> np.ndarray:
    mean = np.sum(np.mean(img, axis=(0, 1)) * np.array([0.114, 0.587, 0.299]))
    return _lut((np.arange(256) - mean) * factor + mean, img)


def brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return _lut(np.arange(256, dtype=np.float32) * factor, img)


def sharpness(img: np.ndarray, factor: float) -> np.ndarray:
    """Blend toward a 3x3 smoothing kernel (ones, center 5, /13) applied with
    a REFLECT_101 border (randaugment.py:138-156). Interior blend matches
    the reference bit-for-bit given equal kernel outputs; np.rint reproduces
    cv2's round-half-to-even."""
    kernel = np.ones((3, 3), np.float32)
    kernel[1, 1] = 5.0
    kernel /= 13.0
    padded = np.pad(img.astype(np.float32), ((1, 1), (1, 1), (0, 0)),
                    mode="reflect")
    acc = np.zeros(img.shape, np.float32)
    for dy in range(3):
        for dx in range(3):
            acc += kernel[dy, dx] * padded[dy:dy + img.shape[0],
                                           dx:dx + img.shape[1]]
    degenerate = np.clip(np.rint(acc), 0, 255)
    if factor == 0.0:
        return degenerate.astype(np.uint8)
    if factor == 1.0:
        return img
    out = img.astype(np.float32)
    inner = degenerate[1:-1, 1:-1, :]
    out[1:-1, 1:-1, :] = inner + factor * (out[1:-1, 1:-1, :] - inner)
    return out.astype(np.uint8)


def _warp_affine(img: np.ndarray, fwd: np.ndarray,
                 fill: Sequence[int]) -> np.ndarray:
    """cv2.warpAffine(img, fwd) equivalent: invert the 2x3 forward map, then
    bilinear-sample src at inv@[x,y,1] per dst pixel, blending per-tap with
    the constant border colour exactly as BORDER_CONSTANT does."""
    h, w = img.shape[:2]
    a, b, c, d, e, f = np.asarray(fwd, np.float64).ravel()
    det = a * e - b * d
    ia, ib = e / det, -b / det
    id_, ie = -d / det, a / det
    ic = -(ia * c + ib * f)
    if_ = -(id_ * c + ie * f)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    sx = ia * xs + ib * ys + ic
    sy = id_ * xs + ie * ys + if_
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = (sx - x0)[..., None].astype(np.float32)
    fy = (sy - y0)[..., None].astype(np.float32)
    fillv = np.asarray(fill, np.float32)
    src = img.astype(np.float32)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        vals = src[yi.clip(0, h - 1), xi.clip(0, w - 1)]
        return np.where(valid[..., None], vals, fillv)

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return np.clip(np.rint(top * (1 - fy) + bot * fy), 0, 255).astype(np.uint8)


def rotate(img: np.ndarray, degrees: float,
           fill: Sequence[int] = FILL) -> np.ndarray:
    """Rotate about the image center, +degrees = counter-clockwise
    (cv2.getRotationMatrix2D convention, randaugment.py:76-84)."""
    h, w = img.shape[:2]
    cx, cy = w / 2.0, h / 2.0
    al = np.cos(np.deg2rad(degrees))
    be = np.sin(np.deg2rad(degrees))
    fwd = np.array([[al, be, (1 - al) * cx - be * cy],
                    [-be, al, be * cx + (1 - al) * cy]])
    return _warp_affine(img, fwd, fill)


def shear_x(img: np.ndarray, factor: float,
            fill: Sequence[int] = FILL) -> np.ndarray:
    return _warp_affine(img, np.array([[1.0, factor, 0.0],
                                       [0.0, 1.0, 0.0]]), fill)


def shear_y(img: np.ndarray, factor: float,
            fill: Sequence[int] = FILL) -> np.ndarray:
    return _warp_affine(img, np.array([[1.0, 0.0, 0.0],
                                       [factor, 1.0, 0.0]]), fill)


def translate_x(img: np.ndarray, offset: float,
                fill: Sequence[int] = FILL) -> np.ndarray:
    return _warp_affine(img, np.array([[1.0, 0.0, -offset],
                                       [0.0, 1.0, 0.0]]), fill)


def translate_y(img: np.ndarray, offset: float,
                fill: Sequence[int] = FILL) -> np.ndarray:
    return _warp_affine(img, np.array([[1.0, 0.0, 0.0],
                                       [0.0, 1.0, -offset]]), fill)


# ---------------------------------------------------------------------------
# level -> args (randaugment.py:223-285) + dispatch
# ---------------------------------------------------------------------------

def _signed(mag: float, rng, flip_if_greater: bool) -> float:
    """Reference sign rolls: shear/translate negate when rand()>0.5,
    rotate negates when rand()<0.5 (randaugment.py:233/244/281)."""
    r = rng.rand()
    if (r > 0.5) if flip_if_greater else (r < 0.5):
        return -mag
    return mag


def apply_op(name: str, img: np.ndarray, level: float, rng) -> np.ndarray:
    """Apply one named op at `level` (args re-rolled per call, matching the
    reference's per-frame arg_dict invocation, randaugment.py:386-392)."""
    frac = level / MAX_LEVEL
    if name == "Identity":
        return identity(img)
    if name == "AutoContrast":
        return autocontrast(img)
    if name == "Equalize":
        return equalize(img)
    if name == "Rotate":
        return rotate(img, _signed(frac * 30.0, rng, flip_if_greater=False))
    if name == "Solarize":
        return solarize(img, int(frac * 256))
    if name == "Color":
        return color(img, frac * 1.8 + 0.1)
    if name == "Contrast":
        return contrast(img, frac * 1.8 + 0.1)
    if name == "Brightness":
        return brightness(img, frac * 1.8 + 0.1)
    if name == "Sharpness":
        return sharpness(img, frac * 1.8 + 0.1)
    if name == "ShearX":
        return shear_x(img, _signed(frac * 0.3, rng, flip_if_greater=True))
    if name == "ShearY":
        return shear_y(img, _signed(frac * 0.3, rng, flip_if_greater=True))
    if name == "TranslateX":
        return translate_x(
            img, _signed(frac * TRANSLATE_CONST, rng, flip_if_greater=True))
    if name == "TranslateY":
        return translate_y(
            img, _signed(frac * TRANSLATE_CONST, rng, flip_if_greater=True))
    if name == "Posterize":
        return posterize(img, int(frac * 4))
    raise ValueError(f"unknown RandAugment op {name!r}")


OP_NAMES = (
    "Identity", "AutoContrast", "Equalize", "Rotate", "Solarize", "Color",
    "Contrast", "Brightness", "Sharpness", "ShearX", "TranslateX",
    "TranslateY", "Posterize", "ShearY",
)


class VideoRandAugment:
    """N-of-M RandAugment over a clip (randaugment.py:352-392).

    One op list (N distinct ops at level M) and one keep-mask (each op kept
    with prob 1-p) per clip; applied to every frame with per-frame arg
    re-rolls. Frames: uint8 [T, H, W, 3] -> uint8 [T, H, W, 3].
    """

    def __init__(self, n: int = 2, m: float = 5, p: float = 0.0,
                 aug_list: Optional[Sequence[str]] = None):
        self.n = int(n)
        self.m = float(m)
        self.p = float(p)
        self.aug_list = tuple(aug_list) if aug_list else OP_NAMES
        for name in self.aug_list:
            if name not in OP_NAMES:
                raise ValueError(f"unknown RandAugment op {name!r}")

    def __call__(self, frames: np.ndarray, rng) -> np.ndarray:
        if frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(
                f"expected uint8 [T,H,W,3] frames, got {frames.shape}")
        idx = rng.choice(len(self.aug_list), size=self.n, replace=False)
        keep = rng.rand(self.n) > self.p
        out = []
        for frame in frames:
            img = frame
            for j, oi in enumerate(idx):
                if not keep[j]:
                    continue
                img = apply_op(self.aug_list[oi], img, self.m, rng)
            out.append(img)
        return np.stack(out)
