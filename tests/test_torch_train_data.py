"""The port's train-time data transforms against the JAX package's, bit for
bit from the same seeds: the image train transform and TrainImageProcessor,
each video RandAugment op and VideoRandAugment over a clip, the video train
processor on a frame directory, the point-cloud augmentations, SpecAug and
waveform mixup. Images and frames are made in memory from a seed."""

import numpy as np
import pytest
from PIL import Image

from vitlens_tpu.data import augment as JA
from vitlens_tpu.data import processors as JP
from vitlens_tpu.data import video_processors as JV
from vitlens_tpu.data import video_randaugment as JR
from vitlens_tpu_torch.data import augment as PA
from vitlens_tpu_torch.data import processors as PP
from vitlens_tpu_torch.data import video_processors as PV
from vitlens_tpu_torch.data import video_randaugment as PR
from tests.test_torch_threads import share_cores

share_cores()


def _rgb(seed, w=96, h=72):
    """A smooth gradient plus noise, so that crops, resizes and the LUT ops
    all see varied values."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 / w, yy * 255 / h, (xx + yy) * 127 / (w + h)], -1)
    return np.clip(base + rng.randint(-40, 40, size=(h, w, 3)), 0, 255).astype(np.uint8)


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- images ----------------------------------------------------------------------

AUGS = {
    "default": {},
    "timm": dict(use_timm=True, color_jitter=0.4, re_prob=1.0, re_count=2),
    "timm_bilinear": dict(use_timm=True, interpolation="bilinear",
                          color_jitter=(0.2, 0.0, 0.3), re_prob=0.5),
    "scale_ratio": dict(scale=(0.3, 1.0), ratio=(0.5, 2.0)),
}


@pytest.mark.parametrize("aug", list(AUGS))
def test_train_image_transform_is_jax_bit_for_bit(aug):
    """Five images in a row from one RandomState each side: the crop box,
    the interpolation draw, the colour jitter and the erasing all consume
    the same stream."""
    ja, pa = JA.AugmentationCfg(**AUGS[aug]), PA.AugmentationCfg(**AUGS[aug])
    jr, pr = np.random.RandomState(11), np.random.RandomState(11)
    for i in range(5):
        img = Image.fromarray(_rgb(i, 96 + 8 * i, 72))
        _same(PA.train_image_transform(img, pr, 32, aug=pa),
              JA.train_image_transform(img, jr, 32, aug=ja))


def test_train_image_processor_is_jax_bit_for_bit():
    """TrainImageProcessor from a seed and an aug dict, over PIL images."""
    cfg = dict(use_timm=True, color_jitter=0.3, re_prob=0.5)
    imgs = [Image.fromarray(_rgb(i)) for i in range(4)]
    want = JP.TrainImageProcessor(image_size=40, aug_cfg=cfg, seed=5)
    got = PP.TrainImageProcessor(image_size=40, aug_cfg=cfg, seed=5)
    for _ in range(2):
        _same(got(imgs), want(imgs))


def test_crop_and_erasing_pieces_are_jax_bit_for_bit():
    for seed in range(4):
        assert (PA.random_resized_crop_params(120, 80, np.random.RandomState(seed),
                                              scale=(0.05, 0.2))
                == JA.random_resized_crop_params(120, 80,
                                                 np.random.RandomState(seed),
                                                 scale=(0.05, 0.2)))
    arr = np.random.RandomState(1).randn(3, 24, 24).astype(np.float32)
    _same(PA.random_erasing(arr, np.random.RandomState(2), 1.0, 3),
          JA.random_erasing(arr, np.random.RandomState(2), 1.0, 3))
    img = Image.fromarray(_rgb(3))
    _same(np.asarray(PA.color_jitter_pil(img, np.random.RandomState(4), 0.5)),
          np.asarray(JA.color_jitter_pil(img, np.random.RandomState(4), 0.5)))


# -- video -----------------------------------------------------------------------

@pytest.mark.parametrize("op", JR.OP_NAMES)
def test_randaugment_op_is_jax_bit_for_bit(op):
    """Each of the 14 ops at three levels on one frame; the sign draws of
    the geometric ops come from the same RandomState."""
    frame = _rgb(7, 40, 32)
    assert op in PR.OP_NAMES
    for level in (1.0, 5.0, 9.0):
        jr, pr = np.random.RandomState(int(level)), np.random.RandomState(int(level))
        _same(PR.apply_op(op, frame, level, pr), JR.apply_op(op, frame, level, jr))


def test_warp_affine_is_jax_bit_for_bit():
    frame = _rgb(8, 30, 20)
    fwd = np.array([[0.9, 0.2, 3.0], [-0.1, 1.1, -2.0]])
    _same(PR._warp_affine(frame, fwd, PR.FILL), JR._warp_affine(frame, fwd, JR.FILL))


@pytest.mark.parametrize("n,m,p,aug_list", [
    (2, 5.0, 0.0, JR.VIDEO_TRAIN_AUG_LIST), (3, 9.0, 0.3, None)])
def test_video_randaugment_is_jax_bit_for_bit(n, m, p, aug_list):
    """One op list and keep-mask a clip, per-frame argument draws; four
    clips in a row from one stream."""
    clip = np.stack([_rgb(10 + t, 40, 32) for t in range(5)])
    jr, pr = np.random.RandomState(3), np.random.RandomState(3)
    want = JR.VideoRandAugment(n, m, p, aug_list)
    got = PR.VideoRandAugment(n, m, p, aug_list)
    for _ in range(4):
        _same(got(clip, pr), want(clip, jr))
    with pytest.raises(ValueError):
        PR.VideoRandAugment(aug_list=("Identity", "Blur"))
    with pytest.raises(ValueError):
        got(clip[0], pr)


def _frame_dir(path, n, w, h):
    path.mkdir()
    for i in range(n):
        Image.fromarray(_rgb(20 + i, w, h)).save(path / f"{i:04d}.png")
    return str(path)


@pytest.mark.parametrize("kw", [{}, dict(rand_aug=False, hflip=False),
                                dict(rand_aug_n=3, rand_aug_m=9.0,
                                     crop_scale=(0.2, 0.6))])
def test_video_train_processor_is_jax_bit_for_bit(tmp_path, kw):
    """VideoProcessor(train=True) on a 12-frame directory and on a frame
    array: jittered frame indices, one crop box and flip coin a clip,
    RandAugment, normalisation; three calls in a row from one seed."""
    d = _frame_dir(tmp_path / "clip", 12, 64, 48)
    arr = np.stack([_rgb(40 + i, 50, 50) for i in range(5)])
    want = JV.VideoProcessor(n_frames=8, size=32, train=True, seed=9, **kw)
    got = PV.VideoProcessor(n_frames=8, size=32, train=True, seed=9, **kw)
    for src in (d, arr, d):
        out = got([src])
        assert out.shape == (1, 8, 3, 32, 32) and out.dtype == np.float32
        _same(out, want([src]))


def test_train_frame_indices_are_jax_bit_for_bit():
    for total, n in ((12, 8), (5, 8), (100, 8), (1, 4)):
        _same(PV.sample_frame_indices(total, n, train=True,
                                      rng=np.random.RandomState(total)),
              JV.sample_frame_indices(total, n, train=True,
                                      rng=np.random.RandomState(total)))


# -- point clouds and audio ----------------------------------------------------------

PC_AUGS = ("rotate_point_cloud_y", "random_point_dropout", "random_scale",
           "random_shift", "jitter", "rotate_perturbation",
           "train_point_transform")


@pytest.mark.parametrize("name", PC_AUGS)
def test_point_augmentations_are_jax_bit_for_bit(name):
    pc = np.random.RandomState(0).randn(500, 3).astype(np.float32)
    for seed in range(3):
        _same(getattr(PA, name)(pc, np.random.RandomState(seed)),
              getattr(JA, name)(pc, np.random.RandomState(seed)))


@pytest.mark.parametrize("kw", [{}, dict(freq_mask=0, noise=False),
                                dict(time_mask=0, roll=False, mask_value=0.934)])
def test_spec_augment_is_jax_bit_for_bit(kw):
    fbank = np.random.RandomState(1).randn(300, 128).astype(np.float32)
    for seed in range(3):
        _same(PA.spec_augment(fbank, np.random.RandomState(seed), **kw),
              JA.spec_augment(fbank, np.random.RandomState(seed), **kw))


def test_waveform_mixup_is_jax_bit_for_bit():
    rng = np.random.RandomState(2)
    a, b = rng.randn(16000).astype(np.float32), rng.randn(12000).astype(np.float32)
    got, lam = PA.waveform_mixup(a, b, np.random.RandomState(3))
    want, jlam = JA.waveform_mixup(a, b, np.random.RandomState(3))
    _same(got, want)
    assert lam == jlam
