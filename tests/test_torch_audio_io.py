"""The port's audio file path on CPU against the JAX package's: WAV and FLAC
decoding (vitlens_tpu_torch/data/audio_decode.py), the resampler and the
host AudioProcessor (vitlens_tpu_torch/data/processors.py), its fbank at
test_torch_fbank's bound. Files are
written here: WAV with ``wave``, FLAC with tools/reference_layout.py's
minimal encoder."""

import numpy as np
import pytest

from tests.test_torch_fbank import assert_close_to_jax
from tools.reference_layout import pcm_from_float, write_flac, write_wav
from vitlens_tpu.data import audio_decode as JD
from vitlens_tpu.data import processors as JP
from vitlens_tpu_torch.data import audio_decode as PD
from vitlens_tpu_torch.data import processors as PP
from tests.test_torch_threads import share_cores

share_cores()


def _signal(rate: int, seconds: float, channels: int, seed: int = 0) -> np.ndarray:
    """A tone over noise 30 dB down, in [-1, 1): float64 [channels, T]."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(rate * seconds)) / rate
    tone = 0.4 * np.sin(2 * np.pi * (330.0 + 110.0 * np.arange(channels))[:, None] * t)
    return tone + 0.013 * rng.randn(channels, t.size)


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_decode_matches_jax(tmp_path, width, channels):
    x = _signal(16000, 0.5, channels)
    pcm = pcm_from_float(x, 8 * width)
    if width == 1:
        pcm = pcm + 128  # 8-bit WAV is unsigned
    path = str(tmp_path / "a.wav")
    write_wav(path, pcm, 16000, width)
    got, sr = PD.decode_wav(path)
    want, want_sr = JD.decode_wav(path)
    assert sr == want_sr == 16000 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.shape == (channels, x.shape[1])
    np.testing.assert_array_equal(PD.load_audio_file(path)[0], want)


@pytest.mark.parametrize("bps", [16, 24])
@pytest.mark.parametrize("subframe,order", [("verbatim", 0), ("fixed", 0),
                                            ("fixed", 2), ("fixed", 4)])
@pytest.mark.parametrize("channels,stereo", [(1, "independent"),
                                             (2, "independent"),
                                             (2, "left_side"), (2, "mid_side")])
def test_flac_decode_exact(tmp_path, bps, subframe, order, channels, stereo):
    """Sample for sample equal to the PCM written and to JAX's decoder;
    blocks of 1152 leave a short last block."""
    x = _signal(16000, 0.3, channels, seed=bps)
    pcm = pcm_from_float(x, bps)
    path = str(tmp_path / "a.flac")
    write_flac(path, pcm, 16000, bps, subframe, order, stereo, block_size=1152)
    got, sr = PD.decode_flac(path)
    want, _ = JD.decode_flac(path)
    assert sr == 16000 and got.shape == pcm.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.round(got.astype(np.float64) * (1 << (bps - 1))).astype(np.int64), pcm)
    np.testing.assert_array_equal(PD.load_audio_file(path)[0], want)


def test_load_audio_file_rejects_other_containers(tmp_path):
    path = tmp_path / "a.ogg"
    path.write_bytes(b"OggS" + bytes(64))
    with pytest.raises(ValueError, match="unsupported audio container"):
        PD.load_audio_file(str(path))


@pytest.mark.parametrize("orig", [44100, 8000, 22050])
def test_resample_matches_jax(orig):
    x = _signal(orig, 0.7, 2).astype(np.float32)
    want = JD.resample(x, orig, 16000)
    got = PD.resample(x, orig, 16000)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert PD.resample(x, 16000, 16000) is x


@pytest.mark.parametrize("spec", [
    ("wav", 16000, 5.0, 1),     # one clip length: three equal clips
    ("wav", 44100, 12.0, 2),    # resampled, three clips on the constant grid
    ("wav", 8000, 1.5, 1),      # shorter than a clip: repeat-padded
    ("flac", 16000, 6.5, 2),    # FLAC, stereo, three overlapping clips
])
def test_audio_processor_matches_jax(tmp_path, spec):
    kind, rate, seconds, channels = spec
    x = _signal(rate, seconds, channels, seed=rate)
    path = str(tmp_path / f"a.{kind}")
    if kind == "wav":
        write_wav(path, pcm_from_float(x, 16), rate, 2)
    else:
        write_flac(path, pcm_from_float(x, 16), rate, 16, "fixed", 2,
                   "mid_side")
    want = JP.AudioProcessor()([path, path])
    got = PP.AudioProcessor()([path, path])
    assert got.shape == want.shape == (2, 3, 512, 128)
    # the bound of test_torch_fbank: 2e-4 in every bin within 70 dB of its
    # frame's loudest (an 8 kHz file resampled to 16 kHz has no energy above
    # 4 kHz, and its top mel bins are fp32 rounding noise in both)
    clips = PP.AudioProcessor().clips(*PD.load_audio_file(path))
    assert_close_to_jax(got[0], want[0], clips)
    np.testing.assert_array_equal(got[1], got[0])


def test_audio_processor_clip_grid_matches_jax():
    """The constant clip grid and the random-clip train path take the same
    samples as JAX's from the same seed."""
    assert PP.constant_clip_timepoints(12.0, 5.0, 3) == \
        JP.constant_clip_timepoints(12.0, 5.0, 3)
    wf = _signal(16000, 9.0, 1).astype(np.float32)
    for s, e in ((None, None), (1.0, 6.0), (8.8, 9.0)):
        np.testing.assert_array_equal(
            PP.audio_get_clip(wf, 16000, 5.0, s, e),
            JP.audio_get_clip(wf, 16000, 5.0, s, e))
    clips = PP.AudioProcessor().clips(wf, 16000, np.random.RandomState(3),
                                      random_clip=True)
    rng = np.random.RandomState(3)
    starts = rng.uniform(0.0, 4.0, size=3)
    want = [JP.audio_get_clip(wf, 16000, 5.0, s, s + 5.0, rng=rng)[0]
            for s in starts]
    np.testing.assert_array_equal(clips, np.stack(want))
