"""The port's Kaldi fbank (vitlens_tpu_torch/ops/fbank.py) on CPU against
the JAX package's (vitlens_tpu/ops/fbank.py): the mel bank and the window
exactly equal, the normalised fbank within 2e-4 on noise, a pure tone,
silence, tone bursts, a waveform of exactly one window and short inputs, and
the same ValueError below one window.

Both compute the spectrum in fp32, whose rounding sits about 70 dB below a
frame's loudest bin. A pure tone or a loud burst leaves mel bins far below
that (a Hann window's leakage falls off fast), and there both results are
rounding noise: on a 440/3000 Hz tone the JAX package's own fbank is 3.4e-3
from the float64 fbank in log energy, the port's 2.2e-3. So the 2e-4 bound
holds in every bin within QUIET_NATS of its frame's loudest bin (in the
float64 fbank), and in the bins below it both results are held to the
float64 fbank within FLOOR_TOL."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitlens_tpu.ops import fbank as JF
from vitlens_tpu_torch.ops import fbank as PF
from tests.test_torch_threads import share_cores

share_cores()

ATOL = 2e-4  # on the normalised output ((log e - mean) / std)
MEAN, STD = -4.2677393, 4.5689974  # the AST normalisation: ATOL * STD on log e
QUIET_NATS = 16.0  # ~70 dB below a frame's loudest mel bin
FLOOR_TOL = 1e-2   # log energy, in the bins below that (both read <= 5.3e-3)


def _fbank64(x: np.ndarray) -> np.ndarray:
    """The 16 kHz log-mel of x [N, T] in float64 numpy."""
    win, shift = 400, 160
    nf = 1 + (x.shape[1] - win) // shift
    fr = x.astype(np.float64)[:, np.arange(nf)[:, None] * shift + np.arange(win)]
    fr = fr - fr.mean(-1, keepdims=True)
    fr = fr - 0.97 * np.concatenate([fr[..., :1], fr[..., :-1]], -1)
    fr = fr * JF._hann(win).astype(np.float64)
    power = np.abs(np.fft.rfft(fr, n=512, axis=-1))[..., :256] ** 2
    e = power @ JF.mel_filterbank(128, 512, 16000.0).astype(np.float64).T
    return np.log(np.maximum(e, JF.EPS_F32))


def assert_close_to_jax(got: np.ndarray, want: np.ndarray, x: np.ndarray):
    """got, want: normalised fbanks [N, target_length, mel] of the 16 kHz
    waveforms x [N, T]: within ATOL in every bin within QUIET_NATS of its
    frame's loudest bin, and both within FLOOR_TOL of the float64 fbank in
    log energy below that."""
    exact = _fbank64(x)
    frames = min(exact.shape[1], want.shape[1])
    exact = exact[:, :frames]
    loud = np.ones(want.shape, bool)
    loud[:, :frames] = exact > exact.max(-1, keepdims=True) - QUIET_NATS
    np.testing.assert_allclose(got[loud], want[loud], atol=ATOL, rtol=0)
    for out in (got, want):  # the quiet bins: rounding noise in both
        quiet = (out[:, :frames] * STD + MEAN)[~loud[:, :frames]]
        np.testing.assert_allclose(quiet, exact[~loud[:, :frames]],
                                   atol=FLOOR_TOL, rtol=0)


def _wave(kind: str, n: int, batch: int = 2, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    if kind == "noise":
        return (0.1 * rng.randn(batch, n)).astype(np.float32)
    if kind == "tone":
        f = np.array([440.0, 3000.0])[:batch, None]
        return (0.5 * np.sin(2 * np.pi * f * t)).astype(np.float32)
    if kind == "silence":
        return np.zeros((batch, n), np.float32)
    if kind == "bursts":  # tone bursts over low noise: a wide dynamic range
        env = (np.sin(2 * np.pi * 3 * t) > 0).astype(np.float32)
        x = env * np.sin(2 * np.pi * 700 * t) + 1e-4 * rng.randn(batch, n)
        return x.astype(np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("args", [(128, 512, 16000.0), (80, 400, 8000.0),
                                  (64, 1024, 44100.0, 50.0, -200.0)])
def test_mel_filterbank_and_window_exact(args):
    np.testing.assert_array_equal(PF.mel_filterbank(*args),
                                  JF.mel_filterbank(*args))
    for win in (400, 200, 1102):
        np.testing.assert_array_equal(PF._hann(win), JF._hann(win))


@pytest.mark.parametrize("kind", ["noise", "tone", "silence", "bursts"])
@pytest.mark.parametrize("n", [80000, 400, 400 + 160 * 7 + 33])
def test_fbank_fixed_length_matches_jax(kind, n):
    """T = 5 s, exactly one 25 ms window, and a few frames plus a ragged
    tail (zero-padded to 512 frames)."""
    x = _wave(kind, n)
    want = np.asarray(JF.fbank_fixed_length(jnp.asarray(x)))
    got = PF.fbank_fixed_length(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 512, 128)
    assert_close_to_jax(got.numpy(), want, x)
    if kind == "noise":  # no bin is quiet: the bound holds everywhere
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    if kind == "silence":  # every bin at exactly the log floor
        raw = PF.fbank(torch.from_numpy(x))
        assert torch.all(raw == torch.log(torch.tensor(PF.EPS_F32)))


@pytest.mark.parametrize("kwargs", [{}, {"sample_frequency": 8000.0,
                                         "num_mel_bins": 64},
                                    {"preemphasis": 0.0,
                                     "remove_dc_offset": False}])
def test_fbank_raw_matches_jax(kwargs):
    """The log-mel before the normalisation, [T] and [B, T] inputs, other
    rates and bin counts and the switches off."""
    x = _wave("noise", 24000, batch=3, seed=2)
    want = np.asarray(JF.fbank(jnp.asarray(x), **kwargs))
    got = PF.fbank(torch.from_numpy(x), **kwargs)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL * STD, rtol=0)
    one = PF.fbank(torch.from_numpy(x[1]), **kwargs)
    assert one.dim() == 2
    np.testing.assert_allclose(one.numpy(), want[1], atol=ATOL * STD, rtol=0)


def test_fbank_trims_long_and_keeps_fp32():
    """More frames than target_length are trimmed to the first ones; a bf16
    waveform is computed in fp32."""
    x = _wave("noise", 16000 * 7, batch=1)
    want = np.asarray(JF.fbank_fixed_length(jnp.asarray(x), target_length=300))
    got = PF.fbank_fixed_length(torch.from_numpy(x), target_length=300)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    half = PF.fbank_fixed_length(torch.from_numpy(x).bfloat16())
    assert half.dtype == torch.float32


@pytest.mark.parametrize("n", [0, 1, 399])
def test_short_waveform_raises_like_jax(n):
    x = np.zeros((1, n), np.float32)
    with pytest.raises(ValueError, match="too short") as want:
        JF.fbank(jnp.asarray(x))
    with pytest.raises(ValueError, match="too short") as got:
        PF.fbank(torch.from_numpy(x))
    assert str(got.value) == str(want.value)
