"""Kaldi-compatible log-mel filterbank (port of vitlens_tpu/ops/fbank.py).

The same pipeline as torchaudio.compliance.kaldi.fbank with htk_compat=True,
a Hann window, dither 0 and use_energy False:

  frames (25 ms window / 10 ms shift, snip_edges) -> remove DC offset ->
  preemphasis 0.97 (replicated first sample) -> Hann window (periodic=False)
  -> zero-pad to a power-of-two FFT -> power spectrum -> triangular mel bank
  (mel = 1127 ln(1 + f/700), low 20 Hz, high Nyquist) -> log(max(e, eps)).

Plain PyTorch on the waveform's device, in fp32 whatever the model's compute
dtype: frames are ``Tensor.unfold`` views, the spectrum ``torch.fft.rfft``,
and the mel bank one matmul. The JAX package computes it in ``jnp`` with no
Pallas kernel, so there is no kernel to port here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

EPS_F32 = float(np.finfo(np.float32).eps)  # Kaldi's log floor


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@functools.lru_cache(maxsize=8)
def mel_filterbank(num_bins: int, padded_window: int, sample_freq: float,
                   low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """Kaldi MelBanks weights, [num_bins, padded_window // 2]."""
    if high_freq <= 0.0:
        high_freq = sample_freq / 2 + high_freq
    num_fft_bins = padded_window // 2

    def mel(f):
        return 1127.0 * np.log(1.0 + f / 700.0)

    mel_low, mel_high = mel(low_freq), mel(high_freq)
    delta = (mel_high - mel_low) / (num_bins + 1)
    fft_bin_width = sample_freq / padded_window
    freqs = mel(fft_bin_width * np.arange(num_fft_bins))  # [F]

    left = mel_low + np.arange(num_bins)[:, None] * delta
    center = left + delta
    right = center + delta
    up = (freqs[None, :] - left) / delta
    down = (right - freqs[None, :]) / delta
    return np.maximum(0.0, np.minimum(up, down)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _hann(window_size: int) -> np.ndarray:
    n = np.arange(window_size)
    return (0.5 - 0.5 * np.cos(2 * np.pi * n / (window_size - 1))).astype(np.float32)


def fbank(waveform: torch.Tensor, sample_frequency: float = 16000.0,
          num_mel_bins: int = 128, frame_length_ms: float = 25.0,
          frame_shift_ms: float = 10.0, preemphasis: float = 0.97,
          remove_dc_offset: bool = True, low_freq: float = 20.0,
          high_freq: float = 0.0) -> torch.Tensor:
    """waveform [T] or [B, T] -> log-mel [frames, mel] or [B, frames, mel],
    fp32, on the waveform's device."""
    squeeze = waveform.dim() == 1
    if squeeze:
        waveform = waveform[None]
    T = waveform.shape[1]
    win = int(sample_frequency * frame_length_ms / 1000)
    shift = int(sample_frequency * frame_shift_ms / 1000)
    padded = _next_pow2(win)
    num_frames = 1 + (T - win) // shift  # snip_edges=True
    if num_frames <= 0:
        # torchaudio's kaldi.fbank raises here too: a [B, 0, mel] result
        # would let fbank_fixed_length pad a truncated clip into a constant
        # feature map that the model then encodes
        raise ValueError(
            f"waveform too short for one {frame_length_ms:g} ms window: "
            f"T={T} samples < win={win} at {sample_frequency:g} Hz")

    x = waveform.float()
    frames = x[:, :shift * (num_frames - 1) + win].unfold(-1, win, shift)
    if remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemphasis * prev
    frames = frames * torch.from_numpy(_hann(win)).to(x.device)

    frames = F.pad(frames, (0, padded - win))
    spec = torch.fft.rfft(frames, dim=-1)
    power = spec.real.square() + spec.imag.square()  # [B, frames, padded/2+1]
    power = power[..., : padded // 2]  # the mel bank covers bins [0, N/2)

    weights = torch.from_numpy(mel_filterbank(
        num_mel_bins, padded, sample_frequency, low_freq, high_freq)).to(x.device)
    energies = power @ weights.T  # [B, frames, mel]
    out = torch.log(energies.clamp_min(EPS_F32))
    return out[0] if squeeze else out


def fbank_fixed_length(waveform: torch.Tensor, target_length: int = 512,
                       mean: float = -4.2677393, std: float = 4.5689974,
                       **kwargs) -> torch.Tensor:
    """fbank, then zero-pad the tail or trim to ``target_length`` frames, then
    the AST normalisation (x - mean) / std."""
    fb = fbank(waveform, **kwargs)
    squeeze = fb.dim() == 2
    if squeeze:
        fb = fb[None]
    n = fb.shape[1]
    if n < target_length:
        fb = F.pad(fb, (0, 0, 0, target_length - n))
    elif n > target_length:
        fb = fb[:, :target_length]
    fb = (fb - mean) / std
    return fb[0] if squeeze else fb
