"""Audio file decoding without an audio library (port of
vitlens_tpu/data/audio_decode.py), numpy and the stdlib ``wave`` only:

  * WAV: stdlib ``wave`` (8-, 16- and 32-bit PCM)
  * FLAC: the native host library (``data/native.py``) in
    :func:`load_audio_file`, and a minimal pure-Python decoder, its plain
    version (constant, verbatim, fixed and LPC subframes, every standard
    block size, 8- to 32-bit, mono and stereo with left/right/mid-side
    decorrelation).

Also windowed-sinc polyphase resampling equal to
torchaudio.functional.resample's default (Hann-windowed sinc,
lowpass_filter_width=6).
"""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Bit reader
# ---------------------------------------------------------------------------


class _BitReader:
    __slots__ = ("data", "pos", "bitbuf", "bitcnt")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.bitbuf = 0
        self.bitcnt = 0

    def read_uint(self, n: int) -> int:
        while self.bitcnt < n:
            self.bitbuf = (self.bitbuf << 8) | self.data[self.pos]
            self.pos += 1
            self.bitcnt += 8
        self.bitcnt -= n
        val = (self.bitbuf >> self.bitcnt) & ((1 << n) - 1)
        self.bitbuf &= (1 << self.bitcnt) - 1
        return val

    def read_sint(self, n: int) -> int:
        v = self.read_uint(n)
        if v >= 1 << (n - 1):
            v -= 1 << n
        return v

    def read_unary(self) -> int:
        c = 0
        while self.read_uint(1) == 0:
            c += 1
        return c

    def read_rice(self, param: int) -> int:
        q = self.read_unary()
        r = self.read_uint(param) if param else 0
        v = (q << param) | r
        return (v >> 1) ^ -(v & 1)  # zigzag

    def align(self):
        self.bitcnt = 0
        self.bitbuf = 0

    def read_utf8_coded(self) -> int:
        b0 = self.read_uint(8)
        if b0 < 0x80:
            return b0
        n = 0
        while (b0 << n) & 0x80:
            n += 1
        val = b0 & (0x7F >> n)
        for _ in range(n - 1):
            val = (val << 6) | (self.read_uint(8) & 0x3F)
        return val


_FIXED_COEFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def _decode_residual(br: _BitReader, block_size: int, order: int) -> np.ndarray:
    method = br.read_uint(2)
    if method > 1:
        raise ValueError(f"bad residual method {method}")
    param_bits = 4 + method
    escape = (1 << param_bits) - 1
    part_order = br.read_uint(4)
    n_parts = 1 << part_order
    out = np.empty(block_size - order, dtype=np.int64)
    idx = 0
    for p in range(n_parts):
        count = (block_size >> part_order) - (order if p == 0 else 0)
        param = br.read_uint(param_bits)
        if param == escape:
            nbits = br.read_uint(5)
            for _ in range(count):
                out[idx] = br.read_sint(nbits) if nbits else 0
                idx += 1
        else:
            for _ in range(count):
                out[idx] = br.read_rice(param)
                idx += 1
    return out


def _decode_subframe(br: _BitReader, block_size: int, bps: int) -> np.ndarray:
    if br.read_uint(1) != 0:
        raise ValueError("bad subframe sync")
    stype = br.read_uint(6)
    wasted = 0
    if br.read_uint(1):
        wasted = 1 + br.read_unary()
        bps -= wasted
    if stype == 0:  # constant
        v = br.read_sint(bps)
        out = np.full(block_size, v, dtype=np.int64)
    elif stype == 1:  # verbatim
        out = np.array([br.read_sint(bps) for _ in range(block_size)], np.int64)
    elif 8 <= stype <= 12:  # fixed
        order = stype - 8
        warm = [br.read_sint(bps) for _ in range(order)]
        resid = _decode_residual(br, block_size, order)
        out = np.empty(block_size, dtype=np.int64)
        out[:order] = warm
        coefs = _FIXED_COEFS[order]
        for i in range(order, block_size):
            pred = 0
            for j, c in enumerate(coefs):
                pred += c * out[i - 1 - j]
            out[i] = pred + resid[i - order]
    elif stype >= 32:  # LPC
        order = stype - 31
        warm = [br.read_sint(bps) for _ in range(order)]
        precision = br.read_uint(4) + 1
        shift = br.read_sint(5)
        coefs = [br.read_sint(precision) for _ in range(order)]
        resid = _decode_residual(br, block_size, order)
        out = np.empty(block_size, dtype=np.int64)
        out[:order] = warm
        c = np.array(coefs, dtype=np.int64)
        for i in range(order, block_size):
            pred = int(np.dot(c, out[i - order:i][::-1])) >> shift
            out[i] = pred + resid[i - order]
    else:
        raise ValueError(f"reserved subframe type {stype}")
    if wasted:
        out = out << wasted
    return out


def decode_flac(path: str) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file -> (float32 [channels, samples] in [-1, 1], rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC file")
    pos = 4
    sample_rate = channels = bps = total = None
    while True:
        header = data[pos]
        last = header & 0x80
        btype = header & 0x7F
        length = int.from_bytes(data[pos + 1:pos + 4], "big")
        body = data[pos + 4:pos + 4 + length]
        if btype == 0:  # STREAMINFO
            sr_cc_bps = int.from_bytes(body[10:18], "big")
            sample_rate = sr_cc_bps >> 44
            channels = ((sr_cc_bps >> 41) & 0x7) + 1
            bps = ((sr_cc_bps >> 36) & 0x1F) + 1
            total = sr_cc_bps & ((1 << 36) - 1)
        pos += 4 + length
        if last:
            break
    assert sample_rate and channels, "missing STREAMINFO"

    out = [np.empty(total or 0, dtype=np.int64) for _ in range(channels)]
    chunks = [[] for _ in range(channels)] if not total else None
    written = 0
    br = _BitReader(data, pos)
    n_bytes = len(data)
    while br.pos < n_bytes - 2:
        # frame header
        sync = br.read_uint(14)
        if sync != 0x3FFE:
            raise ValueError(f"lost frame sync at {br.pos}")
        br.read_uint(1)  # reserved
        br.read_uint(1)  # blocking strategy
        bs_code = br.read_uint(4)
        sr_code = br.read_uint(4)
        ch_code = br.read_uint(4)
        bps_code = br.read_uint(3)
        br.read_uint(1)
        br.read_utf8_coded()
        if bs_code == 6:
            block_size = br.read_uint(8) + 1
        elif bs_code == 7:
            block_size = br.read_uint(16) + 1
        elif bs_code == 1:
            block_size = 192
        elif 2 <= bs_code <= 5:
            block_size = 576 << (bs_code - 2)
        else:
            block_size = 256 << (bs_code - 8)
        if sr_code == 12:
            br.read_uint(8)
        elif sr_code in (13, 14):
            br.read_uint(16)
        _bps_tab = {0: bps, 1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}
        fbps = _bps_tab[bps_code]
        br.read_uint(8)  # header CRC

        if ch_code < 8:
            n_ch = ch_code + 1
            subs = [_decode_subframe(br, block_size, fbps) for _ in range(n_ch)]
        elif ch_code == 8:  # left/side
            left = _decode_subframe(br, block_size, fbps)
            side = _decode_subframe(br, block_size, fbps + 1)
            subs = [left, left - side]
        elif ch_code == 9:  # right/side
            side = _decode_subframe(br, block_size, fbps + 1)
            right = _decode_subframe(br, block_size, fbps)
            subs = [right + side, right]
        elif ch_code == 10:  # mid/side
            mid = _decode_subframe(br, block_size, fbps)
            side = _decode_subframe(br, block_size, fbps + 1)
            left = ((mid << 1) | (side & 1)) + side
            subs = [left >> 1, (left >> 1) - side]
        else:
            raise ValueError(f"bad channel code {ch_code}")

        br.align()
        br.read_uint(16)  # frame CRC
        for c in range(channels):
            if total:
                out[c][written:written + block_size] = subs[c][:max(0, (total - written))][: block_size]
            else:
                chunks[c].append(subs[c])
        written += block_size
        if total and written >= total:
            break

    if not total:
        out = [np.concatenate(ch) for ch in chunks]
        total = len(out[0])
    arr = np.stack([o[:total] for o in out]).astype(np.float32)
    return arr / float(1 << (bps - 1)), sample_rate


def decode_wav(path: str) -> Tuple[np.ndarray, int]:
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    return x.reshape(-1, ch).T.copy(), rate


def flac_declared_samples(head: bytes) -> int:
    """The sample count in a FLAC file's STREAMINFO (0: not declared), from
    its first 26 bytes: STREAMINFO is always the first metadata block."""
    return int.from_bytes(head[18:26], "big") & ((1 << 36) - 1)


def load_audio_file(path: str) -> Tuple[np.ndarray, int]:
    """-> (float32 [channels, samples], sample_rate), by the file's magic
    bytes. FLAC goes through the native host library (``data/native.py``,
    bit-identical to :func:`decode_flac`), which sizes its output from
    STREAMINFO's sample count; a stream that declares none (0, allowed by
    the format) is decoded by :func:`decode_flac`."""
    with open(path, "rb") as f:
        head = f.read(26)
    if head[:4] == b"fLaC":
        if flac_declared_samples(head) == 0:
            return decode_flac(path)
        from vitlens_tpu_torch.data.native import decode_flac_native

        return decode_flac_native(path)
    if head[:4] == b"RIFF":
        return decode_wav(path)
    raise ValueError(f"unsupported audio container for {path!r}")


def resample(x: np.ndarray, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 6) -> np.ndarray:
    """Windowed-sinc resampling matching torchaudio.functional.resample
    defaults (sinc_interp_hann). x: [..., T]."""
    if orig_freq == new_freq:
        return x
    import math

    gcd = math.gcd(int(orig_freq), int(new_freq))
    orig = orig_freq // gcd
    new = new_freq // gcd
    base_freq = min(orig, new) * 0.99
    width = int(math.ceil(lowpass_filter_width * orig / base_freq))
    idx = np.arange(-width, width + orig, dtype=np.float64)[None] / orig  # [1, K]
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx  # [new, K]
    t = t * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    scale = base_freq / orig
    kernel = np.where(t == 0, 1.0, np.sinc(t)) * window * scale  # [new, K]

    shape = x.shape
    T = shape[-1]
    xf = x.reshape(-1, T).astype(np.float64)
    pad = width
    xp = np.pad(xf, ((0, 0), (pad, pad + orig)))
    n_out_blocks = (T + orig - 1) // orig
    # frame the signal: block i covers samples [i*orig - width, i*orig + width + orig)
    K = kernel.shape[1]
    frames = np.lib.stride_tricks.sliding_window_view(xp, K, axis=1)[:, ::orig][:, :n_out_blocks]
    y = np.einsum("bnk,mk->bnm", frames, kernel).reshape(xf.shape[0], -1)
    target_len = int(math.ceil(new * T / orig))
    return y[:, :target_len].reshape(shape[:-1] + (-1,)).astype(np.float32)
