"""The port's binding of the native host library (vitlens_tpu_torch/
data/native.py): built from native/vitlens_host.cpp into build/host/ at first
use, FLAC decode bit-equal to the JAX package's native decoder and to the
pure-Python one, FPS indices equal to JAX's farthest_point_sample_np and to
the plain numpy loop (JAX's binding is pointed at the port's build of the
same source), a concurrent build that never loads a torn file, and
no fallback when the build fails."""

import os
import subprocess
import sys

import numpy as np
import pytest

from tools.reference_layout import pcm_from_float, write_flac, write_wav
from vitlens_tpu.data import native as JN
from vitlens_tpu.data import processors as JP
from vitlens_tpu_torch.data import audio_decode as PD
from vitlens_tpu_torch.data import native as PN
from vitlens_tpu_torch.data import processors as PP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _jax_binding_on_the_port_build(monkeypatch):
    """The JAX package's binding, loading the library the port built from
    the same source with the same flags (its own build goes to native/)."""
    monkeypatch.setattr(JN, "_lib", None)
    monkeypatch.setattr(JN, "_LIB_PATHS", [str(PN.build())])


def test_library_is_built_into_build_host():
    path = PN.build()
    assert path == PN.LIB_PATH
    assert str(path).startswith(os.path.join(REPO, "build", "host"))
    assert (PN.BUILD_DIR / "libvitlens_host.so.src").read_text() == PN.source_hash()
    assert PN.library() is PN.library()


def _flac(tmp_path, name, pcm, rate, bps=16, **kw):
    path = str(tmp_path / name)
    write_flac(path, pcm, rate, bps=bps, **kw)
    return path


@pytest.mark.parametrize("kind", ["mono16", "stereo_mid_side", "stereo_left_side",
                                  "mono24_verbatim", "odd_block"])
def test_flac_decode_bit_equal(tmp_path, kind):
    rng = np.random.RandomState(0)
    t = np.arange(16000 * 3) / 16000.0
    x = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.randn(t.size)
    if kind == "mono16":
        path = _flac(tmp_path, "a.flac", pcm_from_float(x, 16), 16000)
    elif kind == "stereo_mid_side":
        pcm = pcm_from_float(np.stack([x, 0.5 * x[::-1]]), 16)
        path = _flac(tmp_path, "a.flac", pcm, 44100, stereo="mid_side")
    elif kind == "stereo_left_side":
        pcm = pcm_from_float(np.stack([x, -x]), 16)
        path = _flac(tmp_path, "a.flac", pcm, 22050, stereo="left_side", order=3)
    elif kind == "mono24_verbatim":
        path = _flac(tmp_path, "a.flac", pcm_from_float(x, 24), 48000, bps=24,
                     subframe="verbatim")
    else:
        path = _flac(tmp_path, "a.flac", pcm_from_float(x[:12345], 16), 8000,
                     block_size=1152, order=4)
    got, sr = PN.decode_flac_native(path)
    plain, sr_p = PD.decode_flac(path)
    assert sr == sr_p and got.dtype == np.float32
    np.testing.assert_array_equal(got, plain)
    assert JN.available()
    want, sr_j = JN.decode_flac_native(path)
    assert sr_j == sr
    np.testing.assert_array_equal(got, want)
    # load_audio_file takes the library
    np.testing.assert_array_equal(PD.load_audio_file(path)[0], got)


def test_load_audio_file_flac_without_sample_count(tmp_path):
    """A FLAC stream whose STREAMINFO declares 0 samples (allowed by the
    format) is decoded by the Python decoder: the library sizes its output
    from that count and rejects the stream."""
    x = pcm_from_float(np.sin(np.arange(5000) / 7.0) * 0.3, 16)
    path = _flac(tmp_path, "a.flac", x, 16000)
    raw = bytearray(open(path, "rb").read())
    raw[21] &= 0xF0
    raw[22:26] = b"\0\0\0\0"
    open(path, "wb").write(bytes(raw))
    assert PD.flac_declared_samples(bytes(raw[:26])) == 0
    with pytest.raises(ValueError, match="STREAMINFO sample count"):
        PN.decode_flac_native(path)
    got, _ = PD.load_audio_file(path)
    np.testing.assert_array_equal(got, PD.decode_flac(path)[0])


@pytest.mark.parametrize("n,npoint,seed", [(512, 64, None), (2048, 512, 3),
                                           (9000, 512, None), (10000, 1024, 7)])
def test_fps_matches_jax_and_plain(n, npoint, seed):
    rng = np.random.RandomState(n)
    pts = rng.randn(n, 6).astype(np.float32)
    got = PP.farthest_point_sample_np(pts, npoint, seed)
    np.testing.assert_array_equal(got, JP.farthest_point_sample_np(pts, npoint, seed))
    np.testing.assert_array_equal(got, PP.farthest_point_sample_plain(pts, npoint, seed))
    start = 0 if seed is None else int(np.random.RandomState(seed).randint(0, n))
    idx = PN.fps_indices(pts, npoint, start)
    np.testing.assert_array_equal(pts[idx], got)
    np.testing.assert_array_equal(pts[idx], JN.fps_native(pts, npoint, start))


def test_point_cloud_processor_uses_the_library(monkeypatch):
    calls = []
    real = PN.fps_indices
    monkeypatch.setattr(PN, "fps_indices",
                        lambda *a: calls.append(a[1]) or real(*a))
    pts = np.random.RandomState(1).randn(9000, 3).astype(np.float32)
    out = PP.PointCloudProcessor(n_sample_points=256)([pts])
    assert calls == [256] and out.shape == (1, 256, 3)
    want = JP.PointCloudProcessor(n_sample_points=256)([pts])
    np.testing.assert_array_equal(out, want)


def test_concurrent_builds_never_load_a_torn_library(tmp_path):
    """Three processes build into a fresh directory at once: all load a
    whole library and compute the same FPS."""
    code = (
        "import sys, numpy as np\n"
        "from pathlib import Path\n"
        "from vitlens_tpu_torch.data import native as N\n"
        "N.BUILD_DIR = Path(sys.argv[1]); N.LIB_PATH = N.BUILD_DIR / 'libvitlens_host.so'\n"
        "pts = np.random.RandomState(0).randn(300, 3).astype(np.float32)\n"
        "print(N.fps_indices(pts, 16).tolist())\n")
    d = str(tmp_path / "host")
    procs = [subprocess.Popen([sys.executable, "-c", code, d], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-1000:] for o in outs]
    assert len({o[0] for o in outs}) == 1
    assert sorted(os.listdir(d)) == [".lock", "libvitlens_host.so",
                                     "libvitlens_host.so.src"]


def test_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: without g++, or with a source that does not compile, the
    call raises with the reason."""
    monkeypatch.setattr(PN, "_lib", None)
    monkeypatch.setattr(PN, "BUILD_DIR", tmp_path / "host")
    monkeypatch.setattr(PN, "LIB_PATH", tmp_path / "host" / "libvitlens_host.so")
    monkeypatch.setattr(PN.shutil, "which", lambda name: None)
    pts = np.zeros((10, 3), np.float32)
    with pytest.raises(RuntimeError, match="g.. not found"):
        PP.farthest_point_sample_np(pts, 2)
    monkeypatch.undo()
    monkeypatch.setattr(PN, "_lib", None)
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(PN, "SOURCE", bad)
    monkeypatch.setattr(PN, "BUILD_DIR", tmp_path / "host2")
    monkeypatch.setattr(PN, "LIB_PATH", tmp_path / "host2" / "libvitlens_host.so")
    with pytest.raises(RuntimeError, match="failed"):
        PN.library()
    wav = str(tmp_path / "a.wav")
    write_wav(wav, pcm_from_float(np.zeros(100), 16)[None], 16000)
    PD.load_audio_file(wav)  # WAV never needs the library
