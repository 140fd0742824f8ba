"""ctypes binding of the native host-data library (``native/vitlens_host.cpp``):
FLAC decode and farthest-point sampling for the host data pipeline.

At first use the library is compiled from ``native/vitlens_host.cpp`` with the
flags of ``native/build.sh`` into ``build/host/libvitlens_host.so`` (git
ignores ``build/``). Concurrent builds (pytest workers, loader processes)
serialise on a file lock; each compiles to a temporary name and renames it
into place, so no process ever loads a torn file. A stamp beside the library
holds the hash of the source, the flags and the CPU's features, so an edited
source, or a build directory copied from another machine, is rebuilt.

There is no fallback: without ``g++``, or when the compile fails, every call
raises with the compiler's message. The pure-Python FLAC decoder
(``audio_decode.decode_flac``) and the numpy FPS loop
(``processors.farthest_point_sample_plain``) stay as the plain versions, and
the tests hold the library to them.

Rounding of ``fps_indices``: the library keeps the running distances and
computes each squared distance in fp32, ``dx*dx + dy*dy + dz*dz`` in that
order; ``build.sh`` compiles C++ with ``-O3 -march=native`` and GCC's default
``-ffp-contract=fast`` (ISO C++ modes do not turn it off), so on a CPU with
FMA the sum may be contracted into fused multiply-adds. The plain loop sums in
float64. The two pick the same points wherever no two candidates' distances
tie within fp32 rounding; on near-ties they may differ. The JAX package's
native path builds the same source with the same flags, so its indices and
these are equal on the same machine.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "vitlens_host.cpp"
BUILD_DIR = REPO / "build" / "host"
LIB_PATH = BUILD_DIR / "libvitlens_host.so"
# the flags of native/build.sh
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

_lib = None


def _cpu_flags() -> bytes:
    """The host CPU's feature flags: ``-march=native`` builds for them, so a
    library built on another CPU (a copied build directory) is rebuilt."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        return b""


def source_hash() -> str:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_flags())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library unless the one in ``build/host/`` is of this
    source; raises RuntimeError with the compiler's output on failure."""
    want = source_hash()
    stamp = LIB_PATH.with_suffix(".so.src")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if LIB_PATH.exists() and stamp.exists() and stamp.read_text() == want:
            return LIB_PATH
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError(
                f"g++ not found: cannot build the native host library from "
                f"{SOURCE}")
        tmp = BUILD_DIR / f".libvitlens_host.{os.getpid()}.so"
        out = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {SOURCE} failed ({out.returncode}):\n"
                               f"{out.stderr}{out.stdout}")
        os.replace(tmp, LIB_PATH)
        stamp.write_text(want)
    return LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded library, built at first use; the same ctypes signatures
    as the JAX package's binding."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.flac_probe.restype = ctypes.c_int
        lib.flac_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.flac_decode.restype = ctypes.c_int64
        lib.flac_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ]
        lib.fps_indices.restype = None
        lib.fps_indices.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
    return _lib


def decode_flac_native(path: str) -> Tuple[np.ndarray, int]:
    """-> (float32 [channels, samples], rate). The library sizes its output
    from STREAMINFO's sample count: a stream that declares none is for
    :func:`audio_decode.decode_flac`. Raises ValueError where the library
    rejects the stream."""
    with open(path, "rb") as f:
        raw = f.read()
    lib = library()
    rate, channels, bps = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    total = ctypes.c_int64()
    rc = lib.flac_probe(raw, len(raw), ctypes.byref(rate),
                        ctypes.byref(channels), ctypes.byref(bps),
                        ctypes.byref(total))
    if rc != 0 or total.value <= 0:
        raise ValueError(f"{path!r}: the native decoder needs a STREAMINFO "
                         f"sample count (probe {rc}, total {total.value})")
    out = np.zeros((channels.value, total.value), np.float32)
    n = lib.flac_decode(raw, len(raw),
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        total.value)
    if n <= 0:
        raise ValueError(f"{path!r}: the native FLAC decoder failed ({n})")
    return out[:, :n], rate.value


def fps_indices(points: np.ndarray, npoint: int, start: int = 0) -> np.ndarray:
    """Farthest-point sampling of one cloud [N, >=3] on its xyz: the
    ``npoint`` indices (int64), starting at ``start``."""
    xyz = np.ascontiguousarray(points[:, :3], np.float32)
    idx = np.zeros(npoint, np.int64)
    library().fps_indices(xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          xyz.shape[0], npoint, int(start),
                          idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return idx
