"""Builds the hand-written CUDA kernels under ``csrc/`` and loads them.

Every ``csrc/*.cu`` file (with the headers it includes) is compiled by ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` process per source, all started together, and the objects are linked
into one shared library with a plain C interface, at first use, and loaded
with ``ctypes``. The library lives in ``build/kernels/<hash>/`` at the repository
root (git-ignored), keyed by a hash of the sources and the flags, so an edit to
a kernel rebuilds it and an unchanged checkout reuses the last build.

Each C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` turns a non-zero code into an exception. A missing ``nvcc`` or a
failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]
_LIB_NAME = "libvitlens_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures of the entry points (pointers and the stream are c_void_p).
_SIGNATURES = {
    "vitlens_fused_mlp_fwd": [_P] * 10 + [_I, _I, _I, _I, _F, _P],
    "vitlens_fused_mlp_fwd_save_preact": [_P] * 11 + [_I, _I, _I, _I, _F, _P],
    "vitlens_fused_ln_proj_fwd": [_P] * 7 + [_I, _I, _I, _F, _P],
    "vitlens_flash_attention_fwd": [_P] * 4 + [_I] * 5 + [_L] * 9 + [_F, _P],
    "vitlens_fps_fwd": [_P] * 4 + [_I] * 4 + [_P],
    "vitlens_point_encoder_fwd": [_P] * 16 + [_I] * 6 + [_P],
    "vitlens_int8_matmul_fwd": [_P] * 3 + [_I] * 3 + [_P],
    "vitlens_int8_matmul_dequant_fwd": [_P] * 6 + [_I] * 4 + [_P],
    "vitlens_int8_quantize_fwd": [_P] * 3 + [_I] * 3 + [_P],
    "vitlens_row_gather_fwd": [_P] * 3 + [_I] * 3 + [_P],
    "vitlens_fused_attnout_mlp_fwd": [_P] * 12 + [_I, _I, _I, _I, _F, _P],
}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of vitlens_tpu_torch are built "
            "from csrc/ with the CUDA toolkit (put nvcc on PATH or install it "
            "under /usr/local/cuda)")
    return nvcc


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return
    the library's path."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / _LIB_NAME
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        objs = [os.path.join(tmp_dir, src.stem + ".o") for src in _sources()]
        compiles = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
                    for src, obj in zip(_sources(), objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        outs = [p.communicate()[0] for p in procs]
        tmp_lib = os.path.join(tmp_dir, _LIB_NAME)
        steps = list(zip(compiles, procs, outs))
        if all(p.returncode == 0 for p in procs):
            link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_lib, *objs]
            proc = subprocess.run(link, capture_output=True, text=True)
            steps.append((link, proc, proc.stdout + proc.stderr))
        for cmd, p, out in steps:
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
        os.replace(tmp_lib, lib)  # atomic: a loader never sees half a file
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with argtypes set on every entry point."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device, the
    stream a kernel launches on: PyTorch's own accessor, which costs less
    host time a call than building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
