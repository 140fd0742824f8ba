"""Package-level rules of the port: it imports neither jax nor the JAX
package, the kernel build fails loudly without nvcc, and the kernel wrappers
refuse what their kernels do not take."""

import os
import subprocess
import sys

import pytest
import torch

from vitlens_tpu_torch.ops import _build
from vitlens_tpu_torch.ops import flash_attention as PFA
from vitlens_tpu_torch.ops import fused_mlp as PFM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, vitlens_tpu_torch\n"
        "for m in pkgutil.walk_packages(vitlens_tpu_torch.__path__, 'vitlens_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'vitlens_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_never_name_jax():
    root = os.path.join(REPO, "vitlens_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(dirpath, f), encoding="utf-8").read()
                for line in src.splitlines():
                    s = line.strip()
                    if s.startswith(("import ", "from ")):
                        mod = s.split()[1].split(".")[0]
                        assert mod not in ("jax", "jaxlib", "vitlens_tpu"), (f, s)


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    if not (_build.BUILD_ROOT / _build.source_hash()).exists():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build()


def test_launch_error_raises():
    _build.check(0, "ok")
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        _build.check(98, "kernel")


def _mlp(m=8, d=64, h=128, dtype=torch.bfloat16):
    f32 = torch.float32
    return (torch.zeros(m, d, dtype=dtype), torch.ones(d, dtype=f32),
            torch.zeros(d, dtype=f32), torch.zeros(d, h, dtype=dtype),
            torch.zeros(h, dtype=f32), torch.zeros(h, d, dtype=dtype),
            torch.zeros(d, dtype=f32))


def test_fused_mlp_kernel_argument_checks():
    PFM._check_cuda_args(*_mlp(), "gelu")
    with pytest.raises(ValueError, match="bfloat16"):
        PFM._check_cuda_args(*_mlp(dtype=torch.float32), "gelu")
    with pytest.raises(ValueError, match="multiples of 64"):
        PFM._check_cuda_args(*_mlp(d=96), "gelu")
    with pytest.raises(ValueError, match="act"):
        PFM._check_cuda_args(*_mlp(), "relu")
    args = list(_mlp())
    args[3] = torch.zeros(128, 64, dtype=torch.bfloat16).t()
    with pytest.raises(ValueError, match="contiguous"):
        PFM._check_cuda_args(*args, "gelu")


def test_flash_attention_kernel_argument_checks():
    q = torch.zeros(1, 2, 5, 64, dtype=torch.bfloat16)
    PFA._check_cuda_args(q, q, q)
    with pytest.raises(ValueError, match="head dim"):
        z = torch.zeros(1, 2, 5, 32, dtype=torch.bfloat16)
        PFA._check_cuda_args(z, z, z)
    with pytest.raises(ValueError, match="bfloat16"):
        PFA._check_cuda_args(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 5, 2, 64, dtype=torch.bfloat16).transpose(1, 2)
        PFA._check_cuda_args(t, t, t)
