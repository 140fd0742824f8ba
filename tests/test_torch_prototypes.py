"""The port's counterparts of the TPU prototype kernels under ``scripts/``, on
CPU, held against the prototypes themselves: each prototype is loaded from
its file and run through ``pl.pallas_call(..., interpret=True)``, the port's
wrapper takes its plain version (the tensors are on the CPU), and both see
the same numpy inputs. Tolerances: the int8 product and the gather are exact;
the three fused prototypes agree within 1e-2 of max|want| in bf16 (one bf16
ulp at |out| ~ 2-4 is 1.6e-2 absolute; the sums differ in order only).
Then each ``python -m vitlens_tpu_torch.scripts.<name>`` entry point runs at a
small size with ``--device cpu``."""

import functools
import importlib
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vitlens_tpu_torch.ops import fused_ln_proj as PFL
from vitlens_tpu_torch.ops import fused_mlp as PFM
from vitlens_tpu_torch.ops import fused_mlp_chain as PC
from vitlens_tpu_torch.ops import int8_matmul as PI
from vitlens_tpu_torch.ops import row_gather as PG
from tests.test_torch_threads import share_cores

share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-2
M, D, H, TM, TH = 48, 128, 256, 16, 128


@pytest.fixture()
def prototype(monkeypatch, tmp_path):
    """Loads scripts/<name>.py as a module with Pallas in interpret mode.
    The scripts set JAX_COMPILATION_CACHE_DIR by setdefault when imported:
    it is pointed at a temporary directory first."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))

    def load(name):
        spec = importlib.util.spec_from_file_location(
            f"_prototype_{name}", os.path.join(REPO, "scripts", name + ".py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    return load


def _mlp_args(seed=0, m=M, d=D, hidden=H):
    rng = np.random.RandomState(seed)
    return ((rng.randn(m, d) * 0.5).astype(np.float32),
            (rng.rand(1, d) + 0.5).astype(np.float32),
            (rng.randn(1, d) * 0.1).astype(np.float32),
            (rng.randn(d, hidden) * d ** -0.5).astype(np.float32),
            (rng.randn(1, hidden) * 0.1).astype(np.float32),
            (rng.randn(hidden, d) * hidden ** -0.5 * 4).astype(np.float32),
            (rng.randn(1, d) * 0.1).astype(np.float32))


def _jax_args(args):
    """bf16 for the matrices ([M, .] or [K, N]), fp32 for the [1, .] rows."""
    return tuple(jnp.asarray(a, jnp.float32 if a.shape[0] == 1 else jnp.bfloat16)
                 for a in args)


def _torch_args(args):
    return tuple(torch.from_numpy(a[0]) if a.shape[0] == 1
                 else torch.from_numpy(a).bfloat16() for a in args)


def _close(got, want, tol=TOL):
    got = got.float().numpy()
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_int8_matmul_equals_prototype(prototype):
    proto = prototype("bench_int8_native")
    rng = np.random.RandomState(0)
    a = rng.randint(-127, 128, (M, 128)).astype(np.int8)
    b = rng.randint(-127, 128, (128, 256)).astype(np.int8)
    want = np.asarray(proto.pallas_int8_matmul(jnp.asarray(a), jnp.asarray(b),
                                               tm=TM, tk=64, tn=128))
    got = PI.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, a.astype(np.int64) @ b.astype(np.int64))
    assert PI.int8_matmul.launches == 0


def test_row_gather_equals_prototype(prototype):
    proto = prototype("bench_dma_gather")
    rng = np.random.RandomState(1)
    table = rng.randn(proto.V, proto.D).astype(np.float32)
    ids = rng.randint(0, proto.V, size=(24,)).astype(np.int32)
    ids[:4] = (0, proto.V - 1, 7, 7)  # boundary and repeated ids
    want = np.asarray(proto.dma_gather(jnp.asarray(table, jnp.bfloat16),
                                       jnp.asarray(ids))).astype(np.float32)
    ttable = torch.from_numpy(table).bfloat16()
    got = PG.row_gather(ttable, torch.from_numpy(ids))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert torch.equal(got, ttable[torch.from_numpy(ids).long()])
    assert PG.row_gather.launches == 0


def test_fused_mlp_chunked_matches_prototype(prototype):
    """Prototype #7 computes the tanh GELU; the port's plain version with
    ``gelu_tanh`` is held to it, and to the prototype's own XLA comparator
    (exact erf) at its own 2e-2 bound."""
    proto = prototype("fused_mlp_pallas")
    args = _mlp_args()
    want = proto.fused_mlp(*_jax_args(args), tm=TM, th=TH)
    got = PC.fused_mlp_chunked(*_torch_args(args), act="gelu_tanh")
    assert got.dtype == torch.bfloat16
    _close(got, want)
    j = _jax_args(args)
    _close(got, proto.xla_mlp(j[0], j[1][0], j[2][0], j[3], j[4][0], j[5], j[6][0]),
           tol=2e-2)
    assert PC.fused_mlp_chunked.launches == 0


def test_fused_mlp_chunked_exact_gelu_matches_fused_mlp_reference():
    """With the exact GELU the chunked MLP is the function of the three-launch
    fused MLP: its plain version against ``fused_mlp_reference``, same
    bound, bf16 and fp32 (1e-5)."""
    t = _torch_args(_mlp_args(seed=1))
    _close(PC.fused_mlp_chunked(*t, act="gelu"),
           PFM.fused_mlp_reference(*t, act="gelu").float().numpy())
    t32 = tuple(a.float() for a in t)
    _close(PC.fused_mlp_chunked(*t32, act="gelu"),
           PFM.fused_mlp_reference(*t32, act="gelu").numpy(), tol=1e-5)


def test_chain_act_codes_are_kernel_1s():
    """On the card the chunked MLP calls kernel 1's entry point
    (vitlens_fused_mlp_fwd) with the chain's act code: the exact GELU is
    kernel 1's own code, and the tanh GELU the one past kernel 1's acts,
    which gemm_sm90.cuh's act_fn computes with tanhf."""
    assert PC._GEMM_ACT["gelu"] == PFM.ACTS.index("gelu")
    assert PC._GEMM_ACT["gelu_tanh"] == len(PFM.ACTS) == 2
    src = open(os.path.join(REPO, "vitlens_tpu_torch", "csrc", "gemm_sm90.cuh"),
               encoding="utf-8").read()
    body = src[src.index("float act_fn("):]
    body = body[:body.index("\n}\n")]
    assert "if (act == 1)" in body and "tanhf(" in body.split("if (act == 1)")[1]


def test_fused_ln_qkv_matches_prototype(prototype):
    """Prototype #8 has the body of the fused LN + projection kernel: the
    port's ``fused_ln_proj`` is its counterpart."""
    proto = prototype("fused_ln_qkv_pallas")
    x, lnw, lnb, w, _, _, _ = _mlp_args(seed=2, hidden=3 * D)
    b = (np.random.RandomState(3).randn(1, 3 * D) * 0.1).astype(np.float32)
    args = (x, lnw, lnb, w, b)
    want = proto.fused(*_jax_args(args), tm=TM)
    got = PFL.fused_ln_proj(*_torch_args(args))
    assert tuple(got.shape) == (M, 3 * D)
    _close(got, want)
    _close(got, proto.xla_ref(*_jax_args(args)), tol=2.5e-2)


def test_fused_attnout_mlp_matches_prototype(prototype):
    proto = prototype("fused_attnout_mlp_pallas")
    x, *mlp = _mlp_args(seed=4)
    rng = np.random.RandomState(5)
    ctx = (rng.randn(M, D) * 0.5).astype(np.float32)
    wo = (rng.randn(D, D) * D ** -0.5).astype(np.float32)
    bo = (rng.randn(1, D) * 0.1).astype(np.float32)
    args = (x, ctx, wo, bo, *mlp)
    want = proto.fused(*_jax_args(args), tm=TM)
    got = PC.fused_attnout_mlp(*_torch_args(args), act="gelu_tanh")
    _close(got, want)
    _close(got, proto.xla_split(*_jax_args(args)), tol=2.5e-2)
    assert PC.fused_attnout_mlp.launches == 0


def test_chain_reference_outproj_is_the_mlp_of_the_fp32_row():
    """With the out-projection the residual and the LayerNorm input are the
    fp32 row x + ctx @ Wo + bo, not its bf16 rounding: in fp32, where nothing
    rounds, the chain equals the MLP applied to that row."""
    t = tuple(a.float() for a in _torch_args(_mlp_args(seed=6)))
    x, *mlp = t
    g = torch.Generator().manual_seed(0)
    ctx = torch.randn(M, D, generator=g) * 0.5
    wo = torch.randn(D, D, generator=g) * D ** -0.5
    bo = torch.randn(D, generator=g) * 0.1
    got = PC.fused_attnout_mlp(x, ctx, wo, bo, *mlp, act="gelu")
    want = PC.fused_mlp_chunked(x + ctx @ wo + bo, *mlp, act="gelu")
    _close(got, want.numpy(), tol=1e-5)
    with pytest.raises(ValueError, match="act"):
        PC.fused_mlp_chunked(x, *mlp, act="quick_gelu")


def _chain(m=8, d=256, h=128, dtype=torch.bfloat16):
    f32 = torch.float32
    return (torch.zeros(m, d, dtype=dtype), torch.ones(d, dtype=f32),
            torch.zeros(d, dtype=f32), torch.zeros(d, h, dtype=dtype),
            torch.zeros(h, dtype=f32), torch.zeros(h, d, dtype=dtype),
            torch.zeros(d, dtype=f32))


def test_chain_kernel_argument_checks():
    proj = (torch.zeros(8, 256, dtype=torch.bfloat16),
            torch.zeros(256, 256, dtype=torch.bfloat16), torch.zeros(256))
    PC._check_cuda_args(*_chain(), "gelu", None)
    PC._check_cuda_args(*_chain(), "gelu_tanh", proj)
    PC._check_cuda_args(*_chain(d=128, h=192), "gelu", None)
    with pytest.raises(ValueError, match="bfloat16"):
        PC._check_cuda_args(*_chain(dtype=torch.float32), "gelu", None)
    with pytest.raises(ValueError, match="multiples of 64"):
        PC._check_cuda_args(*_chain(d=100), "gelu", None)
    with pytest.raises(ValueError, match="multiples of 64"):
        PC._check_cuda_args(*_chain(h=96), "gelu", None)
    with pytest.raises(ValueError, match="act"):
        PC._check_cuda_args(*_chain(), "quick_gelu", None)
    with pytest.raises(ValueError, match="wo must be"):
        PC._check_cuda_args(*_chain(), "gelu",
                            (proj[0], torch.zeros(256, 128, dtype=torch.bfloat16),
                             proj[2]))
    with pytest.raises(ValueError, match="contiguous"):
        PC._check_cuda_args(*_chain(), "gelu", (proj[0], proj[1].t(), proj[2]))
    with pytest.raises(ValueError, match="is on"):
        PC._check_cuda_args(*_chain(), "gelu", (proj[0].to("meta"), *proj[1:]))


def test_row_gather_kernel_argument_checks():
    table = torch.zeros(10, 8, dtype=torch.bfloat16)
    ids = torch.zeros(4, dtype=torch.int32)
    PG._check_cuda_args(table, ids)
    with pytest.raises(ValueError, match="int32"):
        PG._check_cuda_args(table, ids.long())
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        PG._check_cuda_args(torch.zeros(10, 4, dtype=torch.bfloat16), ids)
    with pytest.raises(ValueError, match="contiguous"):
        PG._check_cuda_args(torch.zeros(8, 10, dtype=torch.bfloat16).t(), ids)
    with pytest.raises(ValueError, match=r"\[V, D\]"):
        PG._check_cuda_args(table[0], ids)
    with pytest.raises(ValueError, match="is on"):
        PG._check_cuda_args(table, ids.to("meta"))
    with pytest.raises(IndexError):  # the plain version refuses a bad id
        PG.row_gather(table, torch.tensor([10], dtype=torch.int32))


@pytest.mark.parametrize("name,argv", [
    ("fused_mlp_chunked", ["--rows", "48", "--dim", "256", "--hidden", "256"]),
    ("fused_ln_qkv", ["--rows", "48", "--dim", "128"]),
    ("fused_attnout_mlp", ["--rows", "48", "--dim", "256", "--hidden", "256"]),
    ("bench_int8_native", ["--size", "128"]),
    ("bench_dma_gather", ["--batch", "2"]),
    ("bench_int8_encode", ["--model", "ViT-Tiny-Test", "--batch", "2",
                           "--dtype", "float32"]),
])
def test_script_entry_points_run_on_cpu(name, argv, capsys):
    """Each bench entry point runs end to end at a small size on the CPU,
    exits 0 (correct against the plain version), prints JSON rows that name
    the device, and writes no device metric from a CPU run."""
    module = importlib.import_module(f"vitlens_tpu_torch.scripts.{name}")
    assert module.main([*argv, "--device", "cpu", "--iters", "1"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert rows and all(r["device"] == "cpu" for r in rows)
    for r in rows:
        assert not {"ms", "tflops", "tera_ops_per_s", "samples_per_s"} & set(r)
    if name == "bench_int8_encode":
        assert rows[0]["min"] > 0.99
    if name == "bench_int8_native":
        assert rows[0]["wrong_elements"] == {"kernel": 0, "plain": 0}


def test_script_entry_points_default_to_the_card(monkeypatch):
    from vitlens_tpu_torch.scripts import bench_dma_gather

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_dma_gather.main([])
