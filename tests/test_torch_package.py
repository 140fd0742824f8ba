"""Package-level rules of the port: it imports neither jax nor the JAX
package and reads none of its files, its entry points default to the card,
the kernel build fails loudly without nvcc, and the kernel wrappers refuse
what their kernels do not take."""

import os
import subprocess
import sys

import pytest
import torch

from vitlens_tpu_torch.ops import _build
from vitlens_tpu_torch.ops import flash_attention as PFA
from vitlens_tpu_torch.ops import fps as PF
from vitlens_tpu_torch.ops import fused_ln_proj as PFL
from vitlens_tpu_torch.ops import fused_mlp as PFM
from vitlens_tpu_torch.ops import fused_point_encoder as PFE
from vitlens_tpu_torch.text import tokenizer as PT
from tests.test_torch_threads import share_cores

share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, vitlens_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(vitlens_tpu_torch.__path__, 'vitlens_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "for n in ('ops.fps', 'ops.fused_point_encoder', 'adapters.tokenizers', 'data.processors',\n"
        "          'ops.fused_ln_proj', 'train.losses', 'train.schedules', 'train.freeze', 'train.step',\n"
        "          'quant', 'ops.int8_matmul', 'ops.row_gather', 'ops.fused_mlp_chain', 'scripts.fused_mlp_chunked',\n"
        "          'scripts.fused_ln_qkv', 'scripts.fused_attnout_mlp', 'scripts.bench_int8_native',\n"
        "          'scripts.bench_dma_gather', 'scripts.bench_int8_encode', 'ops.fbank',\n"
        "          'data.audio_decode', 'weights.torch_convert', 'serve', 'cli.serve',\n"
        "          'data.rng', 'data.video_processors', 'data.augment',\n"
        "          'data.video_randaugment', 'train.openshape', 'data.native',\n"
        "          'data.loader', 'data.datasets', 'data.lmdb_reader', 'eval.metadata',\n"
        "          'eval.metrics', 'eval.zero_shot', 'train.checkpoint', 'utils.logging',\n"
        "          'utils.flops', 'cli.args', 'cli.train', 'models.pc_baselines',\n"
        "          'models.point_transformer', 'cli.train_openshape', 'models.eva',\n"
        "          'train.lora', 'models.bert_text', 'models.hf_text', 'models.linear_probe',\n"
        "          'cli.train_linprobe', 'cli.infer', 'utils.export', 'utils.hub',\n"
        "          'models.resnet', 'ops.custom', 'models.lora', 'models.coca',\n"
        "          'parallel.mesh'):\n"
        "    assert 'vitlens_tpu_torch.' + n in names, n\n"
        "sys.path.insert(0, '.')\n"
        "import tools.reference_layout\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'vitlens_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_never_name_jax():
    """No import of jax or the JAX package in any module of the port, in
    tools/reference_layout.py or in chip_smoke.py."""
    root = os.path.join(REPO, "vitlens_tpu_torch")
    paths = [os.path.join(dirpath, f) for dirpath, _, files in os.walk(root)
             for f in files if f.endswith(".py")]
    names = {os.path.relpath(p, root) for p in paths}
    for new in ("ops/fbank.py", "data/audio_decode.py", "weights/torch_convert.py",
                "serve.py", "cli/serve.py", "data/rng.py",
                "data/video_processors.py", "data/augment.py",
                "data/video_randaugment.py", "train/openshape.py",
                "data/native.py", "data/loader.py", "data/datasets.py",
                "data/lmdb_reader.py", "eval/metrics.py", "eval/zero_shot.py",
                "eval/metadata.py", "train/checkpoint.py", "utils/logging.py",
                "utils/flops.py", "cli/args.py", "cli/train.py",
                "models/pc_baselines.py", "models/point_transformer.py",
                "cli/train_openshape.py", "models/eva.py", "train/lora.py",
                "models/bert_text.py", "models/hf_text.py",
                "models/linear_probe.py", "cli/train_linprobe.py",
                "cli/infer.py", "utils/export.py", "utils/hub.py",
                "models/resnet.py", "ops/custom.py", "models/lora.py",
                "models/coca.py", "parallel/mesh.py"):
        assert new in names, new
    paths += [os.path.join(REPO, "tools", "reference_layout.py"),
              os.path.join(REPO, "chip_smoke.py")]
    for path in paths:
        src = open(path, encoding="utf-8").read()
        for line in src.splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "vitlens_tpu"), (path, s)


def test_models_never_import_train():
    """The model layer depends on no training code: no module under
    vitlens_tpu_torch/models/ imports vitlens_tpu_torch.train (the LoRA
    merge a forward runs lives in models/lora.py)."""
    root = os.path.join(REPO, "vitlens_tpu_torch", "models")
    for f in sorted(os.listdir(root)):
        if not f.endswith(".py"):
            continue
        for line in open(os.path.join(root, f), encoding="utf-8"):
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert not s.split()[1].startswith(
                    "vitlens_tpu_torch.train"), (f, s)


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


def test_save_preact_entry_point_checks_its_arguments():
    """The save-preact launch path checks its arguments before it touches
    the library, and its C entry point has its own signature (one pointer
    more than the plain variant's: the pre-activation output)."""
    with pytest.raises(ValueError, match="bfloat16"):
        PFM._launch(*_mlp(dtype=torch.float32), "gelu", 1e-5, save_preact=True)
    with pytest.raises(ValueError, match="multiples of 64"):
        PFM._launch(*_mlp(h=96), "gelu", 1e-5, save_preact=True)
    plain = _build._SIGNATURES["vitlens_fused_mlp_fwd"]
    save = _build._SIGNATURES["vitlens_fused_mlp_fwd_save_preact"]
    assert save == [save[0]] + plain


def _ln_proj(m=8, d=128, n=384, dtype=torch.bfloat16):
    f32 = torch.float32
    return (torch.zeros(m, d, dtype=dtype), torch.ones(d, dtype=f32),
            torch.zeros(d, dtype=f32), torch.zeros(d, n, dtype=dtype),
            torch.zeros(n, dtype=f32))


def test_fused_ln_proj_kernel_argument_checks():
    PFL._check_cuda_args(*_ln_proj())
    with pytest.raises(ValueError, match="bfloat16"):
        PFL._check_cuda_args(*_ln_proj(dtype=torch.float32))
    with pytest.raises(ValueError, match="multiples of 128"):
        PFL._check_cuda_args(*_ln_proj(d=192, n=576))
    with pytest.raises(ValueError, match="multiples of 128"):
        PFL._check_cuda_args(*_ln_proj(n=320))
    with pytest.raises(ValueError, match="at most"):
        PFL._check_cuda_args(*_ln_proj(m=1, d=PFL.MAX_D + 128))
    args = list(_ln_proj())
    args[3] = torch.zeros(384, 128, dtype=torch.bfloat16).t()
    with pytest.raises(ValueError, match="contiguous"):
        PFL._check_cuda_args(*args)
    args = list(_ln_proj())
    args[4] = torch.zeros(384, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="b must be torch.float32"):
        PFL._check_cuda_args(*args)
    args = list(_ln_proj())
    args[1] = args[1].to("meta")
    with pytest.raises(ValueError, match="is on"):
        PFL._check_cuda_args(*args)
    sig = _build._SIGNATURES["vitlens_fused_ln_proj_fwd"]  # y scratch, no stats
    assert sig[:7] == [_build._P] * 7 and sig[7] == _build._I


def test_source_hash_covers_every_kernel_source(tmp_path, monkeypatch):
    """fused_ln_proj.cu is built, and an edit to it or to the Hopper GEMM
    header it runs on changes the build's hash (so a stale library is never loaded);
    the header is included, not compiled on its own."""
    names = sorted(p.name for p in _build.CSRC.iterdir())
    assert "fused_ln_proj.cu" in names and "gemm_sm90.cuh" in names
    for name in names:
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build._sources()] == [
        n for n in names if n.endswith(".cu")]
    seen = {_build.source_hash()}
    for name in ("fused_ln_proj.cu", "gemm_sm90.cuh"):
        with open(tmp_path / name, "a") as f:
            f.write("\n// edit\n")
        seen.add(_build.source_hash())
    assert len(seen) == 3


def test_new_kernel_sources_are_built_and_bound():
    """The int8 product, the row gather and the chained MLP are sources of
    the one library, each with its C signature; the PTX primitives they share
    with the bf16 GEMM are a header, hashed but not compiled on its own; and
    chip_smoke.py imports nothing of jax either."""
    names = sorted(p.name for p in _build.CSRC.iterdir())
    for name in ("int8_matmul.cu", "row_gather.cu", "fused_mlp_chain.cu", "ptx.cuh"):
        assert name in names
    assert "ptx.cuh" not in [p.name for p in _build._sources()]
    sig = _build._SIGNATURES
    assert sig["vitlens_int8_matmul_fwd"] == [_build._P] * 3 + [_build._I] * 3 + [_build._P]
    assert sig["vitlens_row_gather_fwd"] == sig["vitlens_int8_matmul_fwd"]
    # the attention out-projection + MLP: ctx, wo, bo in front of kernel 1's
    # parameters, one workspace for its y and h scratch (and the fp32 row)
    assert (sig["vitlens_fused_attnout_mlp_fwd"]
            == [_build._P] * 2 + sig["vitlens_fused_mlp_fwd"])
    sources = "".join(p.read_text() for p in _build._sources())
    for name in sig:  # every bound entry point is defined in some source
        assert f'extern "C" int {name}(' in sources, name
    src = open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8").read()
    for line in src.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            assert s.split()[1].split(".")[0] not in ("jax", "jaxlib", "vitlens_tpu"), s


def test_flash_attention_kernel_argument_checks():
    q = torch.zeros(1, 2, 5, 64, dtype=torch.bfloat16)
    PFA._check_cuda_args(q, q, q)
    with pytest.raises(ValueError, match="head dim"):
        z = torch.zeros(1, 2, 5, 100, dtype=torch.bfloat16)
        PFA._check_cuda_args(z, z, z)
    with pytest.raises(ValueError, match="bfloat16"):
        PFA._check_cuda_args(q.float(), q.float(), q.float())
    # views are taken: a transposed [B, N, H, Dh] and the packed qkv's
    t = torch.zeros(1, 5, 2, 64, dtype=torch.bfloat16).transpose(1, 2)
    PFA._check_cuda_args(t, t, t)
    qkv = torch.zeros(2, 7, 3, 2, 64, dtype=torch.bfloat16).permute(2, 0, 3, 1, 4)
    PFA._check_cuda_args(qkv[0], qkv[1], qkv[2])


def test_flash_attention_kernel_rejects_unreadable_views():
    """A last dim that is not contiguous, a stride that is not a multiple of
    8 elements (16 bytes) or a misaligned base raise; a size-1 dim's stride
    is never stepped and does not."""
    q = torch.zeros(2, 2, 5, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="last dim must be contiguous"):
        t = torch.zeros(2, 2, 64, 5, dtype=torch.bfloat16).transpose(2, 3)
        PFA._check_cuda_args(t, q, q)
    with pytest.raises(ValueError, match="multiples of 8"):
        t = torch.zeros(2, 2, 5, 68, dtype=torch.bfloat16)[..., :64]
        PFA._check_cuda_args(q, t, t)
    with pytest.raises(ValueError, match="16-byte aligned"):
        t = torch.zeros(2 * 2 * 5 * 64 + 8, dtype=torch.bfloat16)[4:4 + 2 * 2 * 5 * 64]
        PFA._check_cuda_args(q, q, t.view(2, 2, 5, 64))
    with pytest.raises(ValueError, match="scale must be > 0"):
        PFA._check_cuda_args(q, q, q, -0.125)
    one = torch.zeros(512, dtype=torch.bfloat16).as_strided((1, 1, 4, 64),
                                                           (4 * 64, 68, 64, 1))
    PFA._check_cuda_args(one, one, one)
    assert PFA._strides(one) == (64, 64, 64)


def test_flash_attention_kernel_rejects_broadcast_views():
    """A stride of 0 on a dim of more than one entry (an ``expand``ed
    query, as CoCa's pooler broadcasts its queries) raises; the contiguous
    copy is taken."""
    q = torch.zeros(1, 2, 5, 64, dtype=torch.bfloat16).expand(3, 2, 5, 64)
    k = torch.zeros(3, 2, 7, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="broadcast view"):
        PFA._check_cuda_args(q, k, k)
    PFA._check_cuda_args(q.contiguous(), k, k)
    heads = torch.zeros(3, 1, 7, 64, dtype=torch.bfloat16).expand(3, 2, 7, 64)
    with pytest.raises(ValueError, match="broadcast view"):
        PFA._check_cuda_args(q.contiguous(), heads, heads)


def _declarations():
    import re

    src = "".join(p.read_text() for p in _build._sources())
    return {m.group(1): m.group(2) for m in re.finditer(
        r'extern "C" int (\w+)\((.*?)\)\s*\{', src, re.S)}


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_attention_signature_matches_its_declaration(name):
    """Every ctypes signature (the attention entry point's among them: 4
    pointers, 5 ints, 9 strides as long long, the scale and the stream) has
    one argument per parameter of its extern "C" declaration, in kind."""
    kinds = {"const void*": _build._P, "void*": _build._P, "int": _build._I,
             "long long": _build._L, "float": _build._F}
    params = [" ".join(p.split()[:-1])
              for p in _declarations()[name].replace("\n", " ").split(",")]
    assert [kinds[p] for p in params] == _build._SIGNATURES[name]


def test_port_reads_its_own_vocab():
    """The BPE vocab is the port's own, byte-identical copy; no default path
    points into the JAX package."""
    ours = os.path.join(REPO, "vitlens_tpu_torch", "text",
                        "bpe_simple_vocab_16e6.txt.gz")
    theirs = os.path.join(REPO, "vitlens_tpu", "text",
                          "bpe_simple_vocab_16e6.txt.gz")
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    jax_pkg = os.path.join(REPO, "vitlens_tpu") + os.sep
    for p in PT._DEFAULT_PATHS:
        assert not os.path.realpath(p).startswith(jax_pkg), p
    assert os.path.realpath(PT._DEFAULT_PATHS[0]) == os.path.realpath(ours)


def test_entry_points_default_to_the_card(monkeypatch):
    from vitlens_tpu_torch.api import ViTLens
    from vitlens_tpu_torch.factory import create_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ViTLens()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model("ViT-Tiny-Test", "audio")
    assert create_model("ViT-Tiny-Test", "pc", device="cpu").visual.proj.is_cpu


def _fps_args(b=2, n=100):
    return torch.zeros(b, n, 3), torch.zeros(b, dtype=torch.int32), 16


def test_fps_kernel_argument_checks():
    PF._check_cuda_args(*_fps_args())
    xyz, start, npoint = _fps_args()
    with pytest.raises(ValueError, match="float32"):
        PF._check_cuda_args(xyz.half(), start, npoint)
    with pytest.raises(ValueError, match=r"\[B, N, 3\]"):
        PF._check_cuda_args(torch.zeros(2, 100, 4), start, npoint)
    with pytest.raises(ValueError, match="N="):
        PF._check_cuda_args(torch.zeros(2, 0, 3), start, npoint)
    with pytest.raises(ValueError, match="contiguous"):
        PF._check_cuda_args(torch.zeros(3, 100, 2).transpose(0, 2)[:2], start, npoint)
    with pytest.raises(ValueError, match="int32"):
        PF._check_cuda_args(xyz, start.long(), npoint)
    with pytest.raises(ValueError, match="is on"):
        PF._check_cuda_args(xyz, start.to("meta"), npoint)


def _enc_args(m=32, c=(128, 256, 512, 256), nb_dtype=torch.bfloat16):
    c1, c2, c3, c4 = c
    bf, f32 = torch.bfloat16, torch.float32
    bn = lambda n: tuple(torch.zeros(n, dtype=f32) for _ in range(4))  # noqa: E731
    return [torch.zeros(2, 4, m, 3, dtype=nb_dtype),
            torch.zeros(3, c1, dtype=bf), torch.zeros(c1), bn(c1),
            torch.zeros(c1, c2, dtype=bf), torch.zeros(c2),
            torch.zeros(2 * c2, c3, dtype=bf), torch.zeros(c3), bn(c3),
            torch.zeros(c3, c4, dtype=bf), torch.zeros(c4)]


def test_point_encoder_kernel_argument_checks():
    PFE._check_cuda_args(*_enc_args())
    with pytest.raises(ValueError, match="bfloat16"):
        PFE._check_cuda_args(*_enc_args(nb_dtype=torch.float32))
    for m in (16, 48, 128):  # multiples of 16 up to the 128-row tile
        PFE._check_cuda_args(*_enc_args(m=m))
    for m in (8, 24, 144):
        with pytest.raises(ValueError, match="group size"):
            PFE._check_cuda_args(*_enc_args(m=m))
    for c4 in (128, 384, 512):  # any multiple of 128, 256 or 128 a pass
        PFE._check_cuda_args(*_enc_args(c=(128, 256, 512, c4)))
    for c in ((128, 256, 512, 200), (128, 256, 384, 256), (64, 256, 512, 256)):
        with pytest.raises(ValueError, match="widths"):
            PFE._check_cuda_args(*_enc_args(c=c))
    args = _enc_args()
    args[4] = torch.zeros(128, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="w3 must be"):
        PFE._check_cuda_args(*args)  # w2's width no longer matches w3
    args = _enc_args()
    args[1] = torch.zeros(128, 3, dtype=torch.bfloat16).t()
    with pytest.raises(ValueError, match="contiguous"):
        PFE._check_cuda_args(*args)
    args = _enc_args()
    args[2] = args[2].to("meta")
    with pytest.raises(ValueError, match="is on"):
        PFE._check_cuda_args(*args)
