"""The port's int8 (W8A8) quantization on CPU, held against the JAX package's
``quant.py``: the same numpy inputs through both, the weights quantized in JAX
and carried across with ``weights/from_jax.py`` or quantized by the port from
the same float weights. On CPU tensors the int8 product takes its plain
version, so these tests fix the arithmetic the CUDA kernel is held to on the
card, and that a quantized block reaches neither fused kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitlens_tpu import quant as JQ
from vitlens_tpu.config import make_model_config as jax_model_config
from vitlens_tpu.models import layers as JL
from vitlens_tpu.models import tri as JT
from vitlens_tpu_torch import quant as PQ
from vitlens_tpu_torch.factory import create_model
from vitlens_tpu_torch.models import layers as PL
from vitlens_tpu_torch.models import tri as PT
from vitlens_tpu_torch.ops import fused_ln_proj as PFL
from vitlens_tpu_torch.ops import fused_mlp as PFM
from vitlens_tpu_torch.ops import int8_matmul as PI
from vitlens_tpu_torch.weights.from_jax import flatten, load_params, load_tri_params
from tests.test_torch_threads import share_cores

share_cores()


def _cos_min(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return ((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                               * np.linalg.norm(b, axis=-1))).min()


@pytest.mark.parametrize("shape", [(64, 48), (3, 32, 16)])
def test_quantize_weight_matches_jax(shape):
    """q equal, s within 1e-7 relative (the same fp32 division), also on a
    stacked [L, K, N] weight; a zero column takes the 1e-12 floor."""
    w = (np.random.RandomState(0).randn(*shape) * 0.1).astype(np.float32)
    w[..., 3] = 0.0
    want_q, want_s = JQ.quantize_weight(jnp.asarray(w))
    q, s = PQ.quantize_weight(torch.from_numpy(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == shape[:-2] + (1, shape[-1])
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=1e-7, atol=0)
    assert float(s[..., 3].max()) == pytest.approx(1e-12)


@pytest.mark.parametrize("shape,bias", [((17, 96), True), ((2, 5, 96), False)])
def test_int8_matmul_matches_jax(shape, bias):
    """Rank 2 with bias and rank 3 without, against JAX's int8_matmul on the
    same quantized weight: rtol 1e-5 / atol 1e-5 (the integer product is
    exact on both sides; the fp32 scales multiply in the same order)."""
    rng = np.random.RandomState(2)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(96, 40) * 0.05).astype(np.float32)
    b = rng.randn(40).astype(np.float32) if bias else None
    wq, ws = JQ.quantize_weight(jnp.asarray(w))
    want = JQ.int8_matmul(jnp.asarray(x), wq, ws,
                          None if b is None else jnp.asarray(b))
    got = PQ.int8_matmul(torch.from_numpy(x), torch.from_numpy(np.asarray(wq)),
                         torch.from_numpy(np.asarray(ws)),
                         None if b is None else torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:-1] + (40,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    flat = PQ.int8_matmul(torch.from_numpy(x).reshape(-1, 96),
                          *PQ.quantize_weight(torch.from_numpy(w)),
                          None if b is None else torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy().reshape(-1, 40), flat.numpy(), rtol=1e-6)


def test_int8_matmul_keeps_the_activation_dtype():
    x = torch.randn(4, 32, generator=torch.Generator().manual_seed(0)).bfloat16()
    q, s = PQ.quantize_weight(torch.randn(32, 128))
    assert PQ.int8_matmul(x, q, s).dtype == torch.bfloat16


def test_int8_product_reference_is_exact():
    """The plain int8 product against numpy int64, at the operands' extremes
    too."""
    rng = np.random.RandomState(1)
    a = rng.randint(-127, 128, (33, 160)).astype(np.int8)
    b = rng.randint(-127, 128, (160, 128)).astype(np.int8)
    a[0], b[:, 0] = -127, 127
    got = PI.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


def _quantized_block_pair(seed=0, dim=64):
    """A JAX resblock quantized by JAX and the port's block holding the same
    int8 tree."""
    p = JL.resblock_init(jax.random.PRNGKey(seed), dim)
    pq = JQ.quantize_resblocks(p)
    block = PQ.quantize_resblocks(PL.ResBlock(dim, 4))
    load_params(block, pq)
    return p, pq, block


def test_quantized_resblock_matches_jax():
    """A quantized block against JAX's on the int8 tree made in JAX and
    carried across. One activation that rounds to the other side of a half
    flips one int8 step, so bit-equality is not asked: cosine >= 0.9999 and
    2e-3 of max|ref| absolute."""
    p, pq, block = _quantized_block_pair()
    assert block.quantized and block.attn.qkv_w is None and block.mlp.fc.w is None
    x = (np.random.RandomState(4).randn(2, 9, 64) * 0.3).astype(np.float32)
    want = np.asarray(JL.resblock(jnp.asarray(x), pq, heads=4, act=JL.gelu))
    got = block(torch.from_numpy(x)).numpy()
    assert _cos_min(got.reshape(-1, 64), want.reshape(-1, 64)) >= 0.9999
    assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()
    ref = np.asarray(JL.resblock(jnp.asarray(x), p, heads=4, act=JL.gelu))
    assert _cos_min(got.reshape(1, -1), ref.reshape(1, -1)) > 0.999


def test_port_quantized_buffers_equal_jax_quantized():
    """Quantizing the float weights in the port gives the buffers that
    quantizing them in JAX and carrying them across gives, and the
    transposed copies the kernel reads are w_q's transposes."""
    p = JL.transformer_init(jax.random.PRNGKey(1), 64, 2)
    ours = PQ.quantize_resblocks(load_params(PL.Transformer(64, 2, 4), p))
    theirs = load_params(PQ.quantize_resblocks(PL.Transformer(64, 2, 4)),
                         {"blocks": JQ.quantize_resblocks(p["blocks"])})
    a, b = dict(ours.named_buffers()), dict(theirs.named_buffers())
    assert set(a) == set(b) and len(a) == 2 * 4 * 3
    for name in a:
        if name.endswith("_s"):
            np.testing.assert_allclose(a[name].numpy(), b[name].numpy(),
                                       rtol=1e-7, atol=0)
        else:
            assert torch.equal(a[name], b[name]), name
        if name.endswith("_qt"):
            assert a[name].is_contiguous()
            assert torch.equal(a[name], a[name[:-1]].t())
    assert [n for n, _ in ours.blocks[0].mlp.fc.named_parameters()] == ["b"]
    flat = flatten({"blocks": JQ.quantize_resblocks(p["blocks"])})
    assert flat["blocks.1.attn.qkv_w_q"].dtype == np.int8
    assert flat["blocks.1.mlp.fc.w_s"].shape == (1, 256)


def _tiny_models(towers):
    cfg = jax_model_config("ViT-Tiny-Test", "audio")
    params, state = JT.tri_model_init(jax.random.PRNGKey(6), cfg)
    qparams = dict(params)
    for t in towers:
        qparams[t] = JQ.quantize_tower_params(params[t])
    model = load_tri_params(create_model("ViT-Tiny-Test", "audio", device="cpu"),
                            params)
    return cfg, params, qparams, state, model


def test_quantized_encode_matches_jax():
    """ViT-Tiny-Test audio, both towers quantized in JAX and the int8 tree
    carried into the port's quantized copy: encode_visual and encode_text
    (normalized) hold cosine >= 0.9999 and 5e-3 absolute against JAX's."""
    cfg, params, qparams, state, model = _tiny_models(("visual", "text"))
    qmodel = load_tri_params(PQ.quantize_model(model, towers=("visual", "text")),
                             qparams)
    fbank = np.random.RandomState(5).randn(2, 512, 128).astype(np.float32)
    ids = np.zeros((3, 77), np.int32)
    ids[:, 0], ids[:, 1], ids[:, 2] = 49406, (320, 1929, 530), 49407
    want_v, _ = JT.encode_visual(qparams, state, jnp.asarray(fbank), cfg,
                                 normalize=True)
    want_t = JT.encode_text(qparams, jnp.asarray(ids), cfg, normalize=True)
    got_v = PT.encode_visual(qmodel, torch.from_numpy(fbank), normalize=True)
    got_t = PT.encode_text(qmodel, torch.from_numpy(ids).long(), normalize=True)
    for got, want in ((got_v, want_v), (got_t, want_t)):
        assert _cos_min(got.numpy(), want) >= 0.9999
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 5e-3
    # and the port's own quantization of the float weights gives the same
    own = PQ.quantize_model(model, towers=("visual", "text"))
    own_v = PT.encode_visual(own, torch.from_numpy(fbank), normalize=True)
    assert _cos_min(own_v.numpy(), want_v) >= 0.9999


def test_quantize_model_returns_a_copy_and_is_quantized():
    """The original model is untouched (as tests/test_quant.py asks of JAX),
    only the named towers change, a tower the model lacks is skipped, and no
    parameter of the quantized copy asks for a gradient."""
    *_, model = _tiny_models(())
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    qmodel = PQ.quantize_model(model, towers=("visual", "sketch"))
    assert PQ.is_quantized(qmodel.visual) and not PQ.is_quantized(qmodel.text)
    assert not PQ.is_quantized(model.visual)
    assert not PQ.is_quantized(model.visual.adapter)  # no trunk: False
    after = dict(model.named_parameters())
    assert set(after) == set(before)
    assert all(torch.equal(after[n], before[n]) for n in before)
    assert not list(model.buffers())
    assert not any(p.requires_grad for p in qmodel.parameters())
    # the Lens, the adapter and the text tower keep their float weights
    kept = dict(qmodel.named_parameters())
    assert "visual.perceiver.layers.0.cross_attn.attn.to_q.w" in kept
    assert "text.trunk.blocks.0.mlp.fc.w" in kept
    assert "visual.trunk.blocks.0.mlp.fc.w" not in kept
    assert qmodel.visual.trunk.blocks[1].mlp.proj.w_q.dtype == torch.int8
    # quantizing twice is a no-op
    again = PQ.quantize_model(qmodel)
    assert torch.equal(again.visual.trunk.blocks[0].attn.qkv_w_q,
                       qmodel.visual.trunk.blocks[0].attn.qkv_w_q)


def test_vitlens_api_encodes_with_a_quantized_tower():
    """A ViTLens whose audio tower was replaced by its quantized copy encodes
    through the same entry point and tracks the float model."""
    from vitlens_tpu_torch.api import ViTLens

    vl = ViTLens("vitlensB", ("audio", "text"), device="cpu", seed=0)
    # full ViT-B is too wide for a CPU test: cut the trunks to 2 blocks
    for tower in vl.towers.values():
        del tower.trunk.blocks[2:]
    qvl = PQ.quantize_model(vl, towers=("towers.audio",))
    assert PQ.is_quantized(qvl.towers["audio"])
    assert not PQ.is_quantized(qvl.towers["text"])
    assert not PQ.is_quantized(vl.towers["audio"])
    fbank = torch.from_numpy(
        np.random.RandomState(7).randn(2, 512, 128).astype(np.float32) * 0.5)
    a = vl.encode({"audio": fbank}, preprocessed=True)["audio"]
    b = qvl.encode({"audio": fbank}, preprocessed=True)["audio"]
    assert tuple(b.shape) == tuple(a.shape)
    assert _cos_min(a.numpy(), b.numpy()) > 0.99


@pytest.mark.parametrize("opt_in", [False, True])
def test_quantized_block_reaches_no_fused_kernel(opt_in, monkeypatch):
    """A quantized block takes the plain composition for both halves: it
    never calls fused_mlp or fused_ln_proj (their wrappers are not entered
    and their launch counters stay 0), also with the fused LN + qkv opt-in
    set and in bf16, where a float block does call them."""
    calls = {"mlp": 0, "ln_proj": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(PL, "fused_mlp", spy("mlp", PL.fused_mlp))
    monkeypatch.setattr(PL, "fused_ln_qkv", spy("ln_proj", PL.fused_ln_qkv))
    if opt_in:
        monkeypatch.setenv("VITLENS_ENABLE_FUSED_LNQKV", "1")
    else:
        monkeypatch.delenv("VITLENS_ENABLE_FUSED_LNQKV", raising=False)
    p = JL.resblock_init(jax.random.PRNGKey(3), 128)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 5, 128)
                         .astype(np.float32)).bfloat16()
    block = load_params(PL.ResBlock(128, 4), p)
    want = block(x)
    assert calls == {"mlp": 1, "ln_proj": int(opt_in)}
    calls.update(mlp=0, ln_proj=0)
    got = PQ.quantize_resblocks(block)(x)
    assert calls == {"mlp": 0, "ln_proj": 0}
    assert PFM.fused_mlp.launches == 0 and PFL.fused_ln_proj.launches == 0
    assert PI.int8_matmul.launches == 0  # CPU tensors launch nothing
    assert _cos_min(got.float().reshape(1, -1).numpy(),
                    want.float().reshape(1, -1).numpy()) > 0.99


def test_int8_kernel_argument_checks():
    a = torch.zeros(8, 64, dtype=torch.int8)
    b = torch.zeros(64, 128, dtype=torch.int8)
    PI._check_cuda_args(a, b, b.t().contiguous())
    with pytest.raises(ValueError, match="multiple of 32"):
        PI._check_cuda_args(torch.zeros(8, 48, dtype=torch.int8),
                            torch.zeros(48, 128, dtype=torch.int8),
                            torch.zeros(128, 48, dtype=torch.int8))
    with pytest.raises(ValueError, match="of 128"):
        PI._check_cuda_args(a, torch.zeros(64, 96, dtype=torch.int8),
                            torch.zeros(96, 64, dtype=torch.int8))
    with pytest.raises(ValueError, match="torch.int8"):
        PI._check_cuda_args(a.to(torch.int32), b, b.t().contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        PI._check_cuda_args(a, b, b.t())
    with pytest.raises(ValueError, match=r"b_t must be \(128, 64\)"):
        PI._check_cuda_args(a, b, b.contiguous())
    with pytest.raises(ValueError, match="is on"):
        PI._check_cuda_args(a, b, b.t().contiguous().to("meta"))
