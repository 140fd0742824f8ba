"""The slice end to end on CPU: the port's ViTLens.encode for audio (fbank,
3 clips) and text against the JAX package's ViTLens on the same weights
(the JAX model's export_params(), loaded with weights/from_jax.py) and the
same inputs. ViT-B-16 keeps it to seconds; vitlensL runs the same code."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitlens_tpu.api import ViTLens as JaxViTLens
from vitlens_tpu_torch.api import ViTLens
from vitlens_tpu_torch.weights.from_jax import load_params
from tests.test_torch_threads import share_cores

share_cores()

CAPTIONS = ["a dog barking", "sea waves crashing on rocks", "an engine idles"]
MODALITIES = ("audio", "text")


def _fbank():
    return np.random.RandomState(0).randn(2, 3, 512, 128).astype(np.float32)


def _encode(model, fbank):
    audio = model.encode({"audio": fbank}, preprocessed=True)["audio"]
    text = model.encode({"text": CAPTIONS})["text"]
    return audio, text


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _cosines(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def computing_in(jm, dtype):
    """The JAX ViTLens ``jm`` with compute dtype ``dtype``: its towers
    (weights and state) shared, its jit cache its own. The same model as
    ``JaxViTLens(..., compute_dtype=dtype)`` given ``jm``'s weights, without
    a second random init of every tower."""
    out = copy.copy(jm)
    out.compute_dtype, out._jit_cache = dtype, {}
    return out


@pytest.fixture(scope="module")
def jax_model():
    return JaxViTLens(model_var="vitlensB", modality_loaded=MODALITIES, seed=0)


@pytest.fixture(scope="module")
def jax_params(jax_model):
    return jax_model.export_params()


@pytest.mark.parametrize("dtype,min_cos", [("float32", 0.99999),
                                           ("bfloat16", 0.99)])
def test_encode_matches_jax(jax_model, jax_params, dtype, min_cos):
    """fp32: cosine >= 0.99999 per row. bf16 policy on both sides: cosine
    >= 0.99, computed in fp32."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jm = computing_in(jax_model, jdt)
    pm = ViTLens("vitlensB", MODALITIES, device="cpu", compute_dtype=tdt)
    for m in MODALITIES:
        load_params(pm.towers[m], jax_params[m])
    fbank = _fbank()
    want_a, want_t = _encode(jm, fbank)
    got_a, got_t = _encode(pm, fbank)
    assert tuple(got_a.shape) == (2, 512) and tuple(got_t.shape) == (3, 512)
    for got in (got_a, got_t):
        np.testing.assert_allclose(np.linalg.norm(_np(got), axis=-1), 1.0,
                                   atol=1e-5)
    assert _cosines(got_a, want_a).min() >= min_cos
    assert _cosines(got_t, want_t).min() >= min_cos


def test_batch_buckets_and_single_clip():
    """Padding to a bucket leaves the real rows unchanged; a [B, T, F] fbank
    (one clip) is accepted; a modality the port does not know raises, and
    the depth and video towers (ported since) build."""
    pm = ViTLens("vitlensB", ("audio",), device="cpu", seed=1)
    pm.towers["audio"].trunk.blocks = pm.towers["audio"].trunk.blocks[:2]
    bucketed = ViTLens("vitlensB", ("audio",), device="cpu", seed=1,
                       batch_buckets=(4,))
    bucketed.towers["audio"] = pm.towers["audio"]
    fb = _fbank()[:, 0]
    want = pm.encode({"audio": fb}, preprocessed=True)["audio"]
    got = bucketed.encode({"audio": fb}, preprocessed=True)["audio"]
    assert tuple(got.shape) == (2, 512)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ViTLens("vitlensB", ("thermal",), device="cpu")
    both = ViTLens("vitlensB", ("depth", "video"), device="cpu")
    assert sorted(both.towers) == ["depth", "video"]
