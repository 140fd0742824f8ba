"""The image and tactile path of the port on CPU against the JAX package:
the host processors bit for bit, the image tower against
``vision_tower_apply`` with the image tower config, and ``ViTLens`` encodes
of image, tactile and raw audio files against JAX's ``ViTLens`` with the
same weights (the JAX model's ``export_params()``, loaded with
weights/from_jax.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tools.reference_layout import pcm_from_float, write_flac, write_wav
from vitlens_tpu.api import ViTLens as JaxViTLens
from vitlens_tpu.config import image_tower_config as jax_image_tower_config
from vitlens_tpu.config import make_model_config as jax_model_config
from vitlens_tpu.data import processors as JP
from vitlens_tpu.models.vit import vision_tower_init
from vitlens_tpu_torch import config as PC
from vitlens_tpu_torch.adapters.tokenizers import patchify_2d
from vitlens_tpu_torch.api import ViTLens
from vitlens_tpu_torch.data import processors as PP
from vitlens_tpu_torch.models.vit import VisionTower
from vitlens_tpu_torch.weights.from_jax import load_params
from tests.test_torch_api import computing_in
from tests.test_torch_depth_eeg_video import _jax_tower
from tests.test_torch_threads import share_cores

share_cores()


def _cos(a, b) -> np.ndarray:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _image(w: int, h: int, mode: str = "RGB", seed: int = 0) -> Image.Image:
    """A smooth gradient plus noise, so that resampling has work to do."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx / w, yy / h, (xx + yy) / (w + h)], -1) * 200
    arr = np.clip(base + rng.randint(0, 55, (h, w, 3)), 0, 255).astype(np.uint8)
    img = Image.fromarray(arr, "RGB")
    return img.convert(mode) if mode != "RGB" else img


@pytest.mark.parametrize("size,mode", [((320, 240), "RGB"), ((240, 320), "L"),
                                       ((224, 224), "RGB"), ((97, 500), "RGBA")])
@pytest.mark.parametrize("proc", ["ImageProcessor", "TactileProcessor"])
def test_processors_bit_equal(tmp_path, size, mode, proc):
    """PIL images and PNG/JPEG paths, landscape, portrait, square, gray."""
    img = _image(*size, mode=mode)
    png = str(tmp_path / "a.png")
    img.save(png)
    jpg = str(tmp_path / "a.jpg")
    img.convert("RGB").save(jpg, quality=90)
    items = [img, png, jpg]
    want = getattr(JP, proc)()(items)
    got = getattr(PP, proc)()(items)
    assert got.dtype == np.float32 and got.shape == (3, 3, 224, 224)
    np.testing.assert_array_equal(got, want)


def test_patchify_matches_a_conv():
    x = torch.randn(2, 3, 28, 28, generator=torch.Generator().manual_seed(0))
    w = torch.randn(8, 3, 14, 14, generator=torch.Generator().manual_seed(1))
    want = torch.nn.functional.conv2d(x, w, stride=14).flatten(2).transpose(1, 2)
    got = patchify_2d(x, 14) @ w.reshape(8, -1).T
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("modality", ["image", "tactile"])
def test_image_tower_matches_jax(modality):
    """fp32 within 1e-5 of max|ref|; bf16 compute on both sides by cosine
    computed in fp32."""
    if modality == "image":
        jcfg = jax_image_tower_config(jax_model_config("ViT-B-16", "image"))
        pcfg = PC.image_tower_config(PC.make_model_config("ViT-B-16", "image"))
    else:
        jcfg = jax_model_config("ViT-B-16", "tactile").tower
        pcfg = PC.make_model_config("ViT-B-16", "tactile").tower
    jcfg = jcfg.__class__(**{**jcfg.__dict__, "arch": jcfg.arch.__class__(
        **{**jcfg.arch.__dict__, "layers": 3})})
    pcfg = pcfg.__class__(**{**pcfg.__dict__, "arch": pcfg.arch.__class__(
        **{**pcfg.arch.__dict__, "layers": 3})})
    p, s = vision_tower_init(jax.random.PRNGKey(7), jcfg)
    x = np.random.RandomState(7).randn(2, 3, 224, 224).astype(np.float32)
    tower = load_params(VisionTower(pcfg), p)
    assert tower.perceiver is None and tuple(tower.adapter.conv1.w.shape) == (768, 768)
    want, want16 = _jax_tower(p, s, jnp.asarray(x), jcfg)
    got = tower(torch.from_numpy(x))
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-5
    got16 = tower(torch.from_numpy(x), torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    assert _cos(_np(got16), _np(want16)).min() >= 0.99


MODALITIES = ("image", "tactile", "audio")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("media")
    imgs = []
    for i, (size, mode) in enumerate((((320, 240), "RGB"), ((240, 320), "L"))):
        path = str(d / f"im{i}.{'png' if i else 'jpg'}")
        _image(*size, mode=mode, seed=i).save(path)
        imgs.append(path)
    rng = np.random.RandomState(3)
    sounds = []
    for i, (rate, secs, ch, kind) in enumerate(((16000, 5.0, 1, "wav"),
                                                (22050, 7.0, 2, "flac"))):
        t = np.arange(int(rate * secs)) / rate
        x = 0.3 * np.sin(2 * np.pi * 500 * (i + 1) * t) + 0.05 * rng.randn(ch, t.size)
        path = str(d / f"a{i}.{kind}")
        pcm = pcm_from_float(x, 16)
        if kind == "wav":
            write_wav(path, pcm, rate)
        else:
            write_flac(path, pcm, rate, 16, "fixed", 2, "left_side")
        sounds.append(path)
    return {"image": imgs, "tactile": imgs, "audio": sounds}


@pytest.fixture(scope="module")
def jax_model():
    return JaxViTLens(model_var="vitlensB", modality_loaded=MODALITIES, seed=0)


@pytest.fixture(scope="module")
def jax_params(jax_model):
    return jax_model.export_params()


@pytest.mark.parametrize("dtype,min_cos", [("float32", 0.9999),
                                           ("bfloat16", 0.99)])
def test_vitlens_encodes_files_like_jax(files, jax_model, jax_params, dtype,
                                        min_cos):
    """Image, tactile and audio files (WAV and FLAC, resampled, 3 clips)
    through both ViTLens.encode with no preprocessed flag; the same weights
    on both sides. fp32: cosine >= 0.9999 per row (the fbanks differ by up
    to 2e-4); bf16 compute on both sides: >= 0.99."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jm = computing_in(jax_model, jdt)
    pm = ViTLens("vitlensB", MODALITIES, device="cpu", compute_dtype=tdt)
    for m in MODALITIES:
        load_params(pm.towers[m], jax_params[m])
    for m in MODALITIES:
        want = jm.encode({m: files[m]})[m]
        got = pm.encode({m: files[m]})[m]
        assert tuple(got.shape) == (2, 512)
        np.testing.assert_allclose(np.linalg.norm(_np(got), axis=-1), 1.0,
                                   atol=1e-5)
        assert _cos(_np(got), _np(want)).min() >= min_cos, m


def test_vitlens_raw_waveform_runs_the_tower_fbank(jax_model, jax_params):
    """A preprocessed [B, samples] waveform reaches the tower's fbank
    branch: equal to JAX's on-device fbank path, and to the host processor's
    fbank of the same samples as one clip."""
    jm = computing_in(jax_model, jnp.float32)
    pm = ViTLens("vitlensB", ("audio",), device="cpu")
    load_params(pm.towers["audio"], jax_params["audio"])
    wave = (0.1 * np.random.RandomState(5).randn(2, 80000)).astype(np.float32)
    want = jm.encode({"audio": wave}, preprocessed=True)["audio"]
    got = pm.encode({"audio": wave}, preprocessed=True)["audio"]
    assert _cos(_np(got), _np(want)).min() >= 0.99999
    fb = pm.processors["audio"].fbank(wave)
    host = pm.encode({"audio": fb}, preprocessed=True)["audio"]
    torch.testing.assert_close(got, host, rtol=0, atol=1e-6)
