"""The depth, EEG and video path of the port on CPU against the JAX package:
the adapters, the towers (with the identity, Perceiver and transformer
Lens) against ``vision_tower_apply``, the host processors bit for bit, the
converter tree for tree on state dicts from tools/reference_layout.py,
``create_model`` and ``ViTLens`` encodes of files with the same weights
(the JAX model's ``export_params()``, loaded with weights/from_jax.py) and
the warmup shapes. Trunks are ViT-B-16 cut to 3 blocks, or the tiny test
trunk for the converter."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tools import reference_layout as RL
from vitlens_tpu.adapters import tokenizers as JTok
from vitlens_tpu.api import ViTLens as JaxViTLens
from vitlens_tpu.config import make_model_config as jax_model_config
from vitlens_tpu.data import processors as JP
from vitlens_tpu.data import video_processors as JV
from vitlens_tpu.models import tri as JT
from vitlens_tpu.models.vit import vision_tower_apply, vision_tower_init
from vitlens_tpu.weights import torch_convert as JC
from vitlens_tpu_torch import config as PC
from vitlens_tpu_torch.adapters.tokenizers import DepthAdapter, EEGAdapter
from vitlens_tpu_torch.api import ViTLens
from vitlens_tpu_torch.data import processors as PP
from vitlens_tpu_torch.data import video_processors as PV
from vitlens_tpu_torch.data.rng import ThreadLocalRNG
from vitlens_tpu_torch.models.vit import VisionTower
from vitlens_tpu_torch.weights import torch_convert as PCV
from vitlens_tpu_torch.weights.from_jax import flatten, load_params, load_state
from tests.test_torch_api import computing_in
from tests.test_torch_threads import share_cores

share_cores()

NEW = ("depth", "eeg", "video")


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


def _cos(a, b) -> np.ndarray:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _cut(cfg, layers=3):
    """A tower config (JAX's or the port's) with its trunk cut to
    ``layers`` blocks."""
    return dataclasses.replace(cfg, arch=dataclasses.replace(cfg.arch, layers=layers))


def _inputs(modality, cfg, b=2, seed=0):
    hw = cfg.arch.image_size
    if modality == "depth":
        shape = (b, 1, hw, hw)
    elif modality == "eeg":
        shape = (b, cfg.eeg.chans, cfg.eeg.time_len)
    else:
        shape = (b, cfg.video.n_frames, 3, hw, hw)
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -- adapters ---------------------------------------------------------------


@pytest.mark.parametrize("kind", ["depth", "eeg_w1", "eeg_w3_s2"])
def test_adapters_match_jax(kind):
    """Tokens and positions of the depth patch embedding and the EEG Conv1d
    (the released window 1 / stride 1 and window 3 / stride 2, where the
    chans-major flattening shows), fp32 within 1e-5 of max|ref|."""
    modality = kind.split("_")[0]
    jcfg = jax_model_config("ViT-B-16", modality).tower
    pcfg = PC.make_model_config("ViT-B-16", modality).tower
    if kind == "eeg_w3_s2":
        jcfg = dataclasses.replace(jcfg, eeg=dataclasses.replace(
            jcfg.eeg, window_size=3, stride=2))
        pcfg = dataclasses.replace(pcfg, eeg=dataclasses.replace(
            pcfg.eeg, window_size=3, stride=2))
    init = JTok.depth_adapter_init if modality == "depth" else JTok.eeg_adapter_init
    p, s = init(jax.random.PRNGKey(3), jcfg)
    x = _inputs(modality, pcfg, seed=3)
    if modality == "depth":
        (want, want_pos), _ = JTok.depth_adapter_apply(p, s, jnp.asarray(x))
        adapter = load_params(DepthAdapter(pcfg), p)
    else:
        (want, want_pos), _ = JTok.eeg_adapter_apply(p, s, jnp.asarray(x), jcfg.eeg)
        adapter = load_params(EEGAdapter(pcfg), p)
    got, got_pos = adapter(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    if kind == "eeg_w3_s2":
        assert got.shape[1] == 255 and tuple(adapter.proj.w.shape) == (384, 768)
    assert _rel(got.numpy(), want) < 1e-5
    np.testing.assert_array_equal(got_pos.detach().numpy(), np.asarray(want_pos))


# -- towers -----------------------------------------------------------------

TOWERS = {
    "depth": ("depth", {}),
    "eeg": ("eeg", {}),
    "video": ("video", {}),
    "depth_transformer_lens": ("depth", {"as_transformer": True, "as_identity": False,
                                         "depth": 2}),
    "video_no_ltpos": ("video", {"use_ltpos": False}),
}


def _tower_cfgs(name):
    modality, change = TOWERS[name]
    cfgs = []
    for make in (jax_model_config, PC.make_model_config):
        cfg = make("ViT-B-16", modality).tower
        if "use_ltpos" in change:
            cfg = dataclasses.replace(cfg, video=dataclasses.replace(
                cfg.video, **change))
        elif change:
            cfg = dataclasses.replace(cfg, perceiver=dataclasses.replace(
                cfg.perceiver, **change))
        cfgs.append(_cut(cfg))
    return cfgs


def _jax_tower(p, s, x, jcfg):
    """vision_tower_apply's features in fp32 and under bf16 compute, each
    one jax.jit of the tower (op-by-op dispatch of a ViT-B-wide tower costs
    several times its compile)."""
    return [jax.jit(lambda p_, s_, x_: vision_tower_apply(
        p_, s_, x_, jcfg, compute_dtype=dt)[0])(p, s, x)
        for dt in (jnp.float32, jnp.bfloat16)]


@pytest.mark.parametrize("name", list(TOWERS))
def test_towers_match_jax(name):
    """The whole tower against ``vision_tower_apply`` with JAX's weights:
    fp32 within 1e-5 of max|ref|; bf16 compute on both sides at cosine >=
    0.99 (computed in fp32). The depth tower runs the identity Lens, the
    EEG tower a Perceiver of depth 1, the video tower one of depth 2 over 8
    frames; the transformer Lens is 2 plain blocks at trunk width."""
    jcfg, pcfg = _tower_cfgs(name)
    modality = pcfg.modality
    p, s = vision_tower_init(jax.random.PRNGKey(11), jcfg)
    tower = load_params(VisionTower(pcfg), p)
    if name == "depth":
        assert tower.perceiver is None and tower.perceiver_transformer is None
    if name == "depth_transformer_lens":
        assert len(tower.perceiver_transformer.blocks) == 2
    if name == "video_no_ltpos":
        assert tower.adapter.ltpos is None and "ltpos" not in p["adapter"]
    x = _inputs(modality, pcfg, seed=11)
    want, want16 = _jax_tower(p, s, jnp.asarray(x), jcfg)
    got = tower(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 512)
    assert _rel(got.numpy(), want) < 1e-5
    got16 = tower(torch.from_numpy(x), torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    assert _cos(_np(got16), _np(want16)).min() >= 0.99


def test_create_model_encodes_the_new_modalities():
    """create_model builds the depth, EEG and video Lens + text models;
    with JAX's weights loaded, tri.encode_visual (normalized) matches JAX's
    to 1e-4 in fp32."""
    from vitlens_tpu_torch.factory import create_model
    from vitlens_tpu_torch.models import tri as PT

    for i, m in enumerate(NEW):
        cfg = jax_model_config("ViT-Tiny-Test", m)
        params, state = JT.tri_model_init(jax.random.PRNGKey(20 + i), cfg)
        model = create_model("ViT-Tiny-Test", m, device="cpu")
        load_params(model.visual, params["visual"])
        x = _inputs(m, model.cfg.tower, seed=i)
        want, _ = jax.jit(lambda p, s, v: JT.encode_visual(
            p, s, v, cfg, normalize=True))(params, state, jnp.asarray(x))
        got = PT.encode_visual(model, torch.from_numpy(x), normalize=True)
        assert _rel(got.detach().numpy(), want) < 1e-4, m


# -- host processors ----------------------------------------------------------


def _disparity(h, w, seed):
    """A smooth disparity map with noise, spanning the clamp range."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return (80.0 * (xx / w) * (yy / h) + rng.rand(h, w) * 3.0).astype(np.float32)


def test_depth_processor_bit_equal(tmp_path):
    """Arrays [H, W] and [1, H, W], .npy, .npz, 16-bit .png and .pt paths,
    landscape and portrait: equal to JAX's DepthProcessor."""
    land, port = _disparity(240, 320, 0), _disparity(300, 200, 1)
    npy, npz = str(tmp_path / "d.npy"), str(tmp_path / "d.npz")
    png, pt = str(tmp_path / "d.png"), str(tmp_path / "d.pt")
    np.save(npy, land)
    np.savez(npz, port)
    Image.fromarray((port * 700).astype(np.uint16)).save(png)
    torch.save(torch.from_numpy(land), pt)
    with Image.open(png) as img:
        assert img.mode.startswith("I")  # a 16-bit PNG, not 8-bit
    items = [land, port[None], npy, png, pt]
    want = JP.DepthProcessor()(items)
    got = PP.DepthProcessor()(items)
    assert got.dtype == np.float32 and got.shape == (5, 1, 224, 224)
    np.testing.assert_array_equal(got, want)


def test_eeg_processor_bit_equal(tmp_path):
    """An array and a .pt file [128, 500]: crop t[20:460], resample to 512."""
    rng = np.random.RandomState(2)
    eeg = rng.randn(128, 500).astype(np.float32)
    pt = str(tmp_path / "e.pt")
    torch.save(torch.from_numpy(rng.randn(128, 500)), pt)  # float64 on disk
    items = [eeg, pt]
    want = JP.EEGProcessor()(items)
    got = PP.EEGProcessor()(items)
    assert got.dtype == np.float32 and got.shape == (2, 128, 512)
    np.testing.assert_array_equal(got, want)


def _frames(n, w=320, h=240, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        base = np.stack([xx / w, yy / h, ((xx + 7 * i) % w) / w], -1) * 200
        out.append(np.clip(base + rng.randint(0, 55, (h, w, 3)), 0, 255)
                   .astype(np.uint8))
    return np.stack(out)


def _frame_dir(root, frames, ext="jpg"):
    os.makedirs(root, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(root, f"{i:05d}.{ext}"))
    return root


@pytest.mark.parametrize("three_crop", [False, True])
def test_video_processor_bit_equal(tmp_path, three_crop):
    """A 12-frame jpg directory, a 5-frame png directory (fewer frames than
    n_frames: frames repeat), a portrait frame array and a list of PIL
    images: equal to JAX's eval VideoProcessor, centre crop and three-crop."""
    long_dir = _frame_dir(str(tmp_path / "long"), _frames(12, seed=1))
    short_dir = _frame_dir(str(tmp_path / "short"), _frames(5, seed=2), "png")
    portrait = _frames(9, w=200, h=300, seed=3)
    pil = [Image.fromarray(f) for f in _frames(8, seed=4)]
    items = [long_dir, short_dir, portrait, pil]
    want = JV.VideoProcessor(three_crop=three_crop)(items)
    got = PV.VideoProcessor(three_crop=three_crop)(items)
    shape = (4, 3, 8, 3, 224, 224) if three_crop else (4, 8, 3, 224, 224)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, want)


def test_video_sampling_and_refusals(tmp_path):
    """Frame indices equal JAX's at every clip length around n_frames (and
    with fix_start); a video file with no decode_fn raises RuntimeError as
    in JAX, and decode_fn output is taken, by the train transforms too
    (bit for bit against JAX's, from the same seed); the thread-local RNG's
    first stream is RandomState(seed)."""
    for total in (1, 3, 7, 8, 9, 16, 31, 300):
        np.testing.assert_array_equal(PV.sample_frame_indices(total, 8),
                                      JV.sample_frame_indices(total, 8))
        np.testing.assert_array_equal(
            PV.sample_frame_indices(total, 8, fix_start=1),
            JV.sample_frame_indices(total, 8, fix_start=1))
    with pytest.raises(ValueError, match="empty"):
        PV.sample_frame_indices(0, 8)
    path = str(tmp_path / "clip.mp4")
    open(path, "wb").close()
    with pytest.raises(RuntimeError, match="decode_fn"):
        PV.VideoProcessor()([path])
    frames = _frames(10, seed=5)
    got = PV.VideoProcessor(decode_fn=lambda p: frames)([path])
    np.testing.assert_array_equal(got, JV.VideoProcessor()([frames]))
    got = PV.VideoProcessor(train=True, seed=3, decode_fn=lambda p: frames)([path])
    np.testing.assert_array_equal(
        got, JV.VideoProcessor(train=True, seed=3, decode_fn=lambda p: frames)([path]))
    rng = ThreadLocalRNG(7)
    np.testing.assert_array_equal(rng.randint(0, 100, 5),
                                  np.random.RandomState(7).randint(0, 100, 5))


def test_default_processors_registry():
    """All but video by default, as in JAX; video on request."""
    procs = PP.default_processors()
    assert sorted(procs) == sorted(JP.default_processors())
    assert "video" not in procs and isinstance(procs["depth"], PP.DepthProcessor)
    assert isinstance(procs["eeg"], PP.EEGProcessor)
    assert isinstance(PP.default_processors(["video"])["video"], PV.VideoProcessor)


# -- checkpoints ---------------------------------------------------------------

CKPT = {
    "depth": ("depth", {}),
    "eeg": ("eeg", {}),
    "eeg_w3_s2": ("eeg", {"eeg": {"window_size": 3, "stride": 2}}),
    "video": ("video", {}),
    "video_no_ltpos": ("video", {"video": {"use_ltpos": False}}),
    "depth_transformer_lens": ("depth", {"perceiver": {
        "as_transformer": True, "as_identity": False, "depth": 2}}),
}


def _ckpt_cfgs(name):
    modality, change = CKPT[name]
    out = []
    for make in (jax_model_config, PC.make_model_config):
        cfg = make("ViT-Tiny-Test", modality).tower
        for field, kw in change.items():
            cfg = dataclasses.replace(cfg, **{field: dataclasses.replace(
                getattr(cfg, field), **kw)})
        out.append(cfg)
    return out


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}.{i}")
    else:
        assert isinstance(got, np.ndarray) and got.dtype == np.float32, path
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=path)


@pytest.mark.parametrize("name", list(CKPT))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_converter_matches_jax(name, dtype):
    """Reference-layout state dicts of each new tower (the video tower's
    conv1 and ltpos at the tower's top level, the depth and EEG adapters
    under visual_adapter., the transformer Lens as perceiver.resblocks.*,
    no Lens key for the identity): the port's tree equals JAX's exactly, and
    loads into the port's tower with no key left over on either side."""
    jcfg, pcfg = _ckpt_cfgs(name)
    sd = RL.vision_tower_state_dict(pcfg, torch.Generator().manual_seed(4), dtype)
    if name == "depth":
        assert not any(k.startswith("perceiver.") for k in sd)
    if name == "depth_transformer_lens":
        assert "perceiver.resblocks.1.attn.in_proj_weight" in sd
    assert ("ltpos.weight" in sd) == (name == "video")
    want_p, want_s = JC.convert_vision_tower(sd, jcfg)
    got_p, got_s = PCV.convert_vision_tower(sd, pcfg)
    _assert_trees_equal(got_p, jax.tree.map(np.asarray, want_p))
    _assert_trees_equal(got_s, jax.tree.map(np.asarray, want_s))
    tower = VisionTower(pcfg)
    load_params(tower, got_p)  # strict: raises on a key left over
    load_state(tower, got_s)
    named = dict(tower.named_parameters())
    flat = flatten(want_p)
    assert sorted(named) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(named[k].detach().numpy(),
                                      np.asarray(v, np.float32), err_msg=k)


def test_jax_trees_copy_into_the_new_towers():
    """A JAX vision_tower_init tree of each new tower (and of the
    transformer-Lens and no-ltpos variants) copies into the port's tower
    with no key left over on either side."""
    for name in TOWERS:
        jcfg, pcfg = _tower_cfgs(name)
        p, _ = vision_tower_init(jax.random.PRNGKey(0), jcfg)
        tower = load_params(VisionTower(pcfg), p)
        assert sorted(dict(tower.named_parameters())) == sorted(flatten(p)), name


# -- ViTLens --------------------------------------------------------------------

MODALITIES = ("depth", "eeg", "video", "text")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("media")
    npy, png, pt = str(d / "d.npy"), str(d / "d.png"), str(d / "e.pt")
    np.save(npy, _disparity(240, 320, 5))
    Image.fromarray((_disparity(300, 200, 6) * 700).astype(np.uint16)).save(png)
    torch.save(torch.from_numpy(np.random.RandomState(7).randn(128, 480)
                                .astype(np.float32)), pt)
    eeg2 = np.random.RandomState(8).randn(128, 500).astype(np.float32)
    return {"depth": [npy, png], "eeg": [pt, eeg2],
            "video": [_frame_dir(str(d / "v12"), _frames(12, seed=9)),
                      _frame_dir(str(d / "v5"), _frames(5, w=200, h=300, seed=10),
                                 "png")],
            "text": ["a dark room", "brain waves"]}


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
    """Depth (.npy, 16-bit .png), EEG (.pt, an array), video (frame
    directories of 12 and 5 frames) and captions through both
    ViTLens.encode, the same weights on both sides; vitlensB at full depth."""
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


def test_vitlens_warmup_shapes(jax_model):
    """Warmup samples have JAX's shapes (depth [b, 1, hw, hw], EEG [b,
    chans, time_len], video [b, n_frames, 3, hw, hw]); warmup runs every
    (modality, bucket) encode, and a 5-D preprocessed video batch pads to
    its bucket with the rows unchanged."""
    jm = jax_model  # holds the NEW towers; a sample's shape is its config's
    pm = ViTLens("vitlensB", NEW, device="cpu", batch_buckets=(1, 4))
    for m in NEW:
        assert pm._warmup_sample(m, 3).shape == jm._warmup_sample(m, 3).shape
        pm.towers[m].trunk.blocks = pm.towers[m].trunk.blocks[:1]
    assert pm._warmup_sample("video", 2).shape == (2, 8, 3, 224, 224)
    logged = []
    pm.warmup(log=logged.append)
    assert logged == [f"warmup {m} b{b} done" for m in NEW for b in (1, 4)]
    x = np.random.RandomState(0).randn(2, 8, 3, 224, 224).astype(np.float32)
    got = pm.encode({"video": x}, preprocessed=True)["video"]
    pm.batch_buckets = None
    want = pm.encode({"video": x}, preprocessed=True)["video"]
    assert tuple(got.shape) == (2, 512)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
