"""Reference-layout checkpoints into the port on CPU, held against the JAX
package's converter (vitlens_tpu/weights/torch_convert.py): state dicts made
by tools/reference_layout.py, converted by both, the trees exactly equal and
the port's loaded modules equal to ``from_jax.load_params`` of JAX's tree;
``resize_pos_embed`` against ``jax.image.resize``; the merged
``vitlens.{m}.`` keys, the loud text-layout error, and
``create_model(checkpoint_path=)`` against JAX's ``create_model``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import reference_layout as RL
from vitlens_tpu import factory as JFAC
from vitlens_tpu.api import ViTLens as JaxViTLens
from vitlens_tpu.config import image_tower_config as jax_image_tower_config
from vitlens_tpu.config import make_model_config as jax_model_config
from vitlens_tpu.weights import torch_convert as JC
from vitlens_tpu_torch import config as PC
from vitlens_tpu_torch.api import ViTLens
from vitlens_tpu_torch.factory import create_model
from vitlens_tpu_torch.models import tri as PT
from vitlens_tpu_torch.models.text import TextTower
from vitlens_tpu_torch.models.vit import VisionTower
from vitlens_tpu_torch.weights import torch_convert as PCV
from vitlens_tpu_torch.weights.from_jax import flatten, load_params, load_state
from tests.test_torch_threads import share_cores

share_cores()

TRUNK = "ViT-Tiny-Test"
VISUAL = ("image", "tactile", "audio", "pc")


def _tower_cfgs(modality: str):
    """(JAX, port) tower configs of the tiny trunk; the pc tower keeps its
    PointBERT tokenizer at a small point count."""
    if modality == "image":
        return (jax_image_tower_config(jax_model_config(TRUNK, "image")),
                PC.image_tower_config(PC.make_model_config(TRUNK, "image")))
    j, p = (jax_model_config(TRUNK, modality).tower,
            PC.make_model_config(TRUNK, modality).tower)
    if modality == "pc":
        j = dataclasses.replace(j, point=dataclasses.replace(
            j.point, npoints=256, num_group=16, group_size=8))
        p = dataclasses.replace(p, point=dataclasses.replace(
            p.point, npoints=256, num_group=16, group_size=8))
    return j, p


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


def _assert_module_equals_tree(module, params, state=None):
    """Every parameter (and buffer) of ``module`` equals ``load_params`` of
    the JAX tree into a fresh copy."""
    flat = flatten(params)
    named = dict(module.named_parameters())
    assert sorted(named) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(named[k].detach().float().numpy(),
                                      np.asarray(v, np.float32), err_msg=k)
    if state is not None:
        buffers = dict(module.named_buffers())
        for k, v in flatten(state).items():
            np.testing.assert_array_equal(buffers[k].numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("modality", VISUAL)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_vision_tower_conversion_matches_jax(modality, dtype):
    """The port's tree equals JAX's exactly (fp16 files cast up on both
    sides); loaded into the port's tower, every parameter and BN statistic
    equals load_params / load_state of JAX's tree."""
    jcfg, pcfg = _tower_cfgs(modality)
    sd = RL.vision_tower_state_dict(pcfg, torch.Generator().manual_seed(1), dtype)
    want_p, want_s = JC.convert_vision_tower(sd, jcfg)
    got_p, got_s = PCV.convert_vision_tower(sd, pcfg)
    _assert_trees_equal(got_p, jax.tree.map(np.asarray, want_p))
    _assert_trees_equal(got_s, jax.tree.map(np.asarray, want_s))
    tower = VisionTower(pcfg)
    load_params(tower, got_p)
    load_state(tower, got_s)
    _assert_module_equals_tree(tower, want_p, want_s)


def test_text_tower_conversion_matches_jax():
    cfg = PC.make_model_config(TRUNK, "image")
    sd = RL.text_tower_state_dict(cfg.text, cfg.embed_dim,
                                  torch.Generator().manual_seed(2))
    want = JC.convert_text_tower(sd, cfg.text.layers)
    got = PCV.convert_text_tower(sd, cfg.text.layers)
    _assert_trees_equal(got, jax.tree.map(np.asarray, want))
    tower = load_params(TextTower(cfg.text, cfg.embed_dim), got)
    _assert_module_equals_tree(tower, want)


@pytest.mark.parametrize("g_old,g_new", [(14, 16), (16, 14), (7, 16), (16, 16)])
def test_resize_pos_embed_matches_jax_image_resize(g_old, g_new):
    """Keys' cubic (a = -0.5), half-pixel centres, antialiased when
    shrinking: within 1e-6 of jax.image.resize computed in float64 (the same
    method without rounding; the port builds its weights in float64), and
    within 1e-5 of the JAX converter's own fp32 result, whose rounding reads
    up to 4.6e-6 on this unit-variance grid. F.interpolate's bicubic is
    another method (a = -0.75, clamped edges)."""
    pos = np.random.RandomState(g_old).randn(1 + g_old * g_old, 48).astype(np.float32)
    got = PCV.resize_pos_embed(pos, g_new * g_new)
    assert got.shape == (1 + g_new * g_new, 48) and got.dtype == np.float32
    np.testing.assert_array_equal(got[0], pos[0])
    grid = pos[1:].reshape(g_old, g_old, 48)
    with jax.enable_x64(True):
        exact = np.asarray(jax.image.resize(jnp.asarray(grid.astype(np.float64)),
                                            (g_new, g_new, 48), "bicubic"))
    np.testing.assert_allclose(got[1:], exact.reshape(-1, 48), atol=1e-6, rtol=0)
    want = np.asarray(JC.resize_pos_embed(pos, g_new * g_new))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if g_old != g_new:
        t = torch.from_numpy(grid).permute(2, 0, 1)[None]
        other = torch.nn.functional.interpolate(
            t, size=(g_new, g_new), mode="bicubic", align_corners=False)
        other = other[0].permute(1, 2, 0).reshape(-1, 48).numpy()
        assert np.abs(other - exact.reshape(-1, 48)).max() > 1e-3


def test_lens_tower_from_a_clip_grid_resizes_its_pos_embed():
    """A Lens tower file whose positional embedding is a 3 x 3 CLIP grid
    (the tiny trunk's Lens takes 4 latents): resized like JAX."""
    jcfg, pcfg = _tower_cfgs("audio")
    sd = RL.vision_tower_state_dict(pcfg, torch.Generator().manual_seed(4),
                                    pos_tokens=9)
    want, _ = JC.convert_vision_tower(sd, jcfg)
    got, _ = PCV.convert_vision_tower(sd, pcfg)
    np.testing.assert_allclose(got["positional_embedding"],
                               np.asarray(want["positional_embedding"]),
                               atol=1e-6, rtol=0)


def _jax_entry(m: str):
    cfg = jax_model_config(TRUNK, m if m != "text" else "image")
    if m == "text":
        return {"cfg": cfg, "kind": "text", "params": None, "state": None}
    tcfg, _ = _tower_cfgs(m)
    return {"cfg": cfg, "tower_cfg": tcfg, "params": None, "state": None,
            "kind": "image" if m == "image" else "visual"}


def _port_tower(m: str):
    if m == "text":
        cfg = PC.make_model_config(TRUNK, "image")
        tower = TextTower(cfg.text, cfg.embed_dim)
    else:
        tower = VisionTower(_tower_cfgs(m)[1])
    tower.init_(torch.Generator().manual_seed(9))
    return tower


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A merged export (vitlens.{audio,pc}.*, wrapped in {"state_dict": ...}
    with the DDP prefix) and a CLIP file (visual.* and top-level text)."""
    d = tmp_path_factory.mktemp("ckpt")
    g = torch.Generator().manual_seed(3)
    merged = RL.merged_state_dict({m: RL.vision_tower_state_dict(
        _tower_cfgs(m)[1], g) for m in ("audio", "pc")})
    merged = {"module." + k: v for k, v in merged.items()}
    clip = RL.clip_state_dict(PC.make_model_config(TRUNK, "image"), g)
    paths = {"all": str(d / "merged.pt"), "clip": str(d / "clip.pt")}
    torch.save({"epoch": 1, "state_dict": merged}, paths["all"])
    torch.save(clip, paths["clip"])
    return paths


@pytest.mark.parametrize("m,which", [("audio", "all"), ("pc", "all"),
                                     ("image", "clip"), ("tactile", "clip"),
                                     ("text", "clip")])
def test_load_ckpt_matches_jax(files, m, which):
    """ViTLens._load_ckpt of the merged vitlens.{m}. keys and of the CLIP
    file's visual./text keys fills the tower exactly as JAX's _load_ckpt's
    tree, loaded with from_jax, does."""
    entry = _jax_entry(m)
    JaxViTLens._load_ckpt(None, entry, m, files[which])
    tower = _port_tower(m)
    ViTLens._load_ckpt(tower, m, files[which])
    _assert_module_equals_tree(tower, entry["params"], entry["state"])


def test_text_layout_error_is_loud(files):
    """A file with no text keys: both raise the same ValueError rather than
    serve the initial text weights."""
    with pytest.raises(ValueError, match="matches no known text-tower") as want:
        JaxViTLens._load_ckpt(None, _jax_entry("text"), "text", files["all"])
    with pytest.raises(ValueError, match="matches no known text-tower") as got:
        ViTLens._load_ckpt(_port_tower("text"), "text", files["all"])
    assert str(got.value) == str(want.value)


def test_vitlens_checkpoints_argument(tmp_path):
    """ViTLens(checkpoints=...) loads the text tower from a CLIP file before
    the cast; "all" serves a modality without its own entry; the weights
    differ from the seeded ones and equal the file's."""
    cfg = PC.make_model_config("ViT-B-16", "image")
    sd = RL.text_tower_state_dict(cfg.text, cfg.embed_dim,
                                  torch.Generator().manual_seed(6), torch.float16)
    path = str(tmp_path / "text.pt")
    torch.save({"text." + k: v for k, v in sd.items()}, path)
    seeded = ViTLens("vitlensB", ("text",), device="cpu")
    for ckpts in ({"text": path}, {"all": path}):
        pm = ViTLens("vitlensB", ("text",), device="cpu", checkpoints=ckpts,
                     compute_dtype=torch.bfloat16)
        tower = pm.towers["text"]
        assert tower.trunk.blocks[0].mlp.fc.w.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tower.token_embedding.numpy(), sd["token_embedding.weight"].float().numpy())
        want_fc = sd["transformer.resblocks.0.mlp.c_fc.weight"].float().T.bfloat16()
        assert torch.equal(tower.trunk.blocks[0].mlp.fc.w, want_fc)
        assert not torch.equal(tower.token_embedding,
                               seeded.towers["text"].token_embedding)
    half = ViTLens("vitlensB", ("text",), device="cpu", checkpoints={"text": path},
                   param_dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in half.parameters())


def _tri_state_dict(seed: int):
    """A TriCLIP file of the tiny trunk with the audio Lens: the Lens tower
    under visual., the image tower under image., the text inline."""
    pcfg = PC.make_model_config(TRUNK, "audio")
    g = torch.Generator().manual_seed(seed)
    sd = {"visual." + k: v for k, v in RL.vision_tower_state_dict(pcfg.tower, g).items()}
    sd.update({"image." + k: v for k, v in RL.vision_tower_state_dict(
        PC.image_tower_config(pcfg), g).items()})
    sd.update(RL.text_tower_state_dict(pcfg.text, pcfg.embed_dim, g))
    sd["logit_scale"] = torch.tensor(2.5)
    return sd


def test_create_model_checkpoint_path_matches_jax(tmp_path):
    """create_model(checkpoint_path=) on a TriCLIP file: the encodes equal
    JAX's create_model(checkpoint_path=) on the same file (fp32, 1e-5)."""
    sd = _tri_state_dict(5)
    path = str(tmp_path / "tri.pt")
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}}, path)
    jm = JFAC.create_model(TRUNK, "audio", checkpoint_path=path)
    pm = create_model(TRUNK, "audio", checkpoint_path=path, device="cpu")
    assert float(pm.logit_scale) == 2.5
    rng = np.random.RandomState(0)
    fb = rng.randn(2, 512, 128).astype(np.float32)
    ids = np.zeros((2, 77), np.int64)
    ids[:, 0], ids[:, 1:4], ids[:, 4] = 49406, rng.randint(1, 49405, (2, 3)), 49407
    with torch.no_grad():
        got_v = PT.encode_visual(pm, torch.from_numpy(fb), normalize=True)
        got_t = PT.encode_text(pm, torch.from_numpy(ids), normalize=True)
    want_v = np.asarray(jm.encode_visual(jnp.asarray(fb), normalize=True))
    want_t = np.asarray(jm.encode_text(jnp.asarray(ids.astype(np.int32)),
                                       normalize=True))
    np.testing.assert_allclose(got_v.numpy(), want_v, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_t.numpy(), want_t, atol=1e-5, rtol=0)


def test_create_model_plain_clip_is_a_non_strict_merge(tmp_path):
    """A plain CLIP file into the audio Lens model: the shared trunk subset
    loads (equal to JAX's merged tree), the adapter and the Lens keep their
    seeded values, and the file's visual keys fill the image tower, equal to
    JAX's image subtree."""
    cfg = PC.make_model_config(TRUNK, "audio")
    sd = RL.clip_state_dict(cfg, torch.Generator().manual_seed(8))
    path = str(tmp_path / "clip.pt")
    torch.save(sd, path)
    seeded = create_model(TRUNK, "audio", device="cpu", seed=4)
    pm = create_model(TRUNK, "audio", checkpoint_path=path, device="cpu", seed=4)
    jm = JFAC.create_model(TRUNK, "audio", checkpoint_path=path)
    loaded = {k: v for k, v in flatten(jm.params["visual"]).items()
              if not k.startswith(("adapter.", "perceiver."))}
    named = dict(pm.visual.named_parameters())
    for k, v in loaded.items():
        np.testing.assert_array_equal(named[k].numpy(), np.asarray(v), err_msg=k)
    for k in ("adapter.conv1.w", "perceiver.latents"):
        assert torch.equal(named[k], dict(seeded.visual.named_parameters())[k])
    np.testing.assert_array_equal(pm.text.token_embedding.numpy(),
                                  sd["token_embedding.weight"].numpy())
    image = flatten(jm.params["image"])
    assert set(image) == {n for n, _ in pm.image.named_parameters()}
    for k, p in pm.image.named_parameters():
        np.testing.assert_array_equal(p.numpy(), np.asarray(image[k]), err_msg=k)
