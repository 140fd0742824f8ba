"""The port's image tower in training, on the CPU in fp32, held against the
JAX package: encode_image (images and frame means), output_tokens,
tri_forward, the image-tower masks, the token-distill loss, and three steps
of make_train_step for every tri, dual and video-distill recipe, from the
same weights and batches, on ViT-Tiny-Test towers (2 trunk blocks, width
64, 28 x 28 images of 4 patches)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitlens_tpu.config import make_model_config as jax_model_config
from vitlens_tpu.models import tri as JT
from vitlens_tpu.models.vit import vision_tower_apply
from vitlens_tpu.train import freeze as JF
from vitlens_tpu.train import losses as JLs
from vitlens_tpu.train import step as JStep
from vitlens_tpu_torch import config as PC
from vitlens_tpu_torch.factory import make_trainable_
from vitlens_tpu_torch.models import tri as PT
from vitlens_tpu_torch.models.tri import TriModel
from vitlens_tpu_torch.models.vit import VisionTower
from vitlens_tpu_torch.train import freeze as PF
from vitlens_tpu_torch.train import losses as PLs
from vitlens_tpu_torch.train import step as PStep
from vitlens_tpu_torch.weights.from_jax import flatten, load_params, load_tri_params
from tests.test_torch_threads import share_cores

share_cores()

TRUNK = "ViT-Tiny-Test"


def _models(modality, seed=0):
    jcfg = jax_model_config(TRUNK, modality)
    params, state = JT.tri_model_init(jax.random.PRNGKey(seed), jcfg)
    pcfg = PC.make_model_config(TRUNK, modality)
    return jcfg, pcfg, params, state, load_tri_params(TriModel(pcfg, device="cpu"),
                                                      params)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(
        1e-12, np.abs(want).max())


def _images(rng, *lead):
    return rng.randn(*lead, 3, 28, 28).astype(np.float32)


def _text(rng, n):
    text = rng.randint(1, 49000, size=(n, 77)).astype(np.int32)
    text[:, 0], text[:, -1] = 49406, 49407  # the EOT pools
    return text


def _visual(rng, modality, n):
    if modality == "depth":
        return rng.randn(n, 1, 28, 28).astype(np.float32)
    if modality == "video":
        return _images(rng, n, 8)
    return _images(rng, n)  # tactile, image


# -- the model -----------------------------------------------------------------

def test_tri_model_holds_the_image_tower():
    """TriModel.image is the frozen CLIP image tower of image_tower_config;
    a JAX tri_model_init tree loads strictly, its image subtree included;
    the image tower draws its initial weights after the other towers, so a
    seed gives the Lens and text towers the values they had without it."""
    *_, model = _models("depth")
    cfg = model.image.cfg
    assert cfg.modality == "image" and cfg.arch == model.cfg.vision
    assert cfg.perceiver is None
    from vitlens_tpu_torch.models.text import TextTower

    g = torch.Generator().manual_seed(3)
    full = TriModel(model.cfg, device="cpu")
    full.init_(g)
    g = torch.Generator().manual_seed(3)
    alone = VisionTower(model.cfg.tower)
    alone.init_(g)
    text = TextTower(model.cfg.text, model.cfg.embed_dim, model.cfg.quick_gelu)
    text.init_(g)
    for tower, mine in ((alone, full.visual), (text, full.text)):
        for (n, a), (_, b) in zip(tower.named_parameters(), mine.named_parameters()):
            assert torch.equal(a, b), n


@pytest.mark.parametrize("frames", [0, 3])
def test_encode_image_matches_jax(frames):
    """Images [B, 3, H, W] and frames [B, T, 3, H, W] (the frame mean),
    normalized and not: fp32 within 1e-5 of max|ref|; bf16 compute at cosine
    >= 0.99 and its output dtype bf16."""
    jcfg, _, params, state, model = _models("video", seed=1)
    rng = np.random.RandomState(1)
    x = _images(rng, 2, frames) if frames else _images(rng, 2)
    for normalize in (False, True):
        want = JT.encode_image(params, state, jnp.asarray(x), jcfg,
                               normalize=normalize)
        got = PT.encode_image(model, torch.from_numpy(x), normalize=normalize)
        assert tuple(got.shape) == (2, 32)
        assert _rel(got.detach().numpy(), want) < 1e-5
    want16 = np.asarray(JT.encode_image(params, state, jnp.asarray(x), jcfg,
                                        normalize=True,
                                        compute_dtype=jnp.bfloat16), np.float32)
    got16 = PT.encode_image(model, torch.from_numpy(x), normalize=True,
                            compute_dtype=torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    g = got16.float().detach().numpy()
    assert ((g * want16).sum(-1) / (np.linalg.norm(g, axis=-1)
                                    * np.linalg.norm(want16, axis=-1))).min() >= 0.99


@pytest.mark.parametrize("tower,gap", [("image", False), ("visual", False),
                                       ("image", True)])
def test_output_tokens_match_jax(tower, gap):
    """output_tokens=True returns (features, tokens): the trunk's output
    before ln_post without the CLS token, or all of it under global average
    pooling; fp32, 1e-5 of max|ref|. The default return is the features."""
    jcfg, pcfg, params, state, _ = _models("video", seed=2)
    jt = JT.image_tower_config(jcfg) if tower == "image" else jcfg.tower
    pt = PC.image_tower_config(pcfg) if tower == "image" else pcfg.tower
    if gap:
        jt = dataclasses.replace(jt, arch=dataclasses.replace(
            jt.arch, global_average_pool=True))
        pt = dataclasses.replace(pt, arch=dataclasses.replace(
            pt.arch, global_average_pool=True))
    rng = np.random.RandomState(2)
    x = _images(rng, 2) if tower == "image" else _visual(rng, "video", 2)
    (want_f, want_t), _ = vision_tower_apply(params[tower], state[tower],
                                             jnp.asarray(x), jt,
                                             output_tokens=True)
    module = load_params(VisionTower(pt), params[tower])
    got_f, got_t = module(torch.from_numpy(x), output_tokens=True)
    n = 5 if gap else 4  # 4 patches (image) or 4 latents (video Lens), + CLS
    assert tuple(got_t.shape) == tuple(want_t.shape) == (2, n, 64)
    assert _rel(got_f.detach().numpy(), want_f) < 1e-5
    assert _rel(got_t.detach().numpy(), want_t) < 1e-5
    assert torch.equal(module(torch.from_numpy(x)), got_f)


@pytest.mark.parametrize("given", ["all", "images", "visual"])
def test_tri_forward_matches_jax(given):
    """tri_forward with the inputs given: the same keys as JAX's, each
    within 1e-5 of max|ref| in fp32."""
    jcfg, _, params, state, model = _models("depth", seed=3)
    rng = np.random.RandomState(3)
    inputs = {"images": _images(rng, 2), "text": _text(rng, 2),
              "visual_x": _visual(rng, "depth", 2)}
    if given != "all":
        key = {"images": "images", "visual": "visual_x"}[given]
        inputs = {key: inputs[key]}
    want, _ = JT.tri_forward(params, state, jcfg,
                             **{k: jnp.asarray(v) for k, v in inputs.items()})
    got = PT.tri_forward(model, **{k: torch.from_numpy(v).long() if k == "text"
                                   else torch.from_numpy(v)
                                   for k, v in inputs.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        assert _rel(got[k].detach().numpy(), want[k]) < 1e-5, k


def test_video_distill_forward_matches_jax():
    """tri_forward_video_distill: the frame-mean image features and tokens,
    the video Lens's features and tokens and the text features, fp32 within
    1e-5 of max|ref|."""
    jcfg, _, params, state, model = _models("video", seed=4)
    rng = np.random.RandomState(4)
    frames, vis, text = _images(rng, 2, 8), _visual(rng, "video", 2), _text(rng, 2)
    want, _ = JT.tri_forward_video_distill(
        params, state, jcfg, video_frames=jnp.asarray(frames),
        text=jnp.asarray(text), visual_x=jnp.asarray(vis))
    got = PT.tri_forward_video_distill(
        model, video_frames=torch.from_numpy(frames),
        text=torch.from_numpy(text).long(), visual_x=torch.from_numpy(vis))
    assert sorted(got) == sorted(want)
    assert tuple(got["image_tokens"].shape) == (2, 4, 64)
    for k in want:
        assert _rel(got[k].detach().numpy(), want[k]) < 1e-5, k


# -- masks ---------------------------------------------------------------------

def _per_param(mask, params):
    full = jax.tree.map(lambda m, p: np.broadcast_to(np.asarray(m), p.shape),
                        mask, params)
    return {k: bool(np.any(v)) for k, v in flatten(full).items()}


@pytest.mark.parametrize("kw", [
    dict(), dict(lock_image=False), dict(image_unlocked_groups=1),
    dict(image_unlocked_groups=2), dict(image_unlocked_groups=4),
    dict(image_unlocked_groups=3, unlock_cls=True, lock_text=False),
    dict(lock_image=False, lock_text=False, lock_visual=False),
    dict(visual_unlocked_groups=2, unlock_from_head=True,
         image_unlocked_groups=1)])
def test_image_masks_match_jax(kw):
    """Per-parameter trainability of all three towers equals JAX's
    tri_model_mask (its stacked-trunk rows taken per block), with lock_image
    and image_unlocked_groups; the image tower's patch embedding follows
    group 0 (it is no Lens); count_trainable agrees."""
    jcfg, pcfg, params, _, model = _models("tactile", seed=5)
    jmask = JF.tri_model_mask(params, jcfg, **kw)
    got = PF.tri_model_mask(model, pcfg, **kw)
    assert got == _per_param(jmask, params)
    assert PF.count_trainable(model, got) == JF.count_trainable(params, jmask)
    # 2 blocks: groups 0 (stem) to 3 (proj), unlocked from the proj end
    three = PF.image_tower_image_mask(model.image, 2, unlocked_groups=3)
    four = PF.image_tower_image_mask(model.image, 2, unlocked_groups=4)
    assert three["trunk.blocks.0.ln_1.scale"] and not three["adapter.conv1.w"]
    assert four["adapter.conv1.w"] and four["ln_pre.scale"]


# -- losses --------------------------------------------------------------------

def _tokens(seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(2, 4, 5, 16).astype(np.float32)


@pytest.mark.parametrize("loss_type", ["mse", "cos"])
def test_distill_token_loss_matches_jax(loss_type):
    v, t = _tokens()
    want = JLs.distill_token_loss(v, t, loss_type)
    got = PLs.distill_token_loss(torch.from_numpy(v), torch.from_numpy(t),
                                 loss_type)
    assert _rel(got.numpy(), want) < 1e-6
    with pytest.raises(ValueError):
        PLs.distill_token_loss(torch.from_numpy(v), torch.from_numpy(t), "l1")


@pytest.mark.parametrize("n_tower", [2, 3])
def test_make_loss_fn_distill_token_matches_jax(n_tower):
    """The distill-token loss is the tri loss plus the mse of the tokens,
    whatever n_tower, as in JAX; 1e-6 relative."""
    rng = np.random.RandomState(n_tower)
    f = rng.randn(3, 6, 16).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    out = dict(zip(("image_features", "text_features", "visual_features"), f))
    out["visual_tokens"], out["image_tokens"] = rng.randn(2, 6, 4, 16).astype(
        np.float32)
    want = JLs.make_loss_fn(n_tower, "distill_token")(
        {**out, "logit_scale": np.float32(14.3)})
    got = PLs.make_loss_fn(n_tower, "distill_token")(
        {**{k: torch.from_numpy(v) for k, v in out.items()},
         "logit_scale": torch.tensor(14.3)})
    assert _rel(got.numpy(), want) < 1e-6


def test_step_config_refuses_distill_token_without_video_distill():
    for n_tower in (2, 3):
        with pytest.raises(ValueError, match="video_distill=True"):
            PStep.StepConfig(n_tower=n_tower, contra_loss_type="distill_token")
        with pytest.raises(ValueError, match="video_distill=True"):
            JStep.StepConfig(n_tower=n_tower, contra_loss_type="distill_token")
    PStep.StepConfig(contra_loss_type="distill_token", video_distill=True)
    with pytest.raises(ValueError, match="unknown step"):
        model = TriModel(PC.make_model_config(TRUNK, "depth"), device="cpu")
        tx, mask = PStep.make_optimizer(model, PStep.OptimizerConfig())
        PStep.make_train_step(None, tx, mask, PStep.StepConfig(align_to="audio"))


# -- the train step --------------------------------------------------------------

def _batch(modality, n, seed, image_frames=0, label=False):
    rng = np.random.RandomState(seed)
    batch = {"text": _text(rng, n),
             "image": (_images(rng, n, image_frames) if image_frames
                       else _images(rng, n)),
             "visual": _visual(rng, modality, n)}
    if label:
        batch["label"] = rng.randint(0, 2, size=n).astype(np.int32)
    return batch


# name: (modality, step settings, mask flags, frames of batch["image"], label)
RECIPES = {
    "depth_tri": ("depth", dict(n_tower=3), dict(unlock_trans_first_n_layers=1),
                  0, False),
    "depth_tri_accum2": ("depth", dict(n_tower=3, accum_freq=2),
                         dict(unlock_trans_first_n_layers=1), 0, False),
    "tactile_tri": ("tactile", dict(n_tower=3),
                    dict(visual_unlocked_groups=2, unlock_from_head=True), 0,
                    False),
    "dual_image": ("depth", dict(n_tower=2, align_to="image"),
                   dict(unlock_trans_first_n_layers=1), 0, False),
    "dual_video": ("video", dict(n_tower=2, align_to="video"), dict(), 8, False),
    "dual_clip": ("image", dict(n_tower=2, align_to="clip"),
                  dict(lock_image=False, lock_text=False), 0, False),
    "tri_label_mask": ("depth", dict(n_tower=3, contra_loss_type="label_mask"),
                       dict(unlock_cls=True), 0, True),
    "tri_sim_mask": ("depth", dict(n_tower=3, contra_loss_type="sim_mask",
                                   sim_thres=0.0), dict(unlock_cls=True), 0,
                     False),
    "video_distill": ("video", dict(n_tower=3, video_distill=True,
                                    contra_loss_type="distill_token"), dict(),
                      8, False),
    "video_distill_accum2": ("video", dict(n_tower=3, video_distill=True,
                                           contra_loss_type="distill_token",
                                           accum_freq=2), dict(), 8, False),
}
# The CLIP pair trains both CLIP towers: its gradients are ~100x the Lens
# recipes' (elements near 0.1), and the two frameworks' fp32 sums differ by
# ~1e-5 of that. Adam moves an element whose gradient is far below eps by
# lr * g / eps, which turns that noise into ~1e-5 of a parameter after three
# steps. The global-norm clip at 1.0 (open_clip's --grad-clip-norm) brings
# the gradients to the other recipes' scale.
OPTIMIZER = {"dual_clip": dict(grad_clip_norm=1.0)}


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_tri_train_step_matches_jax(recipe):
    """Three steps from the same weights and batches, fp32. Loss, grad_norm
    and logit_scale to 1e-5 relative; every trainable parameter to 1e-5
    relative with 1e-6 absolute; the frozen ones bit-identical, the image
    tower's included where it is locked. Adam's eps is 1e-4, as in
    test_torch_train.py (the attention key bias's gradient is zero in exact
    arithmetic; a tiny eps would step it by fp32 summation noise). The sim
    mask's threshold is 0 so that it masks some pairs of these random
    features."""
    modality, step_kw, flags, frames, label = RECIPES[recipe]
    jcfg, pcfg, params, state, model = _models(modality, seed=7)
    ocfg = dict(lr=1e-3, eps=1e-4, warmup=2, total_steps=10,
                **OPTIMIZER.get(recipe, {}))
    jmask = JF.tri_model_mask(params, jcfg, **flags)
    jtx, jmask = JStep.make_optimizer(params, JStep.OptimizerConfig(**ocfg), jmask)
    jstep = JStep.make_train_step(jcfg, jtx, jmask, JStep.StepConfig(
        local_loss=False, sync_bn=False, compute_dtype=jnp.float32, **step_kw),
        mesh=None)
    ts = JStep.init_train_state(params, state, jtx)

    mask = PF.tri_model_mask(model, pcfg, **flags)
    tx, mask = PStep.make_optimizer(model, PStep.OptimizerConfig(**ocfg), mask)
    make_trainable_(model, mask, torch.float32)
    frozen0 = {n: p.detach().clone() for n, p in model.named_parameters()
               if not mask[n]}
    pstate = PStep.init_train_state(model, tx)
    pstep = PStep.make_train_step(pcfg, tx, mask, PStep.StepConfig(
        compute_dtype=torch.float32, **step_kw))

    for i in range(3):
        batch = _batch(modality, 4, seed=20 + i, image_frames=frames, label=label)
        ts, jm = jstep(ts, {k: jnp.asarray(v) for k, v in batch.items()}, None)
        pstate, pm = pstep(pstate, batch)
        for k in ("loss", "grad_norm", "logit_scale"):
            assert _rel(pm[k].numpy(), jm[k]) < 1e-5, (i, k)
    assert pstate.step == 3
    want = flatten(ts.params)
    n_trained = 0
    for name, p in model.named_parameters():
        if mask[name]:
            np.testing.assert_allclose(p.detach().numpy(), want[name],
                                       rtol=1e-5, atol=1e-6, err_msg=name)
            n_trained += 1
        else:
            assert torch.equal(p, frozen0[name]), name
    assert n_trained == sum(mask.values()) > 0
    image_trains = any(mask[n] for n in mask if n.startswith("image."))
    assert image_trains == (not flags.get("lock_image", True))
