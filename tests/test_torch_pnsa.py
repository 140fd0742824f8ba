"""The vitlensG point-cloud path on the CPU, held against the JAX package:
the exact ball query, the PNSA tokenizer (eval and train), a vitlensG-shaped
tower (ViT-Tiny-Test trunk, PNSA, the first trunk block skipped), a PNSA
reference-layout checkpoint through both converters, ``ViTLens("vitlensG",
("pc",))`` on raw clouds and the server. Parameters and BatchNorm statistics
are JAX's, copied with weights/from_jax.py (the statistics set to random
values, so that a missing state load fails); inputs come from numpy seeds;
fp32 outputs agree to 1e-5 of their largest magnitude. The vitlensG configs
are swapped for tiny PNSA configs of the same shape (the bigG trunk holds
2.5 B parameters)."""

import dataclasses
import functools
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vitlens_tpu.train.openshape as JOS
import vitlens_tpu_torch.api as api
from tools import reference_layout as RL
from vitlens_tpu.adapters import tokenizers as JT
from vitlens_tpu.api import ViTLens as JaxViTLens
from vitlens_tpu.config import PointAdapterConfig as JaxPointConfig
from vitlens_tpu.config import make_model_config as jax_model_config
from vitlens_tpu.models.vit import vision_tower_apply, vision_tower_init
from vitlens_tpu.ops import fps as JF
from vitlens_tpu.weights import torch_convert as JC
from vitlens_tpu_torch import config as PC
from vitlens_tpu_torch.adapters.tokenizers import PNSATokenizer
from vitlens_tpu_torch.api import ViTLens
from vitlens_tpu_torch.models.vit import VisionTower
from vitlens_tpu_torch.ops import fps as PF
from vitlens_tpu_torch.serve import make_server
from vitlens_tpu_torch.train.openshape import vitlensG_tower_config
from vitlens_tpu_torch.weights import torch_convert as PCV
from vitlens_tpu_torch.weights.from_jax import (flatten, load_params,
                                                load_state, read_state)
from tests.test_torch_threads import share_cores

share_cores()

TRUNK = "ViT-Tiny-Test"
# the vitlensG tokenizer's geometry at a tiny size: 16 balls of 8 points
POINT = dict(tokenizer="pnsa", npoints=256, num_group=16, group_size=8,
             encoder_dims=64, trans_dim=384, radius=0.3)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1e-12, np.abs(want).max())


def _cloud(b, n, seed, channels=6):
    """xyz ~ N(0, 0.3), then rgb in [0, 1]."""
    rng = np.random.RandomState(seed)
    xyz = rng.randn(b, n, 3) * 0.3
    return np.concatenate([xyz, rng.rand(b, n, channels - 3)], -1).astype(
        np.float32)


def _random_bn(p, s, seed):
    """Random scale/bias and mean/var for every BatchNorm of the PNSA tree."""
    rng = np.random.RandomState(seed)
    p = jax.tree.map(lambda x: x, p)
    s = jax.tree.map(lambda x: x, s)
    for layer_p, layer_s in zip(p["sa"], s["sa"]):
        c = layer_p["bn"]["scale"].shape[0]
        layer_p["bn"] = {"scale": jnp.asarray(1 + 0.2 * rng.randn(c), jnp.float32),
                         "bias": jnp.asarray(0.1 * rng.randn(c), jnp.float32)}
        layer_s["bn"] = {"mean": jnp.asarray(0.2 * rng.randn(c), jnp.float32),
                         "var": jnp.asarray(0.5 + rng.rand(c), jnp.float32)}
    return p, s


# -- the exact ball query --------------------------------------------------------

def _ball_case(case):
    """(xyz [B, N, 3], query [B, S, 3], radius, nsample)."""
    rng = np.random.RandomState(3)
    xyz = (rng.randn(2, 200, 3) * 0.3).astype(np.float32)
    if case == "dense":     # most balls hold more than nsample points
        return xyz, xyz[:, :24], 0.6, 16
    if case == "sparse":    # a ball holding only its center
        return xyz, xyz[:, :24], 1e-3, 16
    if case == "empty":     # queries far from every point
        return xyz, xyz[:, :4] + 10.0, 0.2, 8
    if case == "nsample_past_n":
        small = xyz[:, :12]
        return small, small[:, :4], 0.4, 20
    if case == "duplicates":  # every point four times
        dup = np.repeat(xyz[:, :50], 4, axis=1)
        return dup, dup[:, ::7], 0.25, 16
    raise ValueError(case)


@pytest.mark.parametrize("case", ["dense", "sparse", "empty", "nsample_past_n",
                                  "duplicates"])
def test_ball_query_matches_jax(case):
    """Index-equal to JAX's exact branch: the first in-ball indices, the
    empty slots (and the columns past N) filled with the first in-ball
    index, an empty ball clamped to N - 1."""
    xyz, query, radius, nsample = _ball_case(case)
    want = np.asarray(JF.ball_query(jnp.asarray(xyz), jnp.asarray(query),
                                    radius, nsample, exact=True))
    got = PF.ball_query(torch.from_numpy(xyz), torch.from_numpy(query),
                        radius, nsample)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


# -- the PNSA tokenizer ------------------------------------------------------------

def _jax_pnsa(seed=0):
    cfg = JaxPointConfig(**POINT, in_channel=6, knn_exact=True)
    p, s = JT.pnsa_tokenizer_init(jax.random.PRNGKey(seed), cfg)
    return cfg, *_random_bn(p, s, seed + 1)


def _port_pnsa(p, s):
    tok = PNSATokenizer(PC.PointAdapterConfig(**POINT, in_channel=6))
    load_params(tok, p)
    load_state(tok, s)
    return tok


@pytest.mark.parametrize("train", [False, True])
def test_pnsa_tokenizer_matches_jax(train):
    """Tokens [B, G, trans_dim] of pnsa_tokenizer_apply, fp32, to 1e-5 of
    max|ref|, FPS from the same starts (JAX's, drawn from its fps_key); the
    running statistics after the pass too (moved in train mode, unchanged
    in eval)."""
    cfg, p, s = _jax_pnsa()
    x = _cloud(3, 256, seed=4)
    key = jax.random.PRNGKey(11)
    starts = np.array(jax.random.randint(key, (3,), 0, 256))
    (want, none), new_s = jax.jit(functools.partial(
        JT.pnsa_tokenizer_apply, cfg=cfg, train=train))(
        p, s, jnp.asarray(x), jnp.asarray(x[..., :3]), fps_key=key)
    tok = _port_pnsa(p, s)
    got, pos = tok(torch.from_numpy(x), torch.from_numpy(x[..., :3]),
                   train=train, start=torch.from_numpy(starts))
    assert none is None and pos is None
    assert tuple(got.shape) == (3, 16, 384)
    assert _rel(got.detach().numpy(), want) < 1e-5
    got_s = read_state(tok, new_s)
    for name, w in flatten(new_s).items():
        assert _rel(flatten(got_s)[name], w) < 1e-5, name
    if not train:
        for name, w in flatten(s).items():
            np.testing.assert_array_equal(flatten(got_s)[name], w)


def test_pnsa_train_gradients_match_jax():
    """Gradients of a fixed projection of the train-mode tokens, with
    respect to every PNSA parameter, to 1e-5 of each one's max|ref|."""
    cfg, p, s = _jax_pnsa(seed=2)
    x = _cloud(2, 256, seed=5)
    key = jax.random.PRNGKey(3)
    starts = torch.from_numpy(np.array(jax.random.randint(key, (2,), 0, 256)))
    proj = np.random.RandomState(6).randn(2, 16, 384).astype(np.float32)

    def loss(params):
        (tokens, _), _ = JT.pnsa_tokenizer_apply(
            params, s, jnp.asarray(x), jnp.asarray(x[..., :3]), cfg,
            train=True, fps_key=key)
        return jnp.sum(tokens * proj)

    want = flatten(jax.jit(jax.grad(loss))(p))
    tok = _port_pnsa(p, s)
    for t in tok.parameters():
        t.requires_grad_(True)
    got, _ = tok(torch.from_numpy(x), torch.from_numpy(x[..., :3]), train=True,
                 start=starts)
    (got * torch.from_numpy(proj)).sum().backward()
    grads = dict(tok.named_parameters())
    for name, t in grads.items():
        if name.startswith("sa.") and name.endswith("conv.b"):
            # a bias before a batch-statistics BN: its gradient is zero in
            # exact arithmetic, so both sides hold rounding only, held to
            # the scale of the same product's weight gradient
            scale = np.abs(want[name[:-1] + "w"]).max()
            assert np.abs(t.grad.numpy()).max() < 1e-5 * scale, name
            assert np.abs(want[name]).max() < 1e-5 * scale, name
        else:
            assert _rel(t.grad.numpy(), want[name]) < 1e-5, name


# -- a vitlensG-shaped tower -----------------------------------------------------

def _tower_cfgs(in_channel):
    """(JAX, port) tower configs: the tiny trunk with the PNSA tokenizer and
    the first trunk block skipped, as vitlensG skips 16 of 48."""
    j = jax_model_config(TRUNK, "pc", skip_first_n_layers=1,
                         point=JaxPointConfig(**POINT, in_channel=in_channel,
                                              knn_exact=True)).tower
    p = PC.make_model_config(TRUNK, "pc", skip_first_n_layers=1,
                             point=PC.PointAdapterConfig(
                                 **POINT, in_channel=in_channel)).tower
    return j, p


@pytest.mark.parametrize("in_channel,train", [(6, False), (3, False), (6, True)])
def test_vitlensG_shaped_tower_matches_jax(in_channel, train):
    """vision_tower_apply on [B, N, 6] clouds: with in_channel 6 the
    features are the whole cloud (xyz + rgb, OpenShape's), with in_channel
    3 the channels after xyz. fp32 features to 1e-5 of max|ref|; the
    skipped block is held but unused."""
    jcfg, pcfg = _tower_cfgs(in_channel)
    params, state = vision_tower_init(jax.random.PRNGKey(7), jcfg)
    params["adapter"], state["adapter"] = _random_bn(params["adapter"],
                                                     state["adapter"], 8)
    x = _cloud(2, 256, seed=9)
    key = jax.random.PRNGKey(12)
    want, new_s = vision_tower_apply(params, state, jnp.asarray(x), jcfg,
                                     train=train, fps_key=key)
    tower = VisionTower(pcfg)
    load_params(tower, params)
    load_state(tower, state)
    starts = torch.from_numpy(np.array(jax.random.randint(key, (2,), 0, 256)))
    got = tower(torch.from_numpy(x), train=train, fps_start=starts)
    assert tuple(got.shape) == (2, 32)
    assert _rel(got.detach().numpy(), want) < 1e-5
    got_s = flatten(read_state(tower, new_s))
    for name, w in flatten(new_s).items():
        assert _rel(got_s[name], w) < 1e-5, name
    # the first block takes no part: changing it changes nothing
    with torch.no_grad():
        tower.trunk.blocks[0].mlp.fc.w.add_(1.0)
    again = tower(torch.from_numpy(x), fps_start=starts)
    if not train:
        assert torch.equal(again, got)


def test_vitlensG_tower_config_matches_jax():
    """The port's copy of vitlensG_tower_config equals JAX's, field for
    field; with it the bigG Lens tower is the published one."""
    want = JOS.vitlensG_tower_config()
    got = vitlensG_tower_config()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.point.tokenizer, got.point.npoints, got.point.in_channel,
            got.skip_first_n_layers, got.arch.width, got.arch.layers) == \
        ("pnsa", 10000, 6, 16, 1664, 48)


# -- the reference layout --------------------------------------------------------

def test_pnsa_checkpoint_loads_through_both_converters():
    """A PNSA state dict in the reference layout (tools/reference_layout.py:
    sa.mlp_convs.{i} Conv2d, sa.mlp_bns.{i}, lift.0 Conv1d, lift.2
    LayerNorm) converts to equal trees in JAX and the port; the port's
    loaded tower encodes as JAX's does from its tree."""
    jcfg, pcfg = _tower_cfgs(6)
    sd = RL.vision_tower_state_dict(pcfg, torch.Generator().manual_seed(4))
    assert "visual_adapter.sa.mlp_convs.2.weight" in sd
    assert tuple(sd["visual_adapter.sa.mlp_convs.0.weight"].shape) == (64, 9, 1, 1)
    jp, js = JC.convert_vision_tower(sd, jcfg)
    pp, ps = PCV.convert_vision_tower(sd, pcfg)
    want, got = flatten(jax.tree.map(np.asarray, jp)), flatten(pp)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    want_s, got_s = flatten(jax.tree.map(np.asarray, js)), flatten(ps)
    assert sorted(got_s) == sorted(want_s) and len(want_s) == 6
    for k in want_s:
        np.testing.assert_array_equal(got_s[k], want_s[k], err_msg=k)
    tower = VisionTower(pcfg)
    load_params(tower, pp)
    load_state(tower, ps)
    x = _cloud(2, 256, seed=10)
    want_f, _ = vision_tower_apply(jp, js, jnp.asarray(x), jcfg)
    assert _rel(tower(torch.from_numpy(x)).detach().numpy(), want_f) < 1e-5


# -- ViTLens and the server --------------------------------------------------------

def _tiny_vitlensG(monkeypatch):
    """Both packages' vitlensG pc tower swapped for the tiny PNSA tower
    (300 points of 6 channels); returns (JAX config, port config)."""
    j = dataclasses.replace(_tower_cfgs(6)[0], point=JaxPointConfig(
        **{**POINT, "npoints": 300}, in_channel=6, knn_exact=True))
    p = dataclasses.replace(_tower_cfgs(6)[1], point=PC.PointAdapterConfig(
        **{**POINT, "npoints": 300}, in_channel=6))
    monkeypatch.setattr(JOS, "vitlensG_tower_config", lambda: j)
    monkeypatch.setattr(api, "vitlensG_tower_config", lambda: p)
    return j, p


def test_vitlens_vitlensG_pc_raw_clouds_match_jax(monkeypatch):
    """ViTLens("vitlensG", ("pc",)) on raw clouds: one of 400 xyz + rgb
    points and one xyz-only (OpenShape's 0.4 grey fills its rgb), both FPS'd
    to the tower's 300 points by the processor; the same weights as JAX's
    ViTLens; fp32, 1e-5 of max|ref|."""
    _tiny_vitlensG(monkeypatch)
    jm = JaxViTLens("vitlensG", ("pc",))
    pm = ViTLens("vitlensG", ("pc",), device="cpu")
    assert (pm.processors["pc"].n, pm.processors["pc"].channels) == (300, 6)
    entry = jm._towers["pc"]
    load_params(pm.towers["pc"], entry["params"])
    load_state(pm.towers["pc"], entry["state"])
    raw = [_cloud(1, 400, seed=13)[0], _cloud(1, 400, seed=14)[0][:, :3]]
    want = np.asarray(jm.encode({"pc": raw})["pc"])
    got = pm.encode({"pc": raw})["pc"]
    assert tuple(got.shape) == (2, 32)
    assert _rel(got.numpy(), want) < 1e-5
    grey = pm.processors["pc"]([raw[1]])
    assert grey.shape == (1, 300, 6) and np.all(grey[..., 3:] == np.float32(0.4))


def test_server_answers_vitlensG_pc_requests(monkeypatch, tmp_path):
    """The HTTP server with a vitlensG pc + text model (the trunk and text
    tower tiny too): pc items as numeric arrays and as .npy paths, replies
    equal to direct encodes."""
    _tiny_vitlensG(monkeypatch)
    monkeypatch.setitem(api._TRUNKS, "vitlensG", TRUNK)
    model = ViTLens("vitlensG", ("pc", "text"), device="cpu")
    assert model.towers["pc"].cfg.point.tokenizer == "pnsa"
    clouds = [_cloud(1, 350, seed=20)[0], _cloud(1, 300, seed=21)[0][:, :3]]
    path = str(tmp_path / "cloud.npy")
    np.save(path, clouds[0])
    srv = make_server(model, port=0, max_batch=4, max_wait_ms=5)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        port = srv.server_address[1]
        for items, direct in (([c.tolist() for c in clouds], clouds),
                              ([path], [clouds[0]])):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/encode",
                data=json.dumps({"inputs": {"pc": items,
                                            "text": ["a chair"]}}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req) as r:
                out = json.loads(r.read())
            got = np.asarray(out["embeddings"]["pc"], np.float32)
            want = model.encode({"pc": direct})["pc"].numpy()
            assert got.shape == (len(direct), 32)
            np.testing.assert_allclose(got, want, atol=1e-5)
    finally:
        srv.shutdown()
        srv.encoder.close()
        srv.server_close()


def test_serve_cli_builds_the_vitlensG_pc_tower(monkeypatch):
    """`python -m vitlens_tpu_torch.cli.serve --model-var vitlensG
    --modalities pc` builds the PNSA tower with its weights in bf16 (the
    CLI's vitlensG param_dtype) and serves it; the server is replaced here
    by one that records the model."""
    import vitlens_tpu_torch.serve as S

    _tiny_vitlensG(monkeypatch)
    seen = {}

    class Stop(Exception):
        pass

    def fake_server(model, **kw):
        seen["model"] = model
        raise Stop

    monkeypatch.setattr(S, "make_server", fake_server)
    from vitlens_tpu_torch.cli import serve as CLI

    with pytest.raises(Stop):
        CLI.main(["--model-var", "vitlensG", "--modalities", "pc", "--device",
                  "cpu", "--no-warmup"])
    tower = seen["model"].towers["pc"]
    assert tower.cfg.point.tokenizer == "pnsa"
    assert tower.adapter.sa[0].conv.w.dtype == torch.bfloat16
    assert tower.adapter.sa[0].bn.mean.dtype == torch.float32
    emb = seen["model"].encode({"pc": [_cloud(1, 300, seed=22)[0]]})["pc"]
    assert tuple(emb.shape) == (1, 32) and torch.isfinite(emb).all()
