"""The OpenShape pc baselines on the CPU, held against the JAX package:
PPAT (the PointBERT baseline), DGCNN, PointNet and the PointNet2 MSG
classifier, in eval mode (running statistics) and train mode (batch
statistics, the running ones moved), FPS from JAX's own starts; the factory's
raises; the three reference-layout converters against JAX's on the same
state dicts, loaded into the port's modules. Parameters and BatchNorm
statistics are JAX's (the BatchNorms set to random values, so that a
dropped load shows), copied with weights/from_jax.py; inputs come from numpy
seeds; fp32 outputs agree to 1e-5 of their largest magnitude (PointNet2 in
train mode: 1e-4 of JAX and 1e-5 of a float64 evaluation, see its test).
Small sizes: scaling 1 and a few hundred points."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import reference_layout as RL
from vitlens_tpu.models import pc_baselines as JB
from vitlens_tpu.weights import torch_convert as JC
from vitlens_tpu_torch.models import pc_baselines as PB
from vitlens_tpu_torch.weights import torch_convert as PCV
from vitlens_tpu_torch.weights.from_jax import (flatten, load_params,
                                                load_state, read_state)
from tests.test_torch_threads import share_cores

share_cores()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1e-12, np.abs(want).max())


def _cloud(b, n, seed):
    """xyz ~ N(0, 0.3), then rgb in [0, 1]: [B, N, 6]."""
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.randn(b, n, 3) * 0.3, rng.rand(b, n, 3)],
                          -1).astype(np.float32)


def _random_bn(p, s, seed):
    """Every BatchNorm (a state node holding mean/var) gets a random
    scale/bias and mean/var."""
    rng = np.random.RandomState(seed)

    def walk(pn, sn):
        if isinstance(sn, dict) and set(sn) == {"mean", "var"}:
            c = sn["mean"].shape[0]
            pn.update(scale=jnp.asarray(1 + 0.2 * rng.randn(c), jnp.float32),
                      bias=jnp.asarray(0.1 * rng.randn(c), jnp.float32))
            sn.update(mean=jnp.asarray(0.2 * rng.randn(c), jnp.float32),
                      var=jnp.asarray(0.5 + rng.rand(c), jnp.float32))
        elif isinstance(sn, dict):
            for k in sn:
                walk(pn[k], sn[k])
        elif isinstance(sn, list):
            for a, b in zip(pn, sn):
                walk(a, b)

    p, s = jax.tree.map(lambda x: x, p), jax.tree.map(lambda x: x, s)
    walk(p, s)
    return p, s


def _port(module, p, s):
    load_params(module, p)
    load_state(module, s)
    return module


def _check_state(module, new_s, old_s, train):
    got = flatten(read_state(module, new_s))
    for name, w in flatten(new_s).items():
        assert _rel(got[name], w) < 1e-5, name
        if not train:
            np.testing.assert_array_equal(got[name], flatten(old_s)[name])


def _starts(key, b, n):
    return torch.from_numpy(np.array(jax.random.randint(key, (b,), 0, n)))


# name, JAX init, port module, points, the JAX apply's FPS-taking flag
CASES = {
    "PointBERT": (lambda k: JB.ppat_init(k, 1, 6, 48),
                  lambda: PB.PointPatchTransformer(1, 6, 48), 300, True),
    "DGCNN": (lambda k: JB.dgcnn_init(k, 6, 48, 1),
              lambda: PB.DGCNN(6, 48, 1), 128, False),
    "PointNet": (lambda k: JB.pointnet_init(k, 6, 48, 1),
                 lambda: PB.PointNet(6, 48, 1), 300, False),
}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_baseline_matches_jax(name, train):
    """[B, 48] embeddings of JAX's apply (through make_pc_baseline) and the
    new running statistics; PPAT's FPS from JAX's starts. A train pass
    takes B = 8: DGCNN's bn6 and PointNet's top BatchNorm normalise pooled
    features over the batch alone, and at B = 2 their fp32 variance (E[x^2]
    - mean^2 of two values) cancels so far that JAX and the port each read
    1e-3 from a float64 evaluation of the same function."""
    init, make, n, takes_fps = CASES[name]
    p, s = _random_bn(*init(jax.random.PRNGKey(3)), seed=4)
    b = 8 if train else 2
    x = _cloud(b, n, seed=5)
    key = jax.random.PRNGKey(6)
    _, apply = JB.make_pc_baseline(name, in_channel=6, out_channel=48,
                                   scaling=1)
    kw = dict(fps_key=key) if takes_fps else {}
    want, new_s = jax.jit(functools.partial(apply, train=train, **kw))(
        p, s, jnp.asarray(x[..., :3]), jnp.asarray(x))
    model = _port(make(), p, s)
    kw = dict(fps_start=_starts(key, b, n)) if takes_fps else {}
    with torch.no_grad():
        got = model(torch.from_numpy(x[..., :3]), torch.from_numpy(x),
                    train=train, **kw)
    assert tuple(got.shape) == (b, 48)
    assert _rel(got.numpy(), want) < 1e-5
    _check_state(model, new_s, s, train)


@pytest.mark.parametrize("train", [False, True])
def test_pointnet2_matches_jax(train):
    """(log-softmax logits, l3 feature) of pointnet2_apply; JAX passes one
    fps_key to both MSG levels, so the port gets JAX's draws at N and at
    512 points, one a level. A train pass takes B = 8 (bn1 and bn2
    normalise over the batch alone: at B = 2 the fp32 E[x^2] - mean^2 of a
    channel can fall below -eps and give NaN, in either package). Its
    BatchNorms reduce over up to 8 x 512 x 128 rows, and JAX's fp32
    statistics read 3.6e-5 (feature) and 7e-5 (logits) from a float64
    evaluation of the same module, the port's 3e-6 and 7e-6: in train mode
    the port is held to 1e-5 of its float64 evaluation and to 1e-4 of
    JAX."""
    p, s = _random_bn(*JB.pointnet2_init(jax.random.PRNGKey(7), 10), seed=8)
    b = 8 if train else 2
    x = _cloud(b, 600, seed=9)
    key = jax.random.PRNGKey(10)
    (want, want_feat), new_s = jax.jit(functools.partial(
        JB.pointnet2_apply, train=train, fps_key=key))(p, s, jnp.asarray(x))
    model = _port(PB.PointNet2(10), p, s)
    with torch.no_grad():
        got, feat = model(torch.from_numpy(x), train=train,
                          fps_start=(_starts(key, b, 600), _starts(key, b, 512)))
    assert tuple(got.shape) == (b, 10) and tuple(feat.shape) == (b, 1024)
    tol = 1e-4 if train else 1e-5
    assert _rel(got.numpy(), want) < tol
    assert _rel(feat.numpy(), want_feat) < tol
    if train:
        exact = _port(PB.PointNet2(10), p, s).double()
        with torch.no_grad():
            got64, feat64 = exact(torch.from_numpy(x).double(), train=True,
                                  fps_start=(_starts(key, b, 600),
                                             _starts(key, b, 512)))
        assert _rel(got.numpy(), got64.numpy()) < 1e-5
        assert _rel(feat.numpy(), feat64.numpy()) < 1e-5
    got_s = flatten(read_state(model, new_s))
    for name, w in flatten(new_s).items():
        assert _rel(got_s[name], w) < tol, name
        if not train:
            np.testing.assert_array_equal(got_s[name], flatten(s)[name])


def test_set_abstraction_concat_orders():
    """Single-scale grouping puts the centred xyz first, MSG the points
    first: a set abstraction whose first conv reads only the first three
    input channels sees xyz in one and the points in the other."""
    xyz = torch.from_numpy(_cloud(1, 64, seed=11)[..., :3])
    pts = torch.full((1, 64, 3), 5.0)
    sa = PB.SetAbstraction(6, [4])
    msg = PB.SetAbstractionMsg(3, [[4]])
    for m in (sa, msg):
        m.init_(torch.Generator().manual_seed(0))
    for layer in (sa.mlp[0], msg.branches[0][0]):
        with torch.no_grad():
            layer.conv.w[3:] = 0
            layer.conv.b.zero_()
    start = torch.zeros(1, dtype=torch.int32)
    kw = dict(npoint=8, train=False, fps_start=start)
    _, f_sa = sa(xyz, pts, radius=0.5, nsample=4, group_all=False, **kw)
    _, f_msg = msg(xyz, pts, radius_list=[0.5], nsample_list=[4], **kw)
    # the points are constant: MSG's first conv sees only them
    assert torch.allclose(f_msg, f_msg[:, :1].expand_as(f_msg))
    assert not torch.allclose(f_sa, f_sa[:, :1].expand_as(f_sa))


@pytest.mark.parametrize("name", ["PointNet2", "Minkowski", "PointNeXt",
                                  "PointMLP"])
def test_make_pc_baseline_raises_as_jax(name):
    with pytest.raises(NotImplementedError) as want:
        JB.make_pc_baseline(name)
    with pytest.raises(NotImplementedError) as got:
        PB.make_pc_baseline(name)
    assert str(got.value) == str(want.value)


# -- the reference layouts --------------------------------------------------------

def _trees_equal(got, want):
    got, want = flatten(got), flatten(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


CONVERTERS = {
    "ppat": (lambda g: RL.ppat_state_dict(1, g, out_channel=48),
             lambda sd, c: c.convert_ppat_state_dict(sd, 6),
             lambda: PB.PointPatchTransformer(1, 6, 48)),
    "dgcnn": (lambda g: RL.dgcnn_state_dict(g, out_channel=48),
              lambda sd, c: c.convert_dgcnn_state_dict(sd),
              lambda: PB.DGCNN(6, 48, 1)),
    "pointnet2": (lambda g: RL.pointnet2_state_dict(g, num_class=10),
                  lambda sd, c: c.convert_pointnet2_state_dict(sd),
                  lambda: PB.PointNet2(10)),
}


@pytest.mark.parametrize("name", sorted(CONVERTERS))
def test_converter_matches_jax(name):
    """The port's converter gives JAX's trees exactly on a reference-layout
    state dict (a DDP 'module.' prefix stripped), and they load into the
    port's module whole: every parameter and running statistic set."""
    write, convert, make = CONVERTERS[name]
    sd = write(torch.Generator().manual_seed(12))
    sd = {"module." + k: v for k, v in sd.items()}
    want_p, want_s = convert(sd, JC)
    got_p, got_s = convert(sd, PCV)
    _trees_equal(got_p, want_p)
    _trees_equal(got_s, want_s)
    _port(make(), got_p, got_s)
