"""The port's data parallelism on the CPU: two gloo ranks (one process each,
joined through ``parallel.mesh.init_distributed`` from torchrun-style
variables) held against JAX's ``shard_map`` on two of the eight virtual CPU
devices, ``Mesh(devs[:2], ("data",))``.

One pair of rank processes runs every case of this file: the parent writes
the weights and inputs (``plan.pkl``), each rank writes its results
(``rank{r}.pkl``), and the tests compare them with what JAX computes in the
parent meanwhile. A rank never imports jax. The cases:

- the DP train step (``make_train_step(mesh=make_mesh())``) against JAX's DP
  step, with ``local_loss`` on and off: the tri loss with the label mask,
  the CLIP pair with the sim mask, accum_freq 2, the pc tri step with
  synced BatchNorm and the video distill-tokens step. Loss and grad_norm to
  1e-5 relative, each gradient to 1e-5 of its max|ref| (before the
  optimizer), the parameters after the step to 5e-5 absolute (JAX's own DP
  bar, tests/test_train_step.py), the BatchNorm running statistics to 1e-5
  relative; both ranks hold the same parameters after the step;
- ``coca_loss`` and ``openshape_loss`` (a PointNet bind: BatchNorm synced)
  over the two ranks against JAX's ``axis_name`` versions, 1e-5 relative;
- the gather and mean Functions' gradients and synced BatchNorm against one
  process over the whole batch, 1e-6 relative.

Run this file as a script (``python tests/test_torch_parallel.py PLAN OUT``,
with torchrun's variables set) to run one rank.
"""

import os
import pickle
import socket
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch
from tests.test_torch_threads import child_env, share_cores

share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
RANK_TIMEOUT_S = 240
LR = 1e-3


# ---------------------------------------------------------------------------
# rank processes
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(argv, out_dir, world=WORLD, env=None, cwd=REPO):
    """Start ``argv`` (a list, or a function of the rank giving one) as
    ``world`` ranks with torchrun's variables on a free localhost port,
    stdout and stderr in files under ``out_dir``. Returns (processes, log
    paths) for :func:`wait_ranks`."""
    os.makedirs(out_dir, exist_ok=True)
    port = str(free_port())
    procs, logs = [], []
    for r in range(world):
        e = child_env(world, env)  # the ranks' share of the cores
        e.update(WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                 PYTHONPATH=REPO + os.pathsep + e.get("PYTHONPATH", ""))
        log = os.path.join(out_dir, f"rank{r}.log")
        logs.append(log)
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                argv(r) if callable(argv) else argv, stdout=f,
                stderr=subprocess.STDOUT, env=e, cwd=cwd))
    return procs, logs


def wait_ranks(procs, logs, timeout=RANK_TIMEOUT_S):
    """Wait for every rank; kill them all when one fails or the time runs
    out, and raise with each rank's log then."""
    deadline = time.time() + timeout
    failed = None
    while any(p.poll() is None for p in procs):
        bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        if bad or time.time() > deadline:
            failed = (f"rank {bad[0]} exited {procs[bad[0]].returncode}" if bad
                      else f"timeout after {timeout} s")
            break
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    if failed is None and any(p.returncode for p in procs):
        failed = f"exit codes {[p.returncode for p in procs]}"
    if failed:
        tails = "\n".join(f"--- rank {r} ---\n" + open(log).read()[-3000:]
                          for r, log in enumerate(logs))
        raise AssertionError(f"ranks failed: {failed}\n{tails}")
    return logs


def _rank_rows(x, rank, world=WORLD):
    b = x.shape[0] // world
    return x[rank * b:(rank + 1) * b]


def _run_step(case, mesh, local_loss):
    from vitlens_tpu_torch.factory import make_trainable_
    from vitlens_tpu_torch.models.tri import TriModel
    from vitlens_tpu_torch.train import freeze as PF
    from vitlens_tpu_torch.train import step as PStep

    model = TriModel(case["pcfg"], device="cpu")
    model.load_state_dict(case["state_dict"])
    mask = PF.tri_model_mask(model, case["pcfg"], **case["flags"])
    tx, mask = PStep.make_optimizer(model, PStep.OptimizerConfig(**case["ocfg"]),
                                    mask)
    make_trainable_(model, mask, torch.float32)
    state = PStep.init_train_state(model, tx)
    step = PStep.make_train_step(case["pcfg"], tx, mask, PStep.StepConfig(
        compute_dtype=torch.float32, local_loss=local_loss, **case["step"]),
        mesh=mesh)
    grads, update = {}, tx.update_

    def grabbing(params, g, st):  # the averaged gradients, before AdamW
        grads.update({n: t.detach().clone() for n, t in g.items()})
        return update(params, g, st)

    tx.update_ = grabbing
    batch = {k: _rank_rows(v, mesh.rank) for k, v in case["batch"].items()}
    starts = case.get("starts")
    state, m = step(state, batch, fps_starts=None if starts is None
                    else starts[mesh.rank])
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": {n: g.numpy() for n, g in grads.items()},
            "params": {n: p.detach().numpy().copy()
                       for n, p in model.named_parameters() if mask[n]},
            "buffers": {n: b.numpy().copy() for n, b in model.named_buffers()
                        if n.endswith((".mean", ".var"))}}


def _run_losses(plan, mesh):
    from vitlens_tpu_torch.train import openshape as POS
    from vitlens_tpu_torch.train.losses import coca_loss

    r = mesh.rank
    co = plan["coca"]
    out = {k: torch.from_numpy(_rank_rows(v, r)) for k, v in co["out"].items()}
    out["logit_scale"] = torch.tensor(co["scale"])
    contrastive, caption = coca_loss(out, types.SimpleNamespace(**co["cfg"]),
                                     axis_name=mesh)
    os_ = plan["openshape"]
    model = POS.BaselineBind("PointNet", in_channel=6, out_channel=16, scaling=1)
    model.load_state_dict(os_["state_dict"])
    batch = {k: torch.from_numpy(_rank_rows(v, r)) for k, v in os_["batch"].items()}
    loss, metrics = POS.openshape_loss(model, batch, axis_name=mesh,
                                       image_weight=0.5)
    return {"coca": (float(contrastive), float(caption)),
            "openshape": dict({k: float(v) for k, v in metrics.items()},
                              loss=float(loss)),
            "openshape_buffers": {n: b.numpy().copy()
                                  for n, b in model.named_buffers()}}


def _run_functions(plan, mesh):
    """Each rank's loss of the gathered rows, of the mean and of synced
    BatchNorm, with rank-own weights; the gradients of its own rows."""
    from vitlens_tpu_torch.adapters.tokenizers import BatchNorm, batch_norm_synced
    from vitlens_tpu_torch.parallel.mesh import all_gather, all_reduce_mean

    fn, r = plan["functions"], mesh.rank
    x = torch.from_numpy(_rank_rows(fn["x"], r)).requires_grad_(True)
    t = torch.from_numpy
    (t(fn["w"][r]) * all_gather(x, mesh)).sum().backward()
    g_gather = x.grad.numpy().copy()
    x.grad = None
    (t(fn["v"][r]) * all_reduce_mean(x, mesh)).sum().backward()
    g_mean = x.grad.numpy().copy()
    x.grad = None
    bn = BatchNorm(fn["x"].shape[-1]).requires_grad_(True)
    bn.init_(None)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(fn["scale"]))
    with batch_norm_synced(bn, mesh):
        y = bn(x, train=True)
    (t(fn["u"][r]) * y).sum().backward()
    return {"gather": g_gather, "mean": g_mean, "bn_out": y.detach().numpy(),
            "bn_x": x.grad.numpy(), "bn_scale": bn.scale.grad.numpy(),
            "bn_mean": bn.mean.numpy(), "bn_var": bn.var.numpy()}


def _worker(plan_path, out_dir) -> int:
    from vitlens_tpu_torch.parallel.mesh import init_distributed, make_mesh

    rank = init_distributed(device="cpu", timeout_s=120)
    mesh = make_mesh()
    assert (mesh.data, mesh.rank, mesh.backend) == (WORLD, rank, "gloo")
    with open(plan_path, "rb") as f:
        plan = pickle.load(f)
    res = {"steps": {(name, local): _run_step(case, mesh, local)
                     for name, case in plan["steps"].items()
                     for local in (True, False)}}
    if "coca" in plan:
        res.update(_run_losses(plan, mesh))
        res["functions"] = _run_functions(plan, mesh)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_worker(*sys.argv[1:]))


# ---------------------------------------------------------------------------
# the parent: plan, JAX's results, comparisons
# ---------------------------------------------------------------------------

# name: (modality, StepConfig fields, mask flags, frames of batch["image"],
# label, optimizer fields); this file runs the first two,
# test_torch_parallel_accum.py accum2 and test_torch_parallel_pc_video.py
# the pc and video ones (so that the files' JAX compiles run on several
# test workers)
STEP_CASES = {
    "tri_label_mask": ("depth", dict(n_tower=3, contra_loss_type="label_mask"),
                       dict(unlock_cls=True), 0, True, {}),
    "clip_sim_mask": ("image", dict(n_tower=2, align_to="clip",
                                    contra_loss_type="sim_mask", sim_thres=0.0),
                      dict(lock_image=False, lock_text=False), 0, False,
                      dict(grad_clip_norm=1.0)),
    "accum2": ("depth", dict(n_tower=3, accum_freq=2),
               dict(unlock_trans_first_n_layers=1), 0, False, {}),
    "pc_sync_bn": ("pc", dict(n_tower=3, sync_bn=True),
                   dict(lock_image=True, lock_text=True, lock_visual=True), 0,
                   False, {}),
    "video_distill": ("video", dict(n_tower=3, video_distill=True,
                                    contra_loss_type="distill_token"), {}, 8,
                      False, {}),
}
HERE = ("tri_label_mask", "clip_sim_mask")


def cases_of(names):
    return [(name, local) for name in names for local in (True, False)]


CASES = cases_of(HERE)
B = 4  # the global batch: 2 rows a rank (8 at accum_freq 2: JAX's
# tests/test_accum_sharded.py shapes, 4 rows a rank in 2 micro-batches of 2)


def _case_name(name, local):
    return f"{name}-{'local' if local else 'full'}"


def _step_batch(modality, seed, frames, label, n=B):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, 49000, size=(n, 77)).astype(np.int32)
    text[:, 0], text[:, -1] = 49406, 49407
    images = rng.randn(*((n, frames) if frames else (n,)), 3, 28, 28)
    batch = {"text": text, "image": images.astype(np.float32)}
    if modality == "pc":
        batch["visual"] = (rng.randn(n, 256, 3) * 0.3).astype(np.float32)
    elif modality == "depth":
        batch["visual"] = rng.randn(n, 1, 28, 28).astype(np.float32)
    elif modality == "video":
        batch["visual"] = batch["image"]
    else:
        batch["visual"] = rng.randn(n, 3, 28, 28).astype(np.float32)
    if label:
        batch["label"] = (np.arange(n) % 2).astype(np.int32)
    return batch


def _stash():
    """An optax transformation that keeps the gradients it is given as its
    state, so that a JAX step's gradients can be read after it."""
    import optax

    return optax.GradientTransformation(lambda p: p, lambda g, s, p=None: (g, g))


def _jax_mesh():
    from jax.sharding import Mesh

    from tests.conftest import cpu_devices

    return Mesh(np.array(cpu_devices()[:WORLD]), ("data",))


def _step_plans(names):
    """({recipe: what the ranks run}, {recipe: JAX's config, weights, state,
    batch and key}). A recipe's weights are JAX's init, carried into the
    port's model (the ranks load its state dict)."""
    import jax

    from tests.test_torch_pc_train import SMALL, _without_cancelled_biases
    from vitlens_tpu.config import PointAdapterConfig as JaxPointConfig
    from vitlens_tpu.config import make_model_config as jax_model_config
    from vitlens_tpu.models import tri as JT
    from vitlens_tpu_torch import config as PC
    from vitlens_tpu_torch.models.tri import TriModel
    from vitlens_tpu_torch.weights.from_jax import load_state, load_tri_params

    plans, jax_in = {}, {}
    for name in names:
        i = list(STEP_CASES).index(name)
        modality, step_kw, flags, frames, label, opt = STEP_CASES[name]
        if modality == "pc":
            jcfg = jax_model_config("ViT-Tiny-Test", "pc",
                                    point=JaxPointConfig(**SMALL, knn_exact=True))
            pcfg = PC.make_model_config("ViT-Tiny-Test", "pc",
                                        point=PC.PointAdapterConfig(**SMALL))
        else:
            jcfg = jax_model_config("ViT-Tiny-Test", modality)
            pcfg = PC.make_model_config("ViT-Tiny-Test", modality)
        params, state = JT.tri_model_init(jax.random.PRNGKey(i), jcfg)
        if modality == "pc":
            params["visual"]["adapter"] = _without_cancelled_biases(
                params["visual"]["adapter"])
        model = load_tri_params(TriModel(pcfg, device="cpu"), params)
        load_state(model, state)
        ocfg = dict(lr=LR, eps=1e-4, warmup=2, total_steps=10, **opt)
        A = step_kw.get("accum_freq", 1)
        batch = _step_batch(modality, 20 + i, frames, label, B * A)
        plan = {"pcfg": pcfg, "state_dict": model.state_dict(), "flags": flags,
                "ocfg": ocfg, "batch": batch, "step": step_kw}
        key = jax.random.PRNGKey(40) if modality == "pc" else None
        if modality == "pc":
            # JAX folds fps_key with the rank (axis_index), then with the
            # micro-batch's index at accum_freq > 1
            b = B * A // WORLD
            plan["starts"] = []
            for r in range(WORLD):
                kr = jax.random.fold_in(key, r)
                keys = [kr] if A == 1 else [jax.random.fold_in(kr, j)
                                            for j in range(A)]
                plan["starts"].append([torch.from_numpy(np.array(
                    jax.random.randint(k, (b // A,), 0, 256))) for k in keys])
        plans[name] = plan
        jax_in[name] = (jcfg, params, state, batch, key, i % 2 == 0)
    return plans, jax_in


def _jax_steps(jax_in):
    """{recipe: (TrainState, gradients, metrics)} of one step of JAX's
    shard_map DP step over two devices. ``local_loss`` alternates over the
    recipes (on for the first): in exact arithmetic it changes neither the
    loss nor the gradient (each rank's mean over its rows of the CE against
    every rank's columns averages to the global loss), so the port's step
    with either setting is held to the same step."""
    import jax
    import jax.numpy as jnp
    import optax

    from vitlens_tpu.train import freeze as JF
    from vitlens_tpu.train import step as JStep

    mesh = _jax_mesh()
    out = {}
    for name, (jcfg, params, state, batch, key, local) in jax_in.items():
        _, step_kw, flags, _, _, opt = STEP_CASES[name]
        ocfg = dict(lr=LR, eps=1e-4, warmup=2, total_steps=10, **opt)
        jmask = JF.tri_model_mask(params, jcfg, **flags)
        jtx, jmask = JStep.make_optimizer(params, JStep.OptimizerConfig(**ocfg),
                                          jmask)
        tx = optax.chain(_stash(), jtx)
        jstep = JStep.make_train_step(jcfg, tx, jmask, JStep.StepConfig(
            compute_dtype=jnp.float32, local_loss=local, **step_kw), mesh=mesh)
        ts = JStep.init_train_state(params, state, tx)
        ts, jm = jstep(ts, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        ts = jax.device_get(ts)
        # the frozen leaves' gradients are scalar zeros: broadcast them
        grads = jax.tree.map(lambda g, p: np.broadcast_to(g, np.shape(p)),
                             ts.opt_state[0], ts.params)
        out[name] = (ts, grads, jax.device_get(jm))
    return out


def _loss_plans():
    rng = np.random.RandomState(5)

    def unit(*shape):
        x = rng.randn(*shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    labels = rng.randint(0, 12, size=(B, 6)).astype(np.int64)
    labels[:, -1] = 0  # a pad
    coca = {"out": {"image_features": unit(B, 16), "text_features": unit(B, 16),
                    "logits": rng.randn(B, 6, 12).astype(np.float32),
                    "labels": labels},
            "scale": np.float32(10.0),
            "cfg": dict(contrastive_loss_weight=1.0, caption_loss_weight=2.0,
                        pad_id=0)}
    cloud = np.concatenate([rng.randn(B, 64, 3) * 0.3, rng.rand(B, 64, 3)], -1)
    os_batch = {"xyz_features": cloud.astype(np.float32),
                "text_feat": rng.randn(B, 16).astype(np.float32),
                "img_feat": rng.randn(B, 16).astype(np.float32)}
    n, d = B, 8
    functions = {"x": rng.randn(n, d).astype(np.float32),
                 "w": rng.randn(WORLD, n, d).astype(np.float32),
                 "v": rng.randn(WORLD, n // WORLD, d).astype(np.float32),
                 "u": rng.randn(WORLD, n // WORLD, d).astype(np.float32),
                 "scale": (1 + 0.3 * rng.randn(d)).astype(np.float32)}
    return coca, os_batch, functions


def _bind():
    """JAX's PointNet bind (params, state) and the port's, loaded from it."""
    import jax

    from vitlens_tpu.train import openshape as JOS
    from vitlens_tpu_torch.train import openshape as POS
    from vitlens_tpu_torch.weights.from_jax import load_params, load_state

    p, s = JOS.baseline_bind_init(jax.random.PRNGKey(3), "PointNet", in_channel=6,
                                  out_channel=16, scaling=1)
    bind = POS.BaselineBind("PointNet", in_channel=6, out_channel=16, scaling=1)
    load_params(bind, p)
    load_state(bind, s)
    return p, s, bind


def _jax_losses(coca, os_batch, p, s):
    """JAX's coca_loss and openshape_loss (the PointNet bind) under
    shard_map over the two devices: per-rank values, and the bind's new
    state."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from vitlens_tpu.models import coca as JC
    from vitlens_tpu.train import openshape as JOS

    mesh = _jax_mesh()
    cfg = types.SimpleNamespace(**coca["cfg"])

    def coca_fn(out):
        out = dict(out, logit_scale=jnp.float32(coca["scale"]))
        c, k = JC.coca_loss(out, cfg, axis_name="data")
        return c[None], k[None]

    got = jax.jit(shard_map(coca_fn, mesh=mesh, in_specs=(P("data"),),
                            out_specs=P("data"), check_vma=False))(
        {k: jnp.asarray(v) for k, v in coca["out"].items()})

    def os_fn(p_, s_, b_):
        loss, (m, new_s) = JOS.openshape_loss(
            p_, s_, b_, None, axis_name="data", pc_model="PointNet",
            pc_scaling=1, pc_in_channel=6, image_weight=0.5)
        return dict({k: v[None] for k, v in m.items()}, loss=loss[None]), new_s

    os_out, new_s = jax.jit(shard_map(
        os_fn, mesh=mesh, in_specs=(P(), P(), P("data")),
        out_specs=(P("data"), P()), check_vma=False))(
        p, s, {k: jnp.asarray(v) for k, v in os_batch.items()})
    return jax.device_get(got), jax.device_get(os_out), jax.device_get(new_s)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Writes the plan, starts the ranks, computes JAX's results while they
    run, and returns (plan, JAX's results, [rank 0's, rank 1's])."""
    root = tmp_path_factory.mktemp("parallel")
    coca, os_batch, functions = _loss_plans()
    plans, jax_in = _step_plans(HERE)
    jp, js, bind = _bind()
    plan = {"steps": plans, "coca": coca, "functions": functions,
            "openshape": {"batch": os_batch, "state_dict": bind.state_dict()}}
    with open(root / "plan.pkl", "wb") as f:
        pickle.dump(plan, f)
    ranks = start_ranks([sys.executable, os.path.abspath(__file__),
                         str(root / "plan.pkl"), str(root)], str(root))
    try:
        jax_out = {"steps": _jax_steps(jax_in)}
        jax_out["coca"], *jax_out["openshape"] = _jax_losses(coca, os_batch, jp, js)
    finally:
        wait_ranks(*ranks)
    got = []
    for r in range(WORLD):
        with open(root / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return plan, jax_out, got


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1e-12, np.abs(want).max())


@pytest.mark.parametrize("name,local", CASES,
                         ids=[_case_name(n, l) for n, l in CASES])
def test_dp_step_matches_jax_shard_map(run, name, local):
    """The DP step against JAX's shard_map DP step, to check_dp_step's
    bars."""
    check_dp_step(run, name, local)


def check_dp_step(run, name, local):
    """Loss and grad_norm (the averaged gradient's) 1e-5 relative; every
    trainable gradient before AdamW to 1e-5 of its max|ref|; the trainable
    parameters after the step 5e-5 absolute, and equal on both ranks; the
    BatchNorm running statistics 1e-5 relative and equal on both ranks. The
    biases that a batch-statistics BatchNorm cancels (the pc tokenizer's
    conv1..3, tests/test_torch_pc_train.py) have a gradient that is zero in
    exact arithmetic: both sides' rounding noise, held below 1e-5 of their
    weight's gradient."""
    from tests.test_torch_pc_train import CANCELLED
    from vitlens_tpu_torch.weights.from_jax import flatten

    ts, jgrads, jm = run[1]["steps"][name]
    got = [r["steps"][(name, local)] for r in run[2]]
    for k in ("loss", "grad_norm", "logit_scale"):
        assert _rel(got[0]["metrics"][k], jm[k]) < 1e-5, k
        assert got[1]["metrics"][k] == got[0]["metrics"][k], k
    want_g = flatten(jgrads)
    want_p = flatten(ts.params)
    assert got[0]["grads"] and sorted(got[0]["grads"]) == sorted(got[0]["params"])
    cancelled = tuple(f"adapter.encoder.{c}.b" for c in CANCELLED)
    for n, g in got[0]["grads"].items():
        if n.endswith(cancelled):
            scale = np.abs(want_g[n[:-1] + "w"]).max()
            assert max(np.abs(g).max(), np.abs(want_g[n]).max()) < 1e-5 * scale, n
        else:
            assert _rel(g, want_g[n]) < 1e-5, n
        np.testing.assert_allclose(got[0]["params"][n], want_p[n], rtol=0,
                                   atol=5e-5, err_msg=n)
        np.testing.assert_array_equal(got[1]["params"][n], got[0]["params"][n])
    bufs = got[0]["buffers"]
    want_s = flatten(ts.model_state) if STEP_CASES[name][0] == "pc" else {}
    assert sorted(want_s) == sorted(bufs)
    for n, w in want_s.items():
        assert _rel(bufs[n], w) < 1e-5, n
        np.testing.assert_array_equal(got[1]["buffers"][n], bufs[n])
    assert len(bufs) == (4 if STEP_CASES[name][0] == "pc" else 0)


def test_coca_loss_over_ranks_matches_jax(run):
    """Each rank's (contrastive, caption) against JAX's coca_loss with
    axis_name inside shard_map, 1e-5 relative."""
    want_c, want_k = run[1]["coca"]
    for r, res in enumerate(run[2]):
        c, k = res["coca"]
        assert _rel(c, want_c[r]) < 1e-5 and _rel(k, want_k[r]) < 1e-5, r


def test_openshape_loss_over_ranks_matches_jax(run):
    """Each rank's openshape loss and its four metrics (a PointNet bind in
    train mode, features gathered over the ranks) against JAX's
    openshape_loss with axis_name, 1e-5 relative; the BatchNorm statistics
    it moved, synced over the ranks, too."""
    from vitlens_tpu_torch.weights.from_jax import flatten

    jos, jnew_s = run[1]["openshape"]
    for r, res in enumerate(run[2]):
        for k, v in res["openshape"].items():
            assert _rel(v, jos[k][r]) < 1e-5, (r, k)
    want = flatten(jnew_s)
    got = run[2][0]["openshape_buffers"]
    assert want and sorted(want) == sorted(got)
    for n, w in want.items():
        assert _rel(got[n], w) < 1e-5, n
        np.testing.assert_array_equal(run[2][1]["openshape_buffers"][n], got[n])


def test_collective_gradients_match_one_process(run):
    """all_gather's and all_reduce_mean's gradients of each rank's own rows,
    and synced BatchNorm's output, input and scale gradients and running
    statistics, against one process over the whole batch whose loss is the
    sum of the ranks' losses; 1e-6 relative."""
    from vitlens_tpu_torch.adapters.tokenizers import BatchNorm

    fn = run[0]["functions"]
    x = torch.from_numpy(fn["x"]).requires_grad_(True)
    sum(((torch.from_numpy(w) * x).sum() for w in fn["w"])).backward()
    want_gather = x.grad.numpy().copy()
    x.grad = None
    sum((torch.from_numpy(v) * x.view(WORLD, -1, x.shape[-1]).mean(0)).sum()
        for v in fn["v"]).backward()
    want_mean = x.grad.numpy().copy()
    x.grad = None
    bn = BatchNorm(x.shape[-1]).requires_grad_(True)
    bn.init_(None)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(fn["scale"]))
    y = bn(x, train=True)
    (torch.from_numpy(np.concatenate(list(fn["u"]))) * y).sum().backward()
    for r, res in enumerate(r_["functions"] for r_ in run[2]):
        assert _rel(res["gather"], _rank_rows(want_gather, r)) < 1e-6, r
        assert _rel(res["mean"], _rank_rows(want_mean, r)) < 1e-6, r
        assert _rel(res["bn_out"], _rank_rows(y.detach().numpy(), r)) < 1e-6, r
        assert _rel(res["bn_x"], _rank_rows(x.grad.numpy(), r)) < 1e-6, r
        assert _rel(res["bn_mean"], bn.mean.numpy()) < 1e-6, r
        assert _rel(res["bn_var"], bn.var.numpy()) < 1e-6, r
    # each rank holds its own rows' share of the scale gradient
    got_scale = sum(r_["functions"]["bn_scale"] for r_ in run[2])
    assert _rel(got_scale, bn.scale.grad.numpy()) < 1e-6
