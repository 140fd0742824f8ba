"""The port's FSDP (``parallel.fsdp``: FSDP2 over two gloo ranks on the CPU)
held against JAX's GSPMD FSDP step (``make_train_step(partition="fsdp")``
after ``fsdp_place(min_elems=128)`` on ``Mesh(devs[:2], ("data",))``),
mirroring tests/test_fsdp.py, tests/test_checkpoint.py's sharded save and
restore and the ``--fsdp`` runs of tests/test_cli.py and
tests/test_multihost.py.

One pair of rank processes runs every case of this file: the parent writes
the weights and inputs (``plan.pkl``), each rank writes its results
(``rank{r}.pkl``), and the tests compare them with what JAX computes in the
parent meanwhile. A rank never imports jax. The cases:

- the rule: ``fsdp_spec`` on JAX's cases; the axis of every parameter of
  tests/test_train_step.py's tiny model at ``min_elems=128`` against JAX's
  spec of its leaf (a block's row of a stacked leaf: the same axis less the
  layer axis), and the ranks' placements and local sizes;
- the step, one step from JAX's init: the tri step in fp32, accum_freq 2
  (image and text locked), and the pc tri step with BatchNorm and
  ``sync_bn=False`` at accum_freq 1 and 2 (JAX's global step takes its
  moments over the global batch, and its micro-batches are contiguous
  slices of it; FPS starts from JAX's key, global); loss and grad_norm 1e-5
  relative, each gradient before AdamW 1e-5 of its max|ref|, the
  parameters after the step 5e-5 absolute (tests/test_fsdp.py's bar), the
  BatchNorm statistics 1e-5 relative; bf16 with remat finite;
- the step's own draws: each rank's FPS starts and patch dropout are its
  rows of one global draw, and the pc accum_freq-2 step with a generator
  seeded alike on both ranks equals the step given that global draw;
- over two steps the placements of the parameters and the moments stay as
  placed, and both ranks' gathered parameters agree;
- the collective checkpoint: ``meta.json`` ``sharded`` and the
  ``latest.json`` pointer; a reload into the two-rank state and a load
  into one process, unsharded, bit for bit; ``save_best_sharded`` agreed
  over the ranks;
- ``cli.train --fsdp`` over the two ranks: train with an eval set of 7
  samples in batches of 3 (pads on every call), save, resume ("resumed
  (sharded) from");
- LoRA under FSDP: the tri step with rank-4 factors on the visual trunk and
  rank-1 factors on the text trunk (b drawn away from zero), the factors
  and the logit scale alone trained, against JAX's step on the tree
  carrying ``"lora"`` (the same bars); the factors' placements leaf by leaf
  (the rule on JAX's stacked factor; the rank-1 ``a``s under
  ``min_elems``); every base weight bit-equal after the step; the
  collective checkpoint of that state; and ``cli.train --fsdp
  --lora-rank 4`` saving and resuming.

Run this file as a script (``python tests/test_torch_fsdp.py PLAN OUT``,
torchrun's variables set) to run one rank.
"""

import json
import os
import pickle
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tests.test_torch_parallel import start_ranks, wait_ranks  # noqa: E402

WORLD = 2
MIN_ELEMS = 128
OPT = dict(lr=1e-3, warmup=1, total_steps=100)
B = 4  # the global batch of the tri and pc cases (16 and 8 at accum_freq 2)
GEN_SEED = 7  # the pc_gen case's generator, alike on both ranks


def _tiny(C):
    """tests/test_train_step.py's tiny_model_cfg, in either package's
    config module."""
    arch = C.VisionArch(image_size=28, patch_size=14, width=32, layers=2,
                        head_width=16)
    eeg = C.EEGAdapterConfig(chans=8, time_len=16, window_size=1, stride=1)
    tower = C.TowerConfig(
        arch=arch, embed_dim=16, modality="eeg", eeg=eeg,
        perceiver=C.PerceiverConfig(
            depth=1, num_latents=4, latent_dim=32, input_dim=32,
            cross_heads=1, cross_dim_head=8, latent_heads=2, latent_dim_head=8,
            self_per_cross_attn=1))
    return C.ModelConfig(
        name="tiny", embed_dim=16, vision=arch,
        text=C.TextArch(context_length=8, vocab_size=50, width=32, heads=2,
                        layers=2),
        tower=tower)


# ---------------------------------------------------------------------------
# rank processes
# ---------------------------------------------------------------------------


def _rows(x, rank):
    b = x.shape[0] // WORLD
    return x[rank * b:(rank + 1) * b]


def _state(case, mesh=None):
    """(model, tx, mask, state) of a case, placed over ``mesh`` when
    given."""
    from vitlens_tpu_torch.factory import make_trainable_
    from vitlens_tpu_torch.parallel.fsdp import fsdp_place
    from vitlens_tpu_torch.train import step as S

    model = _model(case)
    mask = case["mask"]
    tx, mask = S.make_optimizer(model, S.OptimizerConfig(**case["opt"]), mask)
    make_trainable_(model, mask, torch.float32)
    state = S.init_train_state(model, tx)
    if mesh is not None:
        fsdp_place(state, mesh, min_elems=MIN_ELEMS)
    return model, tx, mask, state


def _unloaded(case):
    """The case's TriModel on the CPU with its LoRA factors attached
    (``case["lora"]``: {tower: rank})."""
    from vitlens_tpu_torch.models.tri import TriModel
    from vitlens_tpu_torch.train.lora import lora_init

    model = TriModel(case["pcfg"], device="cpu")
    for tower, rank in case.get("lora", {}).items():
        lora_init(getattr(model, tower), rank, torch.Generator())
    return model


def _model(case):
    """:func:`_unloaded`, loaded from the case's state dict."""
    model = _unloaded(case)
    model.load_state_dict(case["state_dict"])
    return model


def _gathered(model):
    from vitlens_tpu_torch.parallel.fsdp import full_tensor

    return {n: full_tensor(p).detach().numpy().copy()
            for n, p in model.named_parameters()}


def _run_step(case, mesh):
    """One FSDP step of ``case`` from its weights on this rank's rows: the
    metrics, the gradients AdamW was given (gathered), the parameters after
    the step (gathered), the BatchNorm statistics, and the placements with
    the local sizes."""
    from vitlens_tpu_torch.parallel import fsdp as F
    from vitlens_tpu_torch.train import step as S

    model, tx, mask, state = _state(case, mesh)
    placed = F.placements_of(state)
    local = {n: tuple(F.local_tensor(p).shape)
             for n, p in model.named_parameters()}
    step = S.make_train_step(case["pcfg"], tx, mask, S.StepConfig(
        **case["step"]), mesh=mesh, partition="fsdp")
    grads, update = {}, tx.update_

    def grabbing(params, g, st, **kw):  # the averaged gradients, before AdamW
        grads.update({n: F.full_tensor(t).detach().float().numpy().copy()
                      for n, t in g.items()})
        return update(params, g, st, **kw)

    tx.update_ = grabbing
    batch = {k: _rows(v, mesh.rank) for k, v in case["batch"].items()}
    gen = (None if "gen_seed" not in case
           else torch.Generator().manual_seed(case["gen_seed"]))
    try:
        state, m = step(state, batch, gen, fps_starts=case.get("starts"))
    finally:
        del tx.update_
    after = _gathered(model)
    out = {"metrics": {k: float(v) for k, v in m.items()}, "grads": grads,
           "params": {n: a for n, a in after.items() if mask[n]},
           "buffers": {n: b.numpy().copy() for n, b in model.named_buffers()
                       if n.endswith((".mean", ".var"))},
           "placed": placed, "local": local,
           "frozen_moved": [n for n, a in after.items() if not mask[n] and
                            not np.array_equal(a, case["state_dict"][n])]}
    return out, (model, tx, mask, state, step, batch)


def _run_generator_case(case, mesh, first):
    """The pc_gen case: this rank's draws from the generator against its
    rows of one global draw (the FPS starts, and the patch dropout of a
    tower that drops patches), and the step from a fresh placement given
    that global draw as ``fps_starts`` against ``first``, the step that drew
    them itself (bit for bit)."""
    from vitlens_tpu_torch import config as PC
    from vitlens_tpu_torch.train import step as S

    A, r = case["step"]["accum_freq"], mesh.rank
    sc = S.StepConfig(**case["step"])
    model = _state(case)[0]
    local = {k: torch.from_numpy(_rows(v, r)) for k, v in case["batch"].items()}
    glob = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    gens = lambda: torch.Generator().manual_seed(case["gen_seed"])  # noqa: E731
    starts = S.draw_fps_starts(model, glob, A, gens())
    mine = S.draw_fps_starts(model, local, A, gens(), WORLD, r)
    out = {"fps": len(mine) == A and all(
        torch.equal(a, _rows(w, r)) for a, w in zip(mine, starts))}
    drop = PC.make_model_config("ViT-Tiny-Test", "image", patch_dropout=0.5)
    model.visual.cfg = drop.tower
    whole = S.draw_patch_keeps(model, glob, sc, gens())
    mine = S.draw_patch_keeps(model, local, sc, gens(), WORLD, r)
    out["patch"] = (len(mine) == A and mine[0].shape[1] < drop.tower.num_tokens
                    and all(torch.equal(a, _rows(w, r))
                            for a, w in zip(mine, whole)))
    given = {k: v for k, v in case.items() if k != "gen_seed"}
    again = _run_step(dict(given, starts=starts), mesh)[0]
    out["same"] = all(
        (again[k] == first[k]) if k == "metrics" else
        (sorted(again[k]) == sorted(first[k]) and all(
            np.array_equal(again[k][n], first[k][n]) for n in first[k]))
        for k in ("metrics", "grads", "params", "buffers"))
    return out


def _run_checkpoint(live, mesh, root):
    """The tri state after its steps: the collective save, the reload into
    the two ranks (bit for bit), the gathered state for the parent's
    unsharded load, and save_best_sharded twice."""
    from vitlens_tpu_torch.parallel import fsdp as F
    from vitlens_tpu_torch.train import checkpoint as C

    model, _, _, state, _, _ = live
    path = C.save_checkpoint_sharded(root, state, 1, extra={"k": 1})
    keep = {n: F.local_tensor(p).detach().clone()
            for n, p in model.named_parameters()}
    keep_m = {(k, n): F.local_tensor(t).clone() for k in ("mu", "nu")
              for n, t in state.opt_state[k].items()}
    gathered = {"params": _gathered(model),
                "mu": {n: F.full_tensor(t).numpy().copy()
                       for n, t in state.opt_state["mu"].items()},
                "nu": {n: F.full_tensor(t).numpy().copy()
                       for n, t in state.opt_state["nu"].items()},
                "count": state.opt_state["count"], "step": state.step}
    with torch.no_grad():
        for p in model.parameters():
            F.local_tensor(p).fill_(float("nan"))
        for k in ("mu", "nu"):
            for t in state.opt_state[k].values():
                F.local_tensor(t).fill_(float("nan"))
    state.step, state.opt_state["count"] = 0, 0
    C.load_checkpoint_sharded(path, state)
    reloaded = (
        all(torch.equal(F.local_tensor(p), keep[n])
            for n, p in model.named_parameters())
        and all(torch.equal(F.local_tensor(t), keep_m[(k, n)])
                for k in ("mu", "nu") for n, t in state.opt_state[k].items())
        and (state.step, state.opt_state["count"]) == (
            gathered["step"], gathered["count"]))
    best = [C.save_best_sharded(root, state, 1, 0.5),
            C.save_best_sharded(root, state, 2, 0.25)]
    return {"path": path, "reloaded": reloaded, "best": best,
            "gathered": gathered if mesh.rank == 0 else None}


def _fake_eval_ds(cfg, n=7):
    """An EEG val set of ``n`` samples (test_torch_parallel_cli.py's)."""
    e = cfg.tower.eeg
    rng = np.random.RandomState(0)
    data = rng.randn(n, e.chans, e.time_len).astype(np.float32)

    class FakeDS:
        eval_metric = "acc"
        classnames = ["alpha", "beta"]
        templates = ["a photo of {}."]

        def __len__(self):
            return n

        def __getitem__(self, i):
            return {"id": i, "eeg": data[i], "label": i % 2}

    return FakeDS()


def _run_cli(argv_train, argv_resume):
    from vitlens_tpu_torch.cli import train as T

    saved = T._build_real_dataset
    T._build_real_dataset = lambda args, spec, train, cfg=None: _fake_eval_ds(cfg)
    try:
        return [T.main(argv_train), T.main(argv_resume)]
    finally:
        T._build_real_dataset = saved


def _worker(plan_path, out_dir) -> int:
    torch.set_num_threads(2)
    from vitlens_tpu_torch.parallel import fsdp as F
    from vitlens_tpu_torch.parallel.mesh import init_distributed, make_mesh

    rank = init_distributed(device="cpu", timeout_s=120)
    mesh = make_mesh()
    assert (mesh.data, mesh.rank, mesh.backend) == (WORLD, rank, "gloo")
    with open(plan_path, "rb") as f:
        plan = pickle.load(f)
    res = {"steps": {}}
    for name, case in plan["steps"].items():
        res["steps"][name], live = _run_step(case, mesh)
        if name == "pc_gen":
            res["gen"] = _run_generator_case(case, mesh, res["steps"][name])
        if name == "tri":  # a second step, then the checkpoint
            model, _, _, state, step, batch = live
            state, m = step(state, batch)
            res["second"] = {"metrics": {k: float(v) for k, v in m.items()},
                             "placed": F.placements_of(state),
                             "params": _gathered(model)}
            res["ckpt"] = _run_checkpoint(live, mesh, plan["ckpt_root"])
        if name == "lora":
            res["ckpt_lora"] = _run_checkpoint(live, mesh,
                                               plan["ckpt_root_lora"])
    res["cli"] = _run_cli(plan["cli_train"], plan["cli_resume"])
    res["cli_lora"] = _run_cli(plan["cli_lora_train"], plan["cli_lora_resume"])
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_worker(*sys.argv[1:]))


# ---------------------------------------------------------------------------
# the parent: plan, JAX's results, comparisons
# ---------------------------------------------------------------------------


def _stash():
    """An optax transformation that keeps the gradients it is given as its
    state, each at its parameter's shape (a frozen leaf's scalar zero
    broadcast), so that the FSDP step's pinned state shardings hold."""
    import jax
    import jax.numpy as jnp
    import optax

    def update(g, s, p=None):
        return g, jax.tree.map(lambda a, b: jnp.broadcast_to(a, b.shape)
                               .astype(b.dtype), g, s)

    return optax.GradientTransformation(lambda p: p, update)


def _jax_mesh():
    from jax.sharding import Mesh

    from tests.conftest import cpu_devices

    return Mesh(np.array(cpu_devices()[:WORLD]), ("data",))


def _with_lora(params, ranks, seed=17):
    """JAX's params with a ``"lora"`` subtree on each tower of ``ranks``
    ({tower: rank}): the tree JAX's ``lora_init`` lays out (the default
    targets, stacked [L, in, r] ``a`` and [L, r, out] ``b``, scale = alpha
    / r at alpha twice the rank), drawn with numpy, ``b`` away from its zero
    init (a trained adapter: ``a``'s gradient is zero while ``b`` is)."""
    from vitlens_tpu.train.lora import DEFAULT_TARGETS

    params = dict(params)
    for i, (tower, rank) in enumerate(ranks.items()):
        rng = np.random.RandomState(seed + i)
        tree = {}
        for target in DEFAULT_TARGETS:
            path = target.split(".")
            w, node = params[tower]["trunk"]["blocks"], tree
            for k in path:
                w = w[k]
            for k in path[:-1]:
                node = node.setdefault(k, {})
            layers, fan_in, fan_out = w.shape
            node[path[-1]] = {
                "a": (rng.randn(layers, fan_in, rank) * rank ** -0.5
                      ).astype(np.float32),
                "b": (0.05 * rng.randn(layers, rank, fan_out)).astype(np.float32)}
        params[tower] = dict(params[tower], lora={
            "scale": np.float32(2.0), "trunk": {"blocks": tree}})
    return params


def _lora_ranks(params):
    """{tower: LoRA rank} of the towers of a JAX tree that carry one."""
    return {t: int(params[t]["lora"]["trunk"]["blocks"]["attn"]["qkv_w"]["a"]
                   .shape[-1]) for t in ("visual", "text") if "lora" in params[t]}


def _jax_mask(params, jcfg, flags):
    """JAX's trainability mask of a case: None (every leaf) without flags,
    else the lock flags' tri_model_mask; a tower that carries LoRA factors
    takes its lora_mask (the factors alone), as cli.train --lora-rank
    sets it."""
    from vitlens_tpu.train import freeze as JF
    from vitlens_tpu.train.lora import lora_mask

    if flags is None:
        return None
    mask = dict(JF.tri_model_mask(params, jcfg, **flags))
    for tower in _lora_ranks(params):
        mask[tower] = lora_mask(params[tower])
    return mask


def _cases():
    """{name: (JAX config, port config, JAX params, JAX state, mask flags,
    StepConfig fields, batch, FPS key, optimizer fields)}: the tri step on
    JAX's tiny model with every parameter trained, its accum_freq-2 twin
    with image and text locked (tests/test_fsdp.py's), the LoRA step (rank
    4 on the visual trunk, rank 1 on the text trunk, every tower locked:
    the factors and the logit scale train) and the pc tri step
    with BatchNorm, at accum_freq 1 and 2. The pc step's AdamW takes eps
    1e-4, as
    tests/test_torch_parallel.py's: at 1e-6 the biases a batch-statistics
    BatchNorm cancels, whose gradient is fp32 rounding noise, move by about
    lr either way on each side."""
    import jax

    from tests.test_torch_parallel import _step_batch
    from tests.test_torch_pc_train import SMALL, _without_cancelled_biases
    from tests.test_train_step import tiny_batch, tiny_model_cfg
    from vitlens_tpu import config as JC
    from vitlens_tpu.models import tri as JT
    from vitlens_tpu_torch import config as PC

    jcfg = tiny_model_cfg()
    assert jcfg == _tiny(JC)
    pjc = JC.make_model_config("ViT-Tiny-Test", "pc",
                               point=JC.PointAdapterConfig(**SMALL, knn_exact=True))
    ppc = PC.make_model_config("ViT-Tiny-Test", "pc",
                               point=PC.PointAdapterConfig(**SMALL))
    with ThreadPoolExecutor(2) as pool:  # two compiles at once
        inits = [pool.submit(JT.tri_model_init, jax.random.PRNGKey(k), c)
                 for k, c in ((0, jcfg), (3, pjc))]
        (params, state), (pp, ps) = [f.result() for f in inits]
    out = {
        "tri": (jcfg, _tiny(PC), params, state, None, {},
                tiny_batch(np.random.RandomState(1), B), None, OPT),
        "accum2": (jcfg, _tiny(PC), params, state,
                   dict(lock_image=True, lock_text=True), dict(accum_freq=2),
                   tiny_batch(np.random.RandomState(3), 16), None, OPT),
        "lora": (jcfg, _tiny(PC), _with_lora(params, {"visual": 4, "text": 1}),
                 state, dict(lock_image=True, lock_text=True,
                             lock_visual=True), {},
                 tiny_batch(np.random.RandomState(7), B), None, OPT)}
    pp["visual"]["adapter"] = _without_cancelled_biases(pp["visual"]["adapter"])
    pc_flags = dict(lock_image=True, lock_text=True, lock_visual=True)
    out["pc_bn"] = (pjc, ppc, pp, ps, pc_flags, {},
                    _step_batch("pc", 23, 0, False, B),
                    jax.random.PRNGKey(40), dict(OPT, eps=1e-4))
    out["pc_accum2"] = (pjc, ppc, pp, ps, pc_flags, dict(accum_freq=2),
                        _step_batch("pc", 29, 0, False, 2 * B),
                        jax.random.PRNGKey(41), dict(OPT, eps=1e-4))
    return out


def _plans(cases, root):
    """What the ranks run: each case's port weights (JAX's init carried
    over), mask, step fields, global batch and global FPS starts; the
    checkpoint root and the trainer's two runs; the pc_gen case (no JAX
    counterpart) is pc_accum2 with a generator in place of the starts."""
    import jax

    from tests.test_torch_train import _per_param
    from vitlens_tpu.train.freeze import ones_like_mask
    from vitlens_tpu_torch.weights.from_jax import load_state, load_tri_params

    steps = {}
    for name, (jcfg, pcfg, params, state, flags, step_kw, batch, key,
               opt) in cases.items():
        plan = {"pcfg": pcfg, "lora": _lora_ranks(params)}
        model = load_tri_params(_unloaded(plan), params)
        load_state(model, state)
        jmask = (ones_like_mask(params) if flags is None
                 else _jax_mask(params, jcfg, flags))
        plan.update({"state_dict": model.state_dict(),
                     "mask": _per_param(jmask, params), "batch": batch,
                     "opt": opt, "step": dict(n_tower=3,
                                              compute_dtype=torch.float32,
                                              sync_bn=False, **step_kw)})
        if key is not None:  # JAX's global step draws for the global batch,
            # micro-batch i from its key folded with i
            A, n = step_kw.get("accum_freq", 1), len(batch["text"])
            keys = [key] if A == 1 else [jax.random.fold_in(key, i)
                                         for i in range(A)]
            plan["starts"] = [torch.from_numpy(np.array(
                jax.random.randint(k, (n // A,), 0, 256))) for k in keys]
        steps[name] = plan
    steps["pc_gen"] = dict(steps["pc_accum2"], gen_seed=GEN_SEED)
    del steps["pc_gen"]["starts"]
    steps["bf16_remat"] = dict(steps["tri"], step=dict(
        n_tower=3, compute_dtype=torch.bfloat16, remat=True, sync_bn=False))
    cli = ["--modality", "eeg", "--model", "ViT-Tiny-Test", "--device", "cpu",
           "--precision", "fp32", "--n-tower", "2", "--align-to", "text",
           "--unlock-cls", "--batch-size", "2", "--warmup", "1",
           "--log-every-n-steps", "1", "--workers", "1", "--dataset-type",
           "synthetic", "--train-data", "synthetic", "--train-num-samples",
           "8", "--val-data", "fake", "--fsdp", "--logs", str(root / "cli"),
           "--name", "run"]
    lora = cli[:-1] + ["lora", "--lora-rank", "4"]
    return {"steps": steps, "ckpt_root": str(root / "ckpt"),
            "ckpt_root_lora": str(root / "ckpt_lora"),
            "cli_train": cli + ["--epochs", "1"],
            "cli_resume": cli + ["--epochs", "2", "--resume", "latest"],
            "cli_lora_train": lora + ["--epochs", "1"],
            "cli_lora_resume": lora + ["--epochs", "2", "--resume", "latest"]}


def _jax_steps(cases):
    """{name: (TrainState after the step, gradients, metrics, placed
    specs)} of JAX's FSDP step over two devices, the cases compiled in
    threads of their own (XLA's compiler releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    mesh = _jax_mesh()
    with ThreadPoolExecutor(len(cases)) as pool:
        futures = {name: pool.submit(_jax_step, mesh, *case)
                   for name, case in cases.items()}
        return {name: f.result() for name, f in futures.items()}


def _jax_step(mesh, jcfg, _, params, state, flags, step_kw, batch, key, opt):
    import jax
    import jax.numpy as jnp
    import optax

    from vitlens_tpu.parallel.fsdp import fsdp_place
    from vitlens_tpu.train import step as JStep

    jtx, jmask = JStep.make_optimizer(params, JStep.OptimizerConfig(**opt),
                                      _jax_mask(params, jcfg, flags))
    tx = optax.chain(_stash(), jtx)
    jstep = JStep.make_train_step(jcfg, tx, jmask, JStep.StepConfig(
        n_tower=3, local_loss=False, compute_dtype=jnp.float32,
        sync_bn=False, **step_kw), mesh=mesh, partition="fsdp")
    ts = fsdp_place(JStep.init_train_state(params, state, tx), mesh,
                    min_elems=MIN_ELEMS)
    specs = jax.tree.map(lambda l: l.sharding.spec, ts.params)
    ts, jm = jstep(ts, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    ts = jax.device_get(ts)
    grads = jax.tree.map(lambda g, p: np.broadcast_to(g, np.shape(p)),
                         ts.opt_state[0], ts.params)
    return ts, grads, jax.device_get(jm), specs, params


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Writes the plan, starts the ranks, computes JAX's results while they
    run, and returns (plan, JAX's results, [rank 0's, rank 1's], root)."""
    root = tmp_path_factory.mktemp("fsdp")
    cases = _cases()
    plan = _plans(cases, root)
    with open(root / "plan.pkl", "wb") as f:
        pickle.dump(plan, f)
    ranks = start_ranks([sys.executable, os.path.abspath(__file__),
                         str(root / "plan.pkl"), str(root)], str(root / "logs"))
    try:
        jax_out = _jax_steps(cases)
    finally:
        wait_ranks(*ranks)
    got = []
    for r in range(WORLD):
        with open(root / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return plan, jax_out, got, root


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1e-12, np.abs(want).max())


# -- the rule -----------------------------------------------------------------


@pytest.mark.parametrize("shape,n", [((1024, 4096), 8), ((4096, 1024), 8),
                                     ((24, 4096, 1024), 8), ((1023, 17), 8),
                                     ((64,), 8), ((), 8), ((6, 4, 4), 2)])
def test_fsdp_spec_matches_jax(shape, n):
    """The port's axis is the one JAX's spec shards (tests/test_fsdp.py's
    cases, and a tie: the first of equal axes)."""
    from vitlens_tpu.parallel.fsdp import fsdp_spec as jax_spec
    from vitlens_tpu_torch.parallel.fsdp import fsdp_spec

    spec = tuple(jax_spec(shape, n))
    want = spec.index("data") if "data" in spec else None
    assert fsdp_spec(shape, n) == want


def _jax_axes(specs, params):
    """{port name: the axis JAX shards of that parameter (a stacked leaf's
    row: less the layer axis), or None}."""
    import jax

    from vitlens_tpu_torch.weights.from_jax import flatten

    code = jax.tree.map(
        lambda s, p: np.full(np.shape(p), tuple(s).index("data")
                             if "data" in tuple(s) else -1),
        specs, params, is_leaf=lambda x: isinstance(x, tuple))
    nd = jax.tree.map(lambda p: np.full(np.shape(p), np.ndim(p)), params)
    axes, ndims = flatten(code), flatten(nd)
    out = {}
    for name, c in axes.items():
        a = int(c.flat[0])
        out[name] = None if a < 0 else a - (int(ndims[name].flat[0]) - c.ndim)
    return out


def test_placement_matches_jax_leaf_by_leaf(run):
    """Every parameter of the tiny tri model is sharded on the axis JAX's
    fsdp_place shards of its leaf (min_elems 128), on both ranks; the local
    shard holds its share of that axis; the moments follow their
    parameters."""
    from vitlens_tpu_torch.models.tri import TriModel
    from vitlens_tpu_torch.parallel.fsdp import param_axes

    plan, jax_out, got, _ = run
    _, _, _, specs, params = jax_out["tri"]
    want = _jax_axes(specs, params)
    sd = plan["steps"]["tri"]["state_dict"]
    shapes = {n: tuple(t.shape) for n, t in sd.items() if n in want}
    assert sorted(shapes) == sorted(want)
    assert sum(a is not None for a in want.values()) > 10
    model = TriModel(plan["steps"]["tri"]["pcfg"], device="meta")
    assert param_axes(model, WORLD, MIN_ELEMS) == want
    from torch.distributed.tensor import Shard

    shards = {n: None if a is None else Shard(a) for n, a in want.items()}
    for res in got:
        placed, local = res["steps"]["tri"]["placed"], res["steps"]["tri"]["local"]
        assert placed["params"] == shards
        assert placed["mu"] == placed["nu"] == shards  # every parameter trains
        for n, shape in shapes.items():
            a = want[n]
            exp = shape if a is None else (
                shape[:a] + (shape[a] // WORLD,) + shape[a + 1:])
            assert local[n] == exp, n


def test_placements_stay_over_two_steps(run):
    """After a second step the parameters' and the moments' placements are
    the placed ones; both ranks' gathered parameters and metrics agree."""
    _, _, got, _ = run
    for res in got:
        assert res["second"]["placed"] == res["steps"]["tri"]["placed"]
    a, b = got[0]["second"], got[1]["second"]
    assert a["metrics"] == b["metrics"] and np.isfinite(a["metrics"]["loss"])
    for n, p in a["params"].items():
        np.testing.assert_array_equal(b["params"][n], p, err_msg=n)


# -- the step -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["tri", "accum2", "pc_bn", "pc_accum2",
                                  "lora"])
def test_fsdp_step_matches_jax(run, name):
    """Loss and grad_norm 1e-5 relative (grad_norm is the global norm: a
    rank-local one, or gradients taken with autograd.grad, fail it); each
    trainable gradient before AdamW 1e-5 of its max|ref|; the parameters
    after the step 5e-5 absolute and equal on both ranks; the BatchNorm
    running statistics 1e-5 relative (JAX's global-batch moments, with
    sync_bn off; at accum_freq 2 those of JAX's micro-batches, contiguous
    slices of the global batch). The biases a batch-statistics BatchNorm cancels have a
    gradient that is rounding noise on both sides (held below 1e-5 of their
    weight's gradient, as tests/test_torch_parallel.py holds them)."""
    from tests.test_torch_pc_train import CANCELLED
    from vitlens_tpu_torch.weights.from_jax import flatten

    _, jax_out, got, _ = run
    ts, jgrads, jm, _, _ = jax_out[name]
    res = [r["steps"][name] for r in got]
    for k in ("loss", "grad_norm", "logit_scale"):
        assert _rel(res[0]["metrics"][k], jm[k]) < 1e-5, k
        assert res[1]["metrics"][k] == res[0]["metrics"][k], k
    want_g, want_p = flatten(jgrads), flatten(ts.params)
    assert res[0]["grads"] and sorted(res[0]["grads"]) == sorted(res[0]["params"])
    cancelled = tuple(f"adapter.encoder.{c}.b" for c in CANCELLED)
    for n, g in res[0]["grads"].items():
        if n.endswith(cancelled):
            scale = np.abs(want_g[n[:-1] + "w"]).max()
            assert max(np.abs(g).max(), np.abs(want_g[n]).max()) < 1e-5 * scale, n
        else:
            assert _rel(g, want_g[n]) < 1e-5, n
        np.testing.assert_allclose(res[0]["params"][n], want_p[n], rtol=0,
                                   atol=5e-5, err_msg=n)
        np.testing.assert_array_equal(res[1]["params"][n], res[0]["params"][n])
    bufs = res[0]["buffers"]
    pc = name.startswith("pc")
    want_s = flatten(ts.model_state) if pc else {}
    assert sorted(want_s) == sorted(bufs)
    assert len(bufs) == (4 if pc else 0)
    for n, w in want_s.items():
        assert _rel(bufs[n], w) < 1e-5, n
        np.testing.assert_array_equal(res[1]["buffers"][n], bufs[n])


@pytest.mark.parametrize("draw", ["fps", "patch", "step"])
def test_fsdp_step_draws_one_global_draw(run, draw):
    """With a generator seeded alike on both ranks, each rank's FPS starts
    and patch dropout (accum_freq 2) are its rows of the draw one process
    makes for the global batch, and the pc step that draws them itself
    equals, bit for bit, the step given that global draw."""
    _, _, got, _ = run
    key = "same" if draw == "step" else draw
    assert [r["gen"][key] for r in got] == [True, True]


def test_fsdp_step_bf16_remat_finite(run):
    """bf16 compute with remat through the plain kernels on the CPU: finite
    loss and grad_norm, equal on both ranks, near the fp32 step's."""
    _, _, got, _ = run
    m = [r["steps"]["bf16_remat"]["metrics"] for r in got]
    assert m[0] == m[1]
    assert np.isfinite(m[0]["loss"]) and np.isfinite(m[0]["grad_norm"])
    assert _rel(m[0]["loss"], got[0]["steps"]["tri"]["metrics"]["loss"]) < 5e-2


# -- the checkpoint -----------------------------------------------------------


def test_collective_checkpoint_round_trips(run):
    """meta.json says sharded, latest.json points at the checkpoint; the
    reload into the two ranks is bit for bit; a load into one process (no
    process group, an unplaced state) equals the gathered state bit for
    bit; save_best_sharded agrees on both ranks (an improvement saves, a
    worse metric does not) and keeps best.json."""
    from vitlens_tpu_torch.train import checkpoint as C

    plan, _, got, _ = run
    ck = [r["ckpt"] for r in got]
    root = plan["ckpt_root"]
    path = ck[0]["path"]
    assert ck[1]["path"] == path and all(c["reloaded"] for c in ck)
    assert C.load_meta(path) == {"epoch": 1, "extra": {"k": 1}, "sharded": True}
    with open(os.path.join(root, "latest.json")) as f:
        assert json.load(f) == {"tag": "epoch_1"}
    assert not os.path.exists(os.path.join(root, "epoch_latest"))
    assert C.get_latest_checkpoint(root) == path
    assert ck[0]["best"] == ck[1]["best"] == [
        os.path.join(root, "checkpoint_best"), None]
    with open(os.path.join(root, "best.json")) as f:
        assert json.load(f) == {"metric": 0.5, "epoch": 1}
    _, _, _, state = _state(plan["steps"]["tri"])
    C.load_checkpoint_sharded(path, state)
    g = ck[0]["gathered"]
    for n, p in state.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), g["params"][n], err_msg=n)
    for k in ("mu", "nu"):
        assert sorted(state.opt_state[k]) == sorted(g[k])
        for n, t in state.opt_state[k].items():
            np.testing.assert_array_equal(t.numpy(), g[k][n], err_msg=n)
    assert (state.step, state.opt_state["count"]) == (g["step"], g["count"]) == (2, 2)


def test_sharded_checkpoint_keeps_the_port_tree(run):
    """The checkpoint holds the port's tree ({params, model_state,
    opt_state, step}); ckpt_only restores the weights alone."""
    from vitlens_tpu_torch.train import checkpoint as C

    plan, _, got, _ = run
    _, _, _, state = _state(plan["steps"]["tri"])
    C.load_checkpoint_sharded(got[0]["ckpt"]["path"], state, ckpt_only=True)
    assert (state.step, state.opt_state["count"]) == (0, 0)
    g = got[0]["ckpt"]["gathered"]
    for n, p in state.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), g["params"][n], err_msg=n)
    assert all(not t.any() for t in state.opt_state["mu"].values())
    import torch.distributed.checkpoint as dcp

    meta = dcp.FileSystemReader(got[0]["ckpt"]["path"]).read_metadata()
    tops = {k.split(".")[0] for k in meta.state_dict_metadata}
    assert tops == {"params", "opt_state", "step"}  # this model has no buffers


# -- the trainer --------------------------------------------------------------


def test_cli_train_fsdp_saves_and_resumes(run):
    """cli.train --fsdp over two gloo ranks: one epoch with the eval (7
    samples, batches of 3: a padded call on every batch) and a collective
    epoch save; a second run resumes from it after the placement, trains
    epoch 2 and saves again. Rank 0 logs both."""
    _, _, got, root = run
    assert [r["cli"] for r in got] == [[0, 0], [0, 0]]
    run_dir = root / "cli" / "run"
    ck = run_dir / "checkpoints"
    with open(ck / "latest.json") as f:
        assert json.load(f) == {"tag": "epoch_2"}
    for e in (1, 2):
        with open(ck / f"epoch_{e}" / "meta.json") as f:
            meta = json.load(f)
        assert meta["sharded"] and meta["epoch"] == e
    assert (ck / "checkpoint_best").is_dir()
    log = open(run_dir / "out.log").read()
    assert f"resumed (sharded) from {ck / 'epoch_1'} (epoch 1)" in log
    with open(run_dir / "results.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert sum("val/primary" in r for r in recs) == 2
    assert all(np.isfinite(r["train/loss"]) for r in recs if "train/loss" in r)


# -- LoRA under FSDP ------------------------------------------------------------


def test_lora_placements_match_jax_leaf_by_leaf(run):
    """The LoRA state: every parameter, the factors included, is sharded on
    the axis JAX's fsdp_place shards of its leaf (a factor's row of JAX's
    stacked [L, in, r] / [L, r, out] leaf), on both ranks, with its share
    of that axis local; the rank-4 factors of the visual trunk all shard,
    some rank-1 text factors stay whole (under min_elems); the moments are
    the trained names' alone and follow their parameters."""
    from torch.distributed.tensor import Shard

    from vitlens_tpu_torch.parallel.fsdp import param_axes

    plan, jax_out, got, _ = run
    _, _, _, specs, params = jax_out["lora"]
    want = _jax_axes(specs, params)
    case = plan["steps"]["lora"]
    factors = [n for n in want if ".lora." in n and n.endswith((".a", ".b"))]
    assert len(factors) == 2 * 2 * 4 * 2
    assert all(want[n] is not None for n in factors if n.startswith("visual."))
    assert any(want[n] is None for n in factors if n.startswith("text."))
    assert want["visual.lora.trunk.blocks.0.attn.qkv_w.a"] == 0  # in
    assert want["visual.lora.trunk.blocks.0.attn.qkv_w.b"] == 1  # out
    model = _unloaded(case)
    assert param_axes(model, WORLD, MIN_ELEMS) == want
    shards = {n: None if a is None else Shard(a) for n, a in want.items()}
    trained = sorted(n for n, t in case["mask"].items() if t)
    assert trained == sorted(factors + ["logit_scale"])
    shapes = {n: tuple(t.shape) for n, t in case["state_dict"].items()}
    for res in got:
        placed, local = res["steps"]["lora"]["placed"], res["steps"]["lora"]["local"]
        assert placed["params"] == shards
        assert sorted(placed["mu"]) == trained
        assert placed["mu"] == placed["nu"] == {n: shards[n] for n in trained}
        for n in factors:
            a, shape = want[n], shapes[n]
            assert local[n] == (shape if a is None else shape[:a] + (
                shape[a] // WORLD,) + shape[a + 1:]), n


def test_lora_step_trains_the_factors_alone(run):
    """After the FSDP LoRA step every base weight (and the scale) is
    bit-equal to the loaded one on both ranks, and every factor moved."""
    plan, _, got, _ = run
    sd = plan["steps"]["lora"]["state_dict"]
    for res in got:
        step = res["steps"]["lora"]
        assert step["frozen_moved"] == []
        moved = [n for n, a in step["params"].items()
                 if n != "logit_scale" and not np.array_equal(a, sd[n])]
        assert sorted(moved) == sorted(n for n in step["params"]
                                       if n != "logit_scale")


def test_lora_checkpoint_round_trips(run):
    """The collective checkpoint of the LoRA state reloads into the two
    ranks bit for bit, and a load into one process (an unplaced state with
    its factors attached) equals the gathered state, factors and their
    moments included."""
    from vitlens_tpu_torch.train import checkpoint as C

    plan, _, got, _ = run
    ck = [r["ckpt_lora"] for r in got]
    assert ck[0]["path"] == ck[1]["path"] and all(c["reloaded"] for c in ck)
    _, _, _, state = _state(plan["steps"]["lora"])
    C.load_checkpoint_sharded(ck[0]["path"], state)
    g = ck[0]["gathered"]
    assert any(".lora." in n for n in g["mu"])
    for n, p in state.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), g["params"][n], err_msg=n)
    for k in ("mu", "nu"):
        assert sorted(state.opt_state[k]) == sorted(g[k])
        for n, t in state.opt_state[k].items():
            np.testing.assert_array_equal(t.numpy(), g[k][n], err_msg=n)


def test_cli_train_fsdp_lora_saves_and_resumes(run):
    """cli.train --fsdp --lora-rank 4 over two gloo ranks: the epoch's
    collective checkpoint carries the factors; the second run resumes from
    it after the placement and saves epoch 2."""
    import torch.distributed.checkpoint as dcp

    _, _, got, root = run
    assert [r["cli_lora"] for r in got] == [[0, 0], [0, 0]]
    run_dir = root / "cli" / "lora"
    ck = run_dir / "checkpoints"
    with open(ck / "latest.json") as f:
        assert json.load(f) == {"tag": "epoch_2"}
    keys = dcp.FileSystemReader(str(ck / "epoch_2")).read_metadata().state_dict_metadata
    assert any(".lora.trunk.blocks.0.attn.qkv_w.a" in k for k in keys)
    log = open(run_dir / "out.log").read()
    assert f"resumed (sharded) from {ck / 'epoch_1'} (epoch 1)" in log
    with open(run_dir / "results.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert all(np.isfinite(r["train/loss"]) for r in recs if "train/loss" in r)
