"""The port's model axis (``parallel.tp``, ``parallel.sp``, the 2D state of
``parallel.fsdp.fsdp_tp_place`` and ``cli.train --tp``) over four gloo ranks
on the CPU, a ``[data 2, model 2]`` mesh, held against JAX on a [2, 2] mesh
of its virtual CPU devices, mirroring tests/test_tp.py, tests/test_sp.py,
tests/test_fsdp.py::test_fsdp_tp_2d_step_matches_single_device and
tests/test_cli.py::test_train_cli_synthetic_tp.

One set of four rank processes runs every case of this file: the parent
writes the weights and inputs (``plan.pkl``), each rank writes its results
(``rank{r}.pkl``), and the tests compare them with what JAX computes in the
parent meanwhile (its compiles in threads). A rank never imports jax. The
cases:

- the specs: the port's split axis of every parameter of test_tp.py's tower
  against JAX's ``vision_tower_specs``, every leaf covered;
- the TP forward: that tower split over the model axis, each data rank its
  rows, against JAX's sharded forward (rtol 2e-5, atol 1e-5, JAX's bar), and
  a tower of 3 heads (tp divides the packed qkv, not the heads: JAX's
  contiguous columns, gathered);
- SP alone and TP + SP on tests/test_sp.py's trunk (width 32, 2 heads, 3
  blocks) at N = 8, at N = 9 and at N = 9 with the causal mask: the forward
  against JAX's under ``sequence_sharded_activations``, every gradient
  against ``jax.grad`` of the unconstrained trunk, 1e-5 of max|ref|;
- the kernel routes, bf16 on the CPU (the wrappers' plain versions, called
  as the kernels would be): attention on the rank's heads under TP and on
  its query rows against every key under SP; the fused MLP on the rank's
  rows under SP alone and not at all under TP;
- the 2D step: one step after ``fsdp_tp_place(min_elems=128)`` on
  tests/test_fsdp.py's tiny model against JAX's: loss and grad_norm 1e-5
  relative, each gradient 1e-5 of its max|ref|, the parameters after the
  step 5e-5 absolute, the placements JAX's leaf by leaf;
- the collective checkpoint of that state: written whole in JAX's packed
  qkv layout, loaded into one process bit for bit, and resumed into the 2D
  state bit for bit;
- ``cli.train --tp 2`` with JAX's test flags and an eval set of 7 samples:
  rc 0 on every rank, the logged losses and the eval's metrics equal one
  process's run at twice the batch (1e-5 relative), the collective epoch
  checkpoint, and a second run that resumes from it after the 2D
  placement;
- LoRA on the split trunk: the 2D step of the tiny model with rank-4
  factors on the visual trunk (split over the model axis) and rank-1
  factors on the text trunk (FSDP alone), every tower locked, against
  JAX's ``fsdp_tp_place`` step on the tree carrying ``"lora"`` (the same
  bars; every base weight bit-equal after the step), its placements leaf
  by leaf (the factors whole over the model axis, FSDP over data) and its
  checkpoint; ``cli.train --tp 2 --lora-rank 4 --lora-towers visual,text``
  against one process's run and resumed.

Run this file as a script (``python tests/test_torch_tp.py PLAN OUT``,
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
from tests.test_torch_threads import share_cores  # noqa: E402

share_cores()

WORLD, N_DATA, N_MODEL = 4, 2, 2
MIN_ELEMS = 128
OPT = dict(lr=1e-3, warmup=1, total_steps=100)
DIM, HEADS, LAYERS = 32, 2, 3            # tests/test_sp.py's trunk
TRUNK_CASES = {"n8": (8, False), "n9": (9, False), "n9_causal": (9, True)}
TOWERS = {"tower": (64, 16), "heads3": (48, 16)}  # width, head width
LORA_FLAGS = ("--lora-rank", "4", "--lora-towers", "visual,text")


def _tower(C, width=64, head_width=16):
    """tests/test_tp.py's _tower, at ``width``, in either package's config
    module."""
    arch = C.VisionArch(image_size=28, patch_size=14, width=width, layers=2,
                        head_width=head_width)
    return C.TowerConfig(
        arch=arch, embed_dim=32, modality="eeg",
        eeg=C.EEGAdapterConfig(chans=8, time_len=16, window_size=1, stride=1),
        perceiver=C.PerceiverConfig(depth=1, num_latents=4, latent_dim=width,
                                    input_dim=width, cross_heads=1,
                                    cross_dim_head=16, latent_heads=2,
                                    latent_dim_head=32))


def _rows(x, d):
    b = x.shape[0] // N_DATA
    return x[d * b:(d + 1) * b]


# ---------------------------------------------------------------------------
# rank processes
# ---------------------------------------------------------------------------


class _Trunk(torch.nn.Module):
    """A bare Transformer as a tower (``shard_vision_tower`` splits
    ``trunk.blocks``)."""

    def __init__(self, trunk):
        super().__init__()
        self.trunk = trunk


def _whole_grads(model, mesh):
    """{name: gradient} summed over the data axis, a TP slice gathered
    whole."""
    from vitlens_tpu_torch.parallel.tp import gather_whole, split_params

    split = split_params(model)
    out = {}
    for n, p in model.named_parameters():
        g = p.grad.detach().clone()
        torch.distributed.all_reduce(g, group=mesh.group)
        out[n] = (gather_whole(n, g, split[n]) if n in split else g).numpy()
    return out


def _run_towers(plan, mesh):
    from vitlens_tpu_torch.models.vit import VisionTower
    from vitlens_tpu_torch.parallel.tp import shard_vision_tower

    out = {}
    for name, case in plan["towers"].items():
        tower = VisionTower(case["pcfg"], device="cpu")
        tower.load_state_dict(case["state_dict"])
        shard_vision_tower(tower, mesh)
        with torch.no_grad():
            out[name] = tower(torch.from_numpy(_rows(case["x"], mesh.rank))).numpy()
    return out


def _run_trunks(plan, mesh):
    """{(case, mode): (output rows, x's gradient rows, {name: gradient})}
    of the trunk split by sequence ("sp") or by both ("tpsp")."""
    from vitlens_tpu_torch.models.layers import Transformer
    from vitlens_tpu_torch.parallel.sp import sequence_sharded_activations
    from vitlens_tpu_torch.parallel.tp import shard_vision_tower

    out = {}
    for name, case in plan["trunks"].items():
        mask = None if case["mask"] is None else torch.from_numpy(case["mask"])
        for mode in ("sp", "tpsp"):
            trunk = Transformer(DIM, LAYERS, HEADS, device="cpu")
            trunk.load_state_dict(plan["trunk_state"])
            for p in trunk.parameters():
                p.requires_grad_(True)
            if mode == "tpsp":
                shard_vision_tower(_Trunk(trunk), mesh)
            x = torch.from_numpy(_rows(case["x"], mesh.rank)).requires_grad_(True)
            with sequence_sharded_activations(mesh):
                y = trunk(x, mask)
            (y * torch.from_numpy(_rows(case["ct"], mesh.rank))).sum().backward()
            out[name, mode] = (y.detach().numpy(), x.grad.numpy(),
                               _whole_grads(trunk, mesh))
    return out


def _run_routes(plan, mesh):
    """{mode: [(kernel, shapes)]} of the bf16 trunk's calls of the
    attention and fused-MLP wrappers (their plain versions on the CPU) at
    N = 9, for the whole trunk ("none") and split by heads ("tp"), by rows
    ("sp") and by both ("tpsp")."""
    from vitlens_tpu_torch.models import layers as L
    from vitlens_tpu_torch.ops import attention as A
    from vitlens_tpu_torch.parallel.sp import sequence_sharded_activations
    from vitlens_tpu_torch.parallel.tp import shard_vision_tower

    calls = []
    flash, mlp = A.flash_attention, L.fused_mlp

    def flash_rec(q, k, v, *a):
        calls.append(("attn", tuple(q.shape), tuple(k.shape)))
        return flash(q, k, v, *a)

    def mlp_rec(x, *a):
        calls.append(("mlp", tuple(x.shape)))
        return mlp(x, *a)

    A.flash_attention, L.fused_mlp = flash_rec, mlp_rec
    out = {}
    try:
        for mode in ("none", "tp", "sp", "tpsp"):
            trunk = L.Transformer(DIM, LAYERS, HEADS, device="cpu")
            trunk.load_state_dict(plan["trunk_state"])
            if "tp" in mode:
                shard_vision_tower(_Trunk(trunk), mesh)
            x = torch.from_numpy(_rows(plan["trunks"]["n9"]["x"], mesh.rank))
            del calls[:]
            with torch.no_grad():
                if "sp" in mode:
                    with sequence_sharded_activations(mesh):
                        trunk(x.bfloat16())
                else:
                    trunk(x.bfloat16())
            out[mode] = list(calls)
    finally:
        A.flash_attention, L.fused_mlp = flash, mlp
    return out


def _state(case, mesh=None):
    """(model, tx, mask, state) of the step case, 2D-placed over ``mesh``
    when given."""
    from tests.test_torch_fsdp import _model
    from vitlens_tpu_torch.factory import make_trainable_
    from vitlens_tpu_torch.parallel.fsdp import fsdp_tp_place
    from vitlens_tpu_torch.train import step as S

    model = _model(case)
    mask = case["mask"]
    tx, mask = S.make_optimizer(model, S.OptimizerConfig(**OPT), mask)
    make_trainable_(model, mask, torch.float32)
    state = S.init_train_state(model, tx)
    if mesh is not None:
        fsdp_tp_place(state, mesh, min_elems=MIN_ELEMS)
    return model, tx, mask, state


def _gathered(state):
    """The whole state, JAX's layout: FSDP shards and TP slices gathered."""
    from vitlens_tpu_torch.parallel.fsdp import full_tensor
    from vitlens_tpu_torch.parallel.tp import gather_whole, split_params

    split = split_params(state.model)

    def whole(n, t):
        return (gather_whole(n, t, split[n]) if n in split
                else full_tensor(t)).detach().float().numpy().copy()

    return {"params": {n: whole(n, p) for n, p in state.model.named_parameters()},
            "mu": {n: whole(n, t) for n, t in state.opt_state["mu"].items()},
            "nu": {n: whole(n, t) for n, t in state.opt_state["nu"].items()},
            "count": state.opt_state["count"], "step": state.step}


def _run_step(case, mesh, root):
    """One 2D step from JAX's weights on this data rank's rows, then the
    collective checkpoint: its reload into the ranks bit for bit."""
    from vitlens_tpu_torch.parallel import fsdp as F
    from vitlens_tpu_torch.parallel.tp import gather_whole, split_params
    from vitlens_tpu_torch.train import checkpoint as C
    from vitlens_tpu_torch.train import step as S

    model, tx, mask, state = _state(case, mesh)
    placed = F.placements_of(state)
    split = split_params(model)
    step = S.make_train_step(case["pcfg"], tx, mask, S.StepConfig(
        n_tower=3, local_loss=False, compute_dtype=torch.float32,
        sync_bn=False), mesh=mesh, partition="fsdp")
    grads, update = {}, tx.update_

    def grabbing(params, g, st, **kw):  # the averaged gradients, before AdamW
        grads.update({n: (gather_whole(n, t, split[n]) if n in split
                          else F.full_tensor(t)).detach().float().numpy().copy()
                      for n, t in g.items()})
        return update(params, g, st, **kw)

    tx.update_ = grabbing
    try:
        batch = {k: _rows(v, mesh.rank) for k, v in case["batch"].items()}
        state, m = step(state, batch)
    finally:
        del tx.update_
    out = {"metrics": {k: float(v) for k, v in m.items()}, "grads": grads,
           "placed": placed, "gathered": _gathered(state)}
    path = C.save_checkpoint_sharded(root, state, 1)
    keep = [F.local_tensor(t).detach().clone() for t in _live(state)]
    with torch.no_grad():
        for t in _live(state):
            F.local_tensor(t).fill_(float("nan"))
    state.step, state.opt_state["count"] = 0, 0
    C.load_checkpoint_sharded(path, state)
    out["reloaded"] = (
        all(torch.equal(F.local_tensor(t), k) for t, k in zip(_live(state), keep))
        and (state.step, state.opt_state["count"]) == (1, 1))
    out["path"] = path
    return out


def _live(state):
    return ([p for p in state.model.parameters()]
            + [t for m in ("mu", "nu") for t in state.opt_state[m].values()])


def _worker(plan_path, out_dir) -> int:
    from vitlens_tpu_torch.cli import train as T
    from vitlens_tpu_torch.models import layers as L
    from vitlens_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from vitlens_tpu_torch.parallel.sp import sequence_sharded_activations

    rank = init_distributed(device="cpu", timeout_s=120)
    mesh = make_mesh(n_model=N_MODEL)
    with open(plan_path, "rb") as f:
        plan = pickle.load(f)
    res = {"mesh": (mesh.data, mesh.model, mesh.rank, mesh.model_rank,
                    mesh.backend, torch.distributed.get_process_group_ranks(
                        mesh.group), torch.distributed.get_process_group_ranks(
                        mesh.model_group))}
    try:
        with sequence_sharded_activations(mesh):
            res["hook_set"] = L._ACTIVATION_CONSTRAINT is not None
            raise KeyError("inside")
    except KeyError:
        res["hook_reset"] = L._ACTIVATION_CONSTRAINT is None
    res["towers"] = _run_towers(plan, mesh)
    res["trunks"] = _run_trunks(plan, mesh)
    res["routes"] = _run_routes(plan, mesh)
    res["step"] = _run_step(plan["step"], mesh, plan["ckpt_root"])
    res["step_lora"] = _run_step(plan["step_lora"], mesh,
                                 plan["ckpt_root_lora"])
    res["cli"] = _run_cli(T, [plan["cli"], plan["cli_resume"]])
    res["cli_lora"] = _run_cli(T, [plan["cli_lora"], plan["cli_lora_resume"]])
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


def _run_cli(T, argvs):
    """cli.train's runs of ``argvs`` with tests/test_torch_fsdp.py's fake
    EEG eval set (7 samples) in place of a real one."""
    from tests.test_torch_fsdp import _fake_eval_ds

    saved = T._build_real_dataset
    T._build_real_dataset = lambda args, spec, train, cfg=None: _fake_eval_ds(cfg)
    try:
        return [T.main(argv) for argv in argvs]
    finally:
        T._build_real_dataset = saved


if __name__ == "__main__":
    sys.exit(_worker(*sys.argv[1:]))


# ---------------------------------------------------------------------------
# the parent: plan, JAX's results, comparisons
# ---------------------------------------------------------------------------


def _stash():
    """An optax transformation that keeps the gradients it is given as its
    state (tests/test_torch_fsdp.py's)."""
    import jax
    import jax.numpy as jnp
    import optax

    def update(g, s, p=None):
        return g, jax.tree.map(lambda a, b: jnp.broadcast_to(a, b.shape)
                               .astype(b.dtype), g, s)

    return optax.GradientTransformation(lambda p: p, update)


def _jax_mesh():
    from tests.conftest import cpu_devices
    from vitlens_tpu.parallel.mesh import make_mesh

    return make_mesh(n_data=N_DATA, n_model=N_MODEL, devices=cpu_devices()[:4])


def _jax_tower(jcfg, params, state, x):
    """JAX's TP forward (tests/test_tp.py's) and the tower's specs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vitlens_tpu.models.vit import vision_tower_apply
    from vitlens_tpu.parallel.tp import shard_vision_tower, vision_tower_specs

    mesh = _jax_mesh()
    sharded = shard_vision_tower(params, mesh)
    fwd = jax.jit(lambda p, v: vision_tower_apply(p, state, v, jcfg)[0])
    got = fwd(sharded, jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data"))))
    return np.asarray(got), vision_tower_specs(params)


def _jax_trunk(params, x, mask, ct):
    """JAX's trunk forward under sequence_sharded_activations, and the
    gradients of sum(y * ct) of the unconstrained trunk."""
    import jax
    import jax.numpy as jnp

    from vitlens_tpu.models.layers import gelu, transformer
    from vitlens_tpu.parallel.sp import sequence_sharded_activations

    m = None if mask is None else jnp.asarray(mask)
    f = lambda p, v: transformer(v, p, HEADS, gelu, m)  # noqa: E731
    with sequence_sharded_activations(_jax_mesh()):
        y = jax.jit(f)(params, jnp.asarray(x))
    gp, gx = jax.jit(jax.grad(lambda p, v: jnp.sum(f(p, v) * ct),
                              argnums=(0, 1)))(params, jnp.asarray(x))
    return np.asarray(y), jax.device_get(gp), np.asarray(gx)


def _jax_step(jcfg, params, state, batch, mask=None):
    """JAX's 2D step (tests/test_fsdp.py's) with its gradients kept;
    ``mask`` as ``make_optimizer``'s (None: every leaf trains)."""
    import jax
    import jax.numpy as jnp
    import optax

    from vitlens_tpu.parallel.fsdp import fsdp_tp_place
    from vitlens_tpu.train import step as JStep

    jtx, jmask = JStep.make_optimizer(params, JStep.OptimizerConfig(**OPT),
                                      mask)
    tx = optax.chain(_stash(), jtx)
    mesh = _jax_mesh()
    jstep = JStep.make_train_step(jcfg, tx, jmask, JStep.StepConfig(
        n_tower=3, local_loss=False, compute_dtype=jnp.float32,
        sync_bn=False), mesh=mesh, partition="fsdp")
    ts = fsdp_tp_place(JStep.init_train_state(params, state, tx), mesh,
                       min_elems=MIN_ELEMS)
    specs = jax.tree.map(lambda leaf: tuple(leaf.sharding.spec), ts.params)
    ts, jm = jstep(ts, {k: jnp.asarray(v) for k, v in batch.items()}, None)
    ts = jax.device_get(ts)
    grads = jax.tree.map(lambda g, p: np.broadcast_to(g, np.shape(p)),
                         ts.opt_state[0], ts.params)
    return ts, grads, jax.device_get(jm), specs


def _biased(trunk, seed):
    """A JAX trunk tree ({"blocks": ...}) with random qkv_b and out_b: JAX's
    init zeroes them, which would hide a bias added on every model rank or
    cut in the wrong order."""
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)
    attn = dict(trunk["blocks"]["attn"])
    for k in ("qkv_b", "out_b"):
        attn[k] = jnp.asarray(rng.randn(*attn[k].shape).astype(np.float32) * 0.02)
    return dict(trunk, blocks=dict(trunk["blocks"], attn=attn))


def _cli_argv(logs, name, batch, *more):
    """tests/test_cli.py::test_train_cli_synthetic_tp's flags, on the CPU,
    with an eval set."""
    return ["--modality", "eeg", "--model", "ViT-Tiny-Test", "--device", "cpu",
            "--dataset-type", "synthetic", "--train-data", "synthetic",
            "--train-num-samples", "8", "--batch-size", str(batch),
            "--warmup", "2", "--precision", "fp32", "--n-tower", "3",
            "--workers", "1", "--log-every-n-steps", "1", "--val-data",
            "fake", "--logs", str(logs), "--name", name, *more]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Writes the plan, starts the ranks, computes JAX's results and one
    process's CLI run while they run. Returns (plan, JAX's results, the
    ranks' results, root)."""
    import jax

    from tests.test_torch_fsdp import (_jax_mask, _lora_ranks, _unloaded,
                                       _with_lora)
    from tests.test_torch_train import _per_param
    from tests.test_train_step import tiny_batch, tiny_model_cfg
    from vitlens_tpu import config as JC
    from vitlens_tpu.models import tri as JT
    from vitlens_tpu.models.layers import transformer_init
    from vitlens_tpu.models.vit import vision_tower_init
    from vitlens_tpu.train.freeze import ones_like_mask
    from vitlens_tpu_torch import config as PC
    from vitlens_tpu_torch.models.layers import Transformer
    from vitlens_tpu_torch.models.tri import TriModel
    from vitlens_tpu_torch.models.vit import VisionTower
    from vitlens_tpu_torch.weights.from_jax import load_params, load_tri_params

    root = tmp_path_factory.mktemp("tp")
    plan = {"towers": {}, "trunks": {}, "ckpt_root": str(root / "ckpt"),
            "cli": _cli_argv(root / "cli", "tp", 2, "--tp", "2", "--epochs", "1"),
            "cli_resume": _cli_argv(root / "cli", "tp", 2, "--tp", "2",
                                    "--epochs", "2", "--resume", "latest"),
            "ckpt_root_lora": str(root / "ckpt_lora"),
            "cli_lora": _cli_argv(root / "cli", "lora", 2, "--tp", "2",
                                  "--epochs", "1", *LORA_FLAGS),
            "cli_lora_resume": _cli_argv(root / "cli", "lora", 2, "--tp", "2",
                                         "--epochs", "2", "--resume",
                                         "latest", *LORA_FLAGS)}
    jax_towers = {}
    for i, (name, (width, hw)) in enumerate(TOWERS.items()):
        jcfg, pcfg = _tower(JC, width, hw), _tower(PC, width, hw)
        p, s = vision_tower_init(jax.random.PRNGKey(i), jcfg)
        p = dict(p, trunk=_biased(p["trunk"], i))
        x = np.random.RandomState(i).randn(4, 8, 16).astype(np.float32)
        plan["towers"][name] = {"pcfg": pcfg, "x": x, "state_dict": load_params(
            VisionTower(pcfg, device="cpu"), p).state_dict()}
        jax_towers[name] = (jcfg, p, s, x)
    tp_params = _biased(transformer_init(jax.random.PRNGKey(0), DIM, LAYERS), 5)
    plan["trunk_state"] = load_params(
        Transformer(DIM, LAYERS, HEADS, device="cpu"), tp_params).state_dict()
    for i, (name, (n, causal)) in enumerate(TRUNK_CASES.items()):
        rng = np.random.RandomState(10 + i)
        plan["trunks"][name] = {
            "x": rng.randn(4, n, DIM).astype(np.float32),
            "ct": rng.randn(4, n, DIM).astype(np.float32),
            "mask": (np.triu(np.full((n, n), -np.inf, np.float32), 1)
                     if causal else None)}
    jcfg = tiny_model_cfg()
    params, state = JT.tri_model_init(jax.random.PRNGKey(0), jcfg)
    params = dict(params, visual=dict(
        params["visual"], trunk=_biased(params["visual"]["trunk"], 6)))
    model = load_tri_params(TriModel(_tiny(PC), device="cpu"), params)
    batch = tiny_batch(np.random.RandomState(5), 16)
    plan["step"] = {"pcfg": _tiny(PC), "state_dict": model.state_dict(),
                    "mask": _per_param(ones_like_mask(params), params),
                    "batch": batch}
    lparams = _with_lora(params, {"visual": 4, "text": 1})
    lmask = _jax_mask(lparams, jcfg, dict(lock_image=True, lock_text=True,
                                          lock_visual=True))
    lcase = {"pcfg": _tiny(PC), "lora": _lora_ranks(lparams)}
    lmodel = load_tri_params(_unloaded(lcase), lparams)
    lbatch = tiny_batch(np.random.RandomState(8), 16)
    plan["step_lora"] = dict(lcase, state_dict=lmodel.state_dict(),
                             mask=_per_param(lmask, lparams), batch=lbatch)
    with open(root / "plan.pkl", "wb") as f:
        pickle.dump(plan, f)
    ranks = start_ranks([sys.executable, os.path.abspath(__file__),
                         str(root / "plan.pkl"), str(root)], str(root / "logs"),
                        world=WORLD)
    try:
        with ThreadPoolExecutor(6) as pool:
            towers = {n: pool.submit(_jax_tower, c, p, s, x)
                      for n, (c, p, s, x) in jax_towers.items()}
            trunks = {n: pool.submit(_jax_trunk, tp_params, c["x"], c["mask"],
                                     c["ct"])
                      for n, c in plan["trunks"].items()}
            step = pool.submit(_jax_step, jcfg, params, state, batch)
            step_lora = pool.submit(_jax_step, jcfg, lparams, state, lbatch,
                                    lmask)
            from vitlens_tpu_torch.cli import train as T

            one = _run_cli(T, [_cli_argv(root / "one", "one", 4, "--epochs",
                                         "1")])
            one_lora = _run_cli(T, [_cli_argv(root / "one", "lora", 4,
                                              "--epochs", "1", *LORA_FLAGS)])
            jax_out = {"towers": {n: f.result() for n, f in towers.items()},
                       "trunks": {n: f.result() for n, f in trunks.items()},
                       "step": step.result(), "trunk_params": tp_params,
                       "tower_params": {n: v[1] for n, v in jax_towers.items()},
                       "step_params": params, "one": one,
                       "step_lora": step_lora.result(), "one_lora": one_lora,
                       "step_lora_params": lparams}
    finally:
        wait_ranks(*ranks)
    got = []
    for r in range(WORLD):
        with open(root / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return plan, jax_out, got, root


def _tiny(C):
    from tests.test_torch_fsdp import _tiny as tiny

    return tiny(C)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1e-12, np.abs(want).max())


def _port_axes(specs, params, axis_name):
    """{port name: the axis of ``axis_name`` in JAX's spec of that leaf (a
    stacked leaf's row: less the layer axis), or None}."""
    import jax

    from vitlens_tpu_torch.weights.from_jax import flatten

    code = jax.tree.map(
        lambda s, p: np.full(np.shape(p), tuple(s).index(axis_name)
                             if axis_name in tuple(s) else -1),
        specs, params, is_leaf=lambda x: isinstance(x, tuple))
    nd = jax.tree.map(lambda p: np.full(np.shape(p), np.ndim(p)), params)
    axes, ndims = flatten(code), flatten(nd)
    out = {}
    for name, c in axes.items():
        a = int(c.flat[0])
        out[name] = None if a < 0 else a - (int(ndims[name].flat[0]) - c.ndim)
    return out


# -- the mesh and the specs ---------------------------------------------------


def test_mesh_lays_ranks_out_as_jax(run):
    """Rank r is data row r // 2 and model column r % 2 (JAX's reshape of
    its devices, model innermost); the data axis's group is the ranks of
    its model column, the model axis's the ranks of its data row; the SP
    hook is set inside the context and reset on leaving it, even by an
    exception."""
    _, _, got, _ = run
    for r, res in enumerate(got):
        d, m = divmod(r, N_MODEL)
        assert res["mesh"] == (N_DATA, N_MODEL, d, m, "gloo",
                               [m, m + N_MODEL], [d * N_MODEL, d * N_MODEL + 1])
        assert res["hook_set"] and res["hook_reset"]


@pytest.mark.parametrize("name", list(TOWERS))
def test_specs_match_jax_leaf_by_leaf(run, name):
    """The port's split axis of every parameter of the tower is the one
    JAX's vision_tower_specs gives its leaf, and every leaf is covered."""
    from vitlens_tpu_torch.models.vit import VisionTower
    from vitlens_tpu_torch.parallel.tp import vision_tower_specs

    plan, jax_out, _, _ = run
    specs = jax_out["towers"][name][1]
    params = jax_out["tower_params"][name]
    want = _port_axes(specs, params, "model")
    got = vision_tower_specs(VisionTower(plan["towers"][name]["pcfg"],
                                         device="meta"))
    assert sorted(got) == sorted(want)
    assert got == want
    assert sum(a is not None for a in got.values()) == 2 * 6


# -- the forwards ---------------------------------------------------------------


@pytest.mark.parametrize("name", list(TOWERS))
def test_tp_forward_matches_jax(run, name):
    """Each data rank's rows of the split tower's output against JAX's
    sharded forward (rtol 2e-5, atol 1e-5), equal on the two model ranks
    of the row. "heads3" has 3 heads on 2 model ranks: JAX's contiguous
    qkv columns, gathered."""
    _, jax_out, got, _ = run
    want = jax_out["towers"][name][0]
    for r, res in enumerate(got):
        np.testing.assert_allclose(res["towers"][name], _rows(want, r // N_MODEL),
                                   rtol=2e-5, atol=1e-5)
        np.testing.assert_array_equal(res["towers"][name],
                                      got[r ^ 1]["towers"][name])


@pytest.mark.parametrize("mode", ["sp", "tpsp"])
@pytest.mark.parametrize("case", list(TRUNK_CASES))
def test_sp_trunk_matches_jax(run, case, mode):
    """SP alone and TP + SP: the trunk's output rows against JAX's under
    sequence_sharded_activations, and x's gradient rows and every
    parameter's gradient (summed over the data axis, a TP slice gathered
    whole) against jax.grad of the unconstrained trunk, 1e-5 of max|ref|;
    N = 9 pads to 10 rows (5 a rank), and the causal mask's rows start at
    each rank's first row."""
    from vitlens_tpu_torch.weights.from_jax import flatten

    _, jax_out, got, _ = run
    y, gp, gx = jax_out["trunks"][case]
    want_p = flatten(gp)
    for r, res in enumerate(got):
        oy, ogx, ogp = res["trunks"][case, mode]
        assert _rel(oy, _rows(y, r // N_MODEL)) < 1e-5
        assert _rel(ogx, _rows(gx, r // N_MODEL)) < 1e-5
        assert sorted(ogp) == sorted(want_p)
        for n, g in ogp.items():
            assert _rel(g, want_p[n]) < 1e-5, n


def test_kernel_routes(run):
    """bf16 (the kernels' dtype): the unsplit trunk calls attention on 2
    heads x 9 rows and the fused MLP on 2 x 9 rows a block; under TP
    attention takes the rank's 1 head and the MLP goes plain (JAX's TP
    trunk); under SP alone attention takes the rank's 5 query rows against
    all 9 keys and the fused MLP the rank's 2 x 5 rows; under TP + SP the
    rank's head on all 9 rows, the MLP plain."""
    _, _, got, _ = run
    attn = lambda h, nq, nk: ("attn", (2, h, nq, 16), (2, h, nk, 16))  # noqa: E731
    want = {"none": [attn(2, 9, 9), ("mlp", (18, DIM))] * LAYERS,
            "tp": [attn(1, 9, 9)] * LAYERS,
            "sp": [attn(2, 5, 9), ("mlp", (10, DIM))] * LAYERS,
            "tpsp": [attn(1, 9, 9)] * LAYERS}
    for res in got:
        assert res["routes"] == want


# -- the 2D step and its checkpoint --------------------------------------------


def test_fsdp_tp_placements_match_jax(run):
    """Every parameter and moment is placed as JAX's fsdp_tp_place places
    its leaf: the visual trunk's TP weights split over the model axis
    (whole over data), the rest FSDP over the data axis at min_elems 128
    or whole."""
    _check_2d_placements(run, "step")


def _check_2d_placements(run, key):
    """The placements of step case ``key`` against JAX's, leaf by leaf,
    on every rank, and ``fsdp_tp_shardings`` on an unplaced model."""
    from torch.distributed.tensor import Shard

    from tests.test_torch_fsdp import _unloaded
    from vitlens_tpu_torch.parallel.fsdp import fsdp_tp_shardings
    from vitlens_tpu_torch.parallel.mesh import Mesh

    plan, jax_out, got, _ = run
    _, _, _, specs = jax_out[key]
    params = jax_out[key + "_params"]
    model_axes = _port_axes(specs, params, "model")
    data_axes = _port_axes(specs, params, "data")
    want = {n: (("model", model_axes[n]) if model_axes[n] is not None else
                None if data_axes[n] is None else Shard(data_axes[n]))
            for n in model_axes}
    assert sum(isinstance(w, tuple) for w in want.values()) == 2 * 6
    assert sum(isinstance(w, Shard) for w in want.values()) > 10
    trained = sorted(n for n, t in plan[key]["mask"].items() if t)
    for res in got:
        placed = res[key]["placed"]
        assert placed["params"] == want
        assert sorted(placed["mu"]) == trained
        assert placed["mu"] == placed["nu"] == {n: want[n] for n in trained}
    rule = fsdp_tp_shardings(_unloaded(plan[key]),
                             Mesh(devices=(torch.device("cpu"),), data=N_DATA,
                                  model=N_MODEL), min_elems=MIN_ELEMS)
    assert rule == {n: None if w is None else w if isinstance(w, tuple)
                    else ("data", w.dim) for n, w in want.items()}
    return want


def test_fsdp_tp_step_matches_jax(run):
    """Loss and grad_norm 1e-5 relative (grad_norm counts each TP slice and
    each FSDP shard once), equal on all four ranks; each gradient before
    AdamW 1e-5 of its max|ref|; the parameters after the step 5e-5
    absolute (tests/test_fsdp.py's bar), equal on all four ranks."""
    _check_2d_step(run, "step")


def _check_2d_step(run, key):
    """Step case ``key`` against JAX's 2D step; returns the ranks'
    results."""
    from vitlens_tpu_torch.weights.from_jax import flatten

    _, jax_out, got, _ = run
    ts, jgrads, jm, _ = jax_out[key]
    res = [r[key] for r in got]
    for k in ("loss", "grad_norm", "logit_scale"):
        assert _rel(res[0]["metrics"][k], jm[k]) < 1e-5, k
        assert all(r["metrics"][k] == res[0]["metrics"][k] for r in res), k
    want_g, want_p = flatten(jgrads), flatten(ts.params)
    assert sorted(res[0]["grads"]) == sorted(
        n for n, t in run[0][key]["mask"].items() if t)
    for n, g in res[0]["grads"].items():
        assert _rel(g, want_g[n]) < 1e-5, n
    for n, p in res[0]["gathered"]["params"].items():
        np.testing.assert_allclose(p, want_p[n], rtol=0, atol=5e-5, err_msg=n)
        for r in res[1:]:
            np.testing.assert_array_equal(r["gathered"]["params"][n], p)
    return res


def test_tp_checkpoint_loads_whole_and_resumes(run):
    """The collective checkpoint of the 2D state reloads into the four
    ranks bit for bit; it holds JAX's layout: a load into one process (an
    unplaced state) equals the gathered state bit for bit."""
    from vitlens_tpu_torch.train import checkpoint as C

    plan, _, got, _ = run
    assert all(r["step"]["reloaded"] for r in got)
    path = got[0]["step"]["path"]
    assert all(r["step"]["path"] == path for r in got)
    assert C.load_meta(path) == {"epoch": 1, "extra": {}, "sharded": True}
    _, _, _, state = _state(plan["step"])
    C.load_checkpoint_sharded(path, state)
    g = got[0]["step"]["gathered"]
    for n, p in state.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), g["params"][n], err_msg=n)
    for k in ("mu", "nu"):
        for n, t in state.opt_state[k].items():
            np.testing.assert_array_equal(t.numpy(), g[k][n], err_msg=n)
    assert (state.step, state.opt_state["count"]) == (g["step"], g["count"]) == (1, 1)


# -- the trainer --------------------------------------------------------------


def test_cli_train_tp_matches_one_process(run):
    """cli.train --tp 2 over the four ranks ([data 2, model 2], batch 2 a
    data replica) returns 0 on every rank and logs the losses and the eval
    metrics of one process's run at --batch-size 4, 1e-5 relative; its
    epoch checkpoint is collective, and the second run resumes from it
    ("resumed (sharded) from"), trains epoch 2 and saves again."""
    _, jax_out, got, root = run
    assert [r["cli"] for r in got] == [[0, 0]] * WORLD and jax_out["one"] == [0]

    def records(run_dir, key):
        with open(run_dir / "results.jsonl") as f:
            return [json.loads(line) for line in f if key in line]

    run_dir = root / "cli" / "tp"
    tp, one = records(run_dir, "train/loss"), records(root / "one" / "one",
                                                      "train/loss")
    assert len(tp) == 4 and len(one) == 2
    for a, b in zip(tp, one):
        assert _rel(a["train/loss"], b["train/loss"]) < 1e-5
    assert all(np.isfinite(r["train/loss"]) for r in tp)
    val, val1 = records(run_dir, "val/primary"), records(root / "one" / "one",
                                                         "val/primary")
    assert len(val) == 2 and len(val1) == 1
    for k, v in val1[0].items():
        if k.startswith("val/"):
            assert _rel(val[0][k], v) < 1e-5, k
    ck = run_dir / "checkpoints"
    with open(ck / "latest.json") as f:
        assert json.load(f) == {"tag": "epoch_2"}
    for e in (1, 2):
        with open(ck / f"epoch_{e}" / "meta.json") as f:
            meta = json.load(f)
        assert meta["sharded"] and meta["epoch"] == e
    log = open(run_dir / "out.log").read()
    assert f"resumed (sharded) from {ck / 'epoch_1'} (epoch 1)" in log


# -- LoRA on the split trunk ----------------------------------------------------


def test_fsdp_tp_lora_placements_match_jax(run):
    """The LoRA state placed as JAX's fsdp_tp_place places the tree
    carrying "lora": the visual trunk's base weights split over the model
    axis, every factor (outside trunk.blocks) whole over the model axis
    and FSDP over data by JAX's rule on its stacked leaf (the visual
    rank-4 factors all sharded, some text rank-1 ones whole); the moments
    are the trained names' alone."""
    from torch.distributed.tensor import Shard

    want = _check_2d_placements(run, "step_lora")
    factors = {n: w for n, w in want.items()
               if ".lora." in n and n.endswith((".a", ".b"))}
    assert len(factors) == 2 * 2 * 4 * 2
    assert all(isinstance(w, Shard) for n, w in factors.items()
               if n.startswith("visual."))
    assert any(w is None for n, w in factors.items() if n.startswith("text."))


def test_fsdp_tp_lora_step_matches_jax(run):
    """The 2D LoRA step against JAX's (loss, grad_norm and logit_scale
    1e-5 relative, equal on all four ranks; each factor's gradient, summed
    over the model axis, 1e-5 of its max|ref|; the parameters after the
    step 5e-5 absolute); every base weight, the split ones gathered in
    JAX's layout, is bit-equal to the loaded one after the step, and every
    factor moved."""
    plan = run[0]
    res = _check_2d_step(run, "step_lora")
    sd, mask = plan["step_lora"]["state_dict"], plan["step_lora"]["mask"]
    for r in res:
        for n, p in r["gathered"]["params"].items():
            if not mask[n]:
                np.testing.assert_array_equal(p, sd[n].numpy(), err_msg=n)
            elif n != "logit_scale":
                assert not np.array_equal(p, sd[n].numpy()), n


def test_tp_lora_checkpoint_round_trips(run):
    """The LoRA 2D state's collective checkpoint reloads into the four
    ranks bit for bit and loads whole into one process (factors and their
    moments included)."""
    from vitlens_tpu_torch.train import checkpoint as C

    plan, _, got, _ = run
    assert all(r["step_lora"]["reloaded"] for r in got)
    _, _, _, state = _state(plan["step_lora"])
    C.load_checkpoint_sharded(got[0]["step_lora"]["path"], state)
    g = got[0]["step_lora"]["gathered"]
    assert any(".lora." in n for n in g["mu"])
    for n, p in state.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), g["params"][n], err_msg=n)
    for k in ("mu", "nu"):
        assert sorted(state.opt_state[k]) == sorted(g[k])
        for n, t in state.opt_state[k].items():
            np.testing.assert_array_equal(t.numpy(), g[k][n], err_msg=n)


def test_cli_train_tp_lora_matches_one_process(run):
    """cli.train --tp 2 --lora-rank 4 --lora-towers visual,text over the
    four ranks (the visual trunk split, its factors whole; the text tower
    FSDP alone) logs one process's losses at twice the batch, 1e-5
    relative, and the second run resumes from its collective checkpoint."""
    _, jax_out, got, root = run
    assert [r["cli_lora"] for r in got] == [[0, 0]] * WORLD
    assert jax_out["one_lora"] == [0]

    def records(run_dir):
        with open(run_dir / "results.jsonl") as f:
            return [json.loads(line) for line in f if "train/loss" in line]

    run_dir = root / "cli" / "lora"
    tp, one = records(run_dir), records(root / "one" / "lora")
    assert len(tp) == 4 and len(one) == 2
    for a, b in zip(tp, one):
        assert _rel(a["train/loss"], b["train/loss"]) < 1e-5
    ck = run_dir / "checkpoints"
    with open(ck / "latest.json") as f:
        assert json.load(f) == {"tag": "epoch_2"}
    log = open(run_dir / "out.log").read()
    assert f"resumed (sharded) from {ck / 'epoch_1'} (epoch 1)" in log
