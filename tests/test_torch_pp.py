"""The port's pipelining (``parallel.pp``, ``parallel.mesh.make_pipe_mesh``
and the ``pipelined_trunks`` hook of ``models.layers``) over four gloo
ranks on the CPU, on a ``[data 1, pipe 4]`` and a ``[data 2, pipe 2]`` mesh
of the one process group, held against JAX's ``parallel/pp.py`` on the same
layouts of its virtual CPU devices, mirroring tests/test_pp.py.

One set of four rank processes runs every case of this file: the parent
writes the weights and inputs (``plan.pkl``), each rank writes its results
(``rank{r}.pkl``), and the tests compare them with what JAX computes in the
parent meanwhile. A rank never imports jax. Each data rank takes its
contiguous rows of the batch (JAX's microbatches interleave the data shards
instead: the trunk is row-wise, so the rows compare one for one). The
cases, on each layout:

- the layout: rank r is data row r // S and stage r % S, as JAX's device
  array; the data axis's group is one stage's ranks, the pipe's one data
  row's; the hook is set inside ``pipelined_trunks`` and reset on leaving
  it, even by an exception; a placed trunk run outside the hook raises, and
  a TP-split tower is refused;
- the forward of test_pp.py's trunk (width 32, 2 heads, 4 blocks) at M = 4
  and 2 (B = 8), M = 3 (B = 6: M and S uneven) and M = 4 with a causal
  mask, against JAX's ``pipeline_transformer`` (rtol 2e-5, atol 1e-5);
- the gradient with remat (B = 4): the output, x's and every block's
  gradient against ``jax.grad`` of JAX's pipelined trunk, 1e-5 of max|ref|;
- ``tail_fn`` (a mean-pool and a product): the [B, 16] output and every
  gradient;
- the EEG tower of test_pp_full_tower_via_pipelined_trunks (2 trunk blocks
  on [data 2, pipe 2], 4 on [data 1, pipe 4]) after ``pipeline_place``
  under ``pipelined_trunks`` (M = 2), the 1-block Perceiver Lens plain:
  the features and every parameter's gradient (replicated ones equal on
  every rank of the pipe);
- that tower with 4 blocks and ``skip_first_n_layers`` 2: stage s holds and
  runs block 2 + s on 2 stages; on 4 stages the 2 blocks that run do not
  divide and the trunk runs whole, as in JAX;
- a 3-block trunk: ``shard_trunk_pipeline`` raises (JAX asserts), and under
  the hook it runs plain;
- the bf16 kernel routes through the wrappers' plain versions: attention
  and the fused MLP (L - skip) / S x M times a rank, at the microbatch's
  shapes;
- two trained towers, both pipelined (M = 2), in one backward: the EEG
  tower (4 blocks) and the causal text tower (4 blocks) under one
  ``pipelined_trunks``, a contrastive loss over the global batch (the
  features gathered over the data axis), every parameter trained, and
  again with rank-2 LoRA factors on both trunks (the factors alone
  trained), against ``jax.value_and_grad`` under JAX's
  ``pipelined_trunks`` (loss 1e-5 relative, each gradient 1e-5 of
  max|ref|; a factor's gradient from the stage that runs its block). The
  ranks write the other cases' results first and run these under a 45 s
  watchdog, so a hang fails these tests alone;
- ``pipeline_place`` refuses an FSDP-placed tower.

Run this file as a script (``python tests/test_torch_pp.py PLAN OUT``,
torchrun's variables set) to run one rank.
"""

import faulthandler
import os
import pickle
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tests.test_torch_parallel import start_ranks, wait_ranks  # noqa: E402
from tests.test_torch_threads import share_cores  # noqa: E402

share_cores()

WORLD = 4
LAYOUTS = {"1x4": (4, 1), "2x2": (2, 2)}     # name: (stages, data rows)
DIM, HEADS, LAYERS = 32, 2, 4                # tests/test_pp.py's trunk
FORWARDS = {"m4": (8, 4, False), "m2": (8, 2, False), "m3": (6, 3, False),
            "m4_causal": (8, 4, True)}       # name: (B, M, causal mask)
N = 6
GRAD_B, GRAD_N = 4, 5
GRAD_M = {"1x4": 4, "2x2": 2}                # test_pp.py's backward case
TAIL_M, TAIL_OUT = 4, 16
TOWER_LAYERS = {"1x4": 4, "2x2": 2}
TOWER_M = 2
TOWER_B = 4
TWO_B, TWO_M, TWO_LAYERS, TWO_RANK = 8, 2, 4, 2  # the two-tower cases
TWO_CASES = ("plain", "lora")
TWO_WATCHDOG_S = 45


def _tower(C, layers, skip=None):
    """tests/test_pp.py's EEG tower, ``layers`` trunk blocks, in either
    package's config module."""
    arch = C.VisionArch(image_size=28, patch_size=14, width=64, layers=layers,
                        head_width=16)
    return C.TowerConfig(
        arch=arch, embed_dim=32, modality="eeg", skip_first_n_layers=skip,
        eeg=C.EEGAdapterConfig(chans=8, time_len=16, window_size=1, stride=1),
        perceiver=C.PerceiverConfig(depth=1, num_latents=4, latent_dim=64,
                                    input_dim=64, cross_heads=1,
                                    cross_dim_head=16, latent_heads=2,
                                    latent_dim_head=32))


def _towers():
    """{case: (layout, trunk layers, skip)} of the tower cases."""
    out = {}
    for name in LAYOUTS:
        out[f"tower_{name}"] = (name, TOWER_LAYERS[name], None)
        out[f"skip_{name}"] = (name, 4, 2)
    return out


def _rows(x, d, n_data):
    b = x.shape[0] // n_data
    return x[d * b:(d + 1) * b]


def _causal(n):
    return np.triu(np.full((n, n), -np.inf, np.float32), 1)


# ---------------------------------------------------------------------------
# rank processes
# ---------------------------------------------------------------------------


def _trunk(state, layers=LAYERS):
    from vitlens_tpu_torch.models.layers import Transformer

    trunk = Transformer(DIM, layers, HEADS, device="cpu")
    trunk.load_state_dict(state)
    return trunk


def _grads(module, mesh):
    """{name: gradient summed over the data axis} of the parameters this
    rank holds (zeros where none reached it: a skipped block's)."""
    out = {}
    for n, p in module.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
        torch.distributed.all_reduce(g, group=mesh.group)
        out[n] = g.numpy()
    return out


def _trainable(module):
    for p in module.parameters():
        p.requires_grad_(True)
    return module


def _run_layout(plan, name, mesh):
    from vitlens_tpu_torch.models import layers as L
    from vitlens_tpu_torch.models.vit import VisionTower
    from vitlens_tpu_torch.parallel.pp import (OtherStage, pipeline_place,
                                               pipeline_transformer,
                                               pipelined_trunks,
                                               shard_trunk_pipeline)

    d, n_data = mesh.rank, mesh.data
    res = {"mesh": (mesh.data, mesh.pipe, mesh.rank, mesh.stage, mesh.backend,
                    torch.distributed.get_process_group_ranks(mesh.group),
                    torch.distributed.get_process_group_ranks(mesh.pipe_group),
                    mesh.shape)}
    try:
        with pipelined_trunks(mesh, 2):
            res["hook_set"] = L._TRUNK_PIPELINE == (mesh, 2)
            raise KeyError("inside")
    except KeyError:
        res["hook_reset"] = L._TRUNK_PIPELINE is None
    placed = shard_trunk_pipeline(_trunk(plan["trunk"]), mesh)
    res["held"] = [i for i, b in enumerate(placed.blocks)
                   if not isinstance(b, OtherStage)]
    try:
        placed(torch.zeros(2, N, DIM))
        res["outside_raises"] = False
    except RuntimeError:
        res["outside_raises"] = True

    res["forward"] = {}
    for case, (b, m, causal) in FORWARDS.items():
        x = torch.from_numpy(_rows(plan["x"][:b], d, n_data))
        mask = torch.from_numpy(_causal(N)) if causal else None
        with torch.no_grad():
            res["forward"][case] = pipeline_transformer(
                x, placed, mask, mesh=mesh, n_microbatches=m).numpy()

    trunk = _trainable(shard_trunk_pipeline(_trunk(plan["trunk"]), mesh))
    x = torch.from_numpy(_rows(plan["xg"], d, n_data)).requires_grad_(True)
    y = pipeline_transformer(x, trunk, mesh=mesh, n_microbatches=GRAD_M[name],
                             remat=True)
    (y ** 2).sum().backward()
    res["grad"] = (y.detach().numpy(), x.grad.numpy(), _grads(trunk, mesh))

    trunk = _trainable(shard_trunk_pipeline(_trunk(plan["trunk"]), mesh))
    w = torch.from_numpy(plan["w"])
    x = torch.from_numpy(_rows(plan["x"], d, n_data))
    y = pipeline_transformer(x, trunk, mesh=mesh, n_microbatches=TAIL_M,
                             tail_fn=lambda h: h.mean(1) @ w)
    (y ** 2).sum().backward()
    res["tail"] = (y.detach().numpy(), _grads(trunk, mesh))

    res["towers"] = {}
    for case, (layout, layers, skip) in _towers().items():
        if layout != name:
            continue
        tower = VisionTower(plan["towers"][case]["pcfg"], device="cpu")
        tower.load_state_dict(plan["towers"][case]["state_dict"])
        pipeline_place(_trainable(tower), mesh)
        x = torch.from_numpy(_rows(plan["xt"], d, n_data))
        with pipelined_trunks(mesh, TOWER_M):
            feats = tower(x)
        (feats * torch.from_numpy(_rows(plan["ct"], d, n_data))).sum().backward()
        res["towers"][case] = {
            "feats": feats.detach().numpy(), "grads": _grads(tower, mesh),
            "held": [i for i, b in enumerate(tower.trunk.blocks)
                     if not isinstance(b, OtherStage)]}

    three = _trunk(plan["trunk3"], 3)
    try:
        shard_trunk_pipeline(three, mesh)
        res["three_raises"] = False
    except ValueError:
        res["three_raises"] = True
    x = torch.from_numpy(_rows(plan["x"], d, n_data))
    with torch.no_grad(), pipelined_trunks(mesh, 2):
        res["three"] = three(x).numpy()
    res["routes"] = _run_routes(plan, mesh)
    return res


def _run_routes(plan, mesh):
    """{case: [(kernel, shapes)]} of the bf16 trunk's calls of the attention
    and fused-MLP wrappers (their plain versions on the CPU) under the
    hook: the 4-block trunk at M = 2, and with its first 2 blocks skipped."""
    from vitlens_tpu_torch.models import layers as L
    from vitlens_tpu_torch.ops import attention as A
    from vitlens_tpu_torch.parallel.pp import pipelined_trunks

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
        for case, skip in (("all", None), ("skip2", 2)):
            trunk = _trunk(plan["trunk"])
            x = torch.from_numpy(_rows(plan["x"], mesh.rank, mesh.data))
            del calls[:]
            with torch.no_grad(), pipelined_trunks(mesh, 2):
                trunk(x.bfloat16(), skip_first_n=skip)
            out[case] = list(calls)
    finally:
        A.flash_attention, L.fused_mlp = flash, mlp
    return out


def _text_arch(C):
    """The two-tower cases' causal text trunk: width 32, 2 heads,
    ``TWO_LAYERS`` blocks, 8 tokens."""
    return C.TextArch(context_length=8, vocab_size=50, width=32, heads=2,
                      layers=TWO_LAYERS)


def _clip_loss(v, t):
    """The symmetric contrastive loss of features ``v`` and ``t`` [B, E] at
    logit scale 10 (``_jax_clip_loss`` is JAX's)."""
    logits = 10.0 * (v / v.norm(dim=-1, keepdim=True)) @ (
        t / t.norm(dim=-1, keepdim=True)).T
    n = torch.arange(logits.shape[0])
    return -(torch.log_softmax(logits, -1)[n, n].mean()
             + torch.log_softmax(logits.T, -1)[n, n].mean()) / 2


def _run_two_towers(plan, mesh):
    """{case: (loss, {name: gradient summed over the data axis})} of the
    two-tower cases on ``mesh``: both towers pipeline_place'd, run under one
    pipelined_trunks (M = 2), the features of every data rank gathered, the
    global contrastive loss's backward (over data ranks, each computing it:
    divided by their number)."""
    from vitlens_tpu_torch.models.text import TextTower
    from vitlens_tpu_torch.models.vit import VisionTower
    from vitlens_tpu_torch.parallel.mesh import all_gather
    from vitlens_tpu_torch.parallel.pp import pipeline_place, pipelined_trunks
    from vitlens_tpu_torch.train.lora import lora_init, lora_mask

    d, n_data = mesh.rank, mesh.data
    out = {}
    for case in TWO_CASES:
        c = plan["two"][case]
        towers = {"visual": VisionTower(c["vcfg"], device="cpu"),
                  "text": TextTower(c["tcfg"], 32, device="cpu")}
        for k, tower in towers.items():
            if case == "lora":
                lora_init(tower, TWO_RANK, torch.Generator())
            tower.load_state_dict(c[k])
            trains = (lora_mask(tower) if case == "lora" else
                      dict.fromkeys(tower.state_dict(), True))
            for n, p in tower.named_parameters():
                p.requires_grad_(trains[n])
            pipeline_place(tower, mesh)
        x = torch.from_numpy(_rows(plan["two_x"], d, n_data))
        text = torch.from_numpy(_rows(plan["two_text"], d, n_data)).long()
        with pipelined_trunks(mesh, TWO_M):
            v = towers["visual"](x)
            t = towers["text"](text)
        loss = _clip_loss(all_gather(v, mesh), all_gather(t, mesh))
        (loss / n_data).backward()
        grads = {}
        for k, tower in towers.items():
            grads.update({f"{k}.{n}": g for n, g in _grads(tower, mesh).items()
                          if dict(tower.named_parameters())[n].requires_grad})
        out[case] = (float(loss), grads)
    return out


def _fsdp_refused(plan) -> bool:
    """True where pipeline_place refuses a tower whose blocks and whole
    are FSDP2 units (fsdp_place's wrapping) over the data axis."""
    from torch.distributed.fsdp import fully_shard

    from vitlens_tpu_torch.models.vit import VisionTower
    from vitlens_tpu_torch.parallel.fsdp import _device_mesh
    from vitlens_tpu_torch.parallel.mesh import make_mesh
    from vitlens_tpu_torch.parallel.pp import make_pipe_mesh, pipeline_place

    case = plan["towers"]["tower_2x2"]
    tower = VisionTower(case["pcfg"], device="cpu")
    tower.load_state_dict(case["state_dict"])
    dmesh = _device_mesh(make_mesh())
    for block in tower.trunk.blocks:
        fully_shard(block, mesh=dmesh)
    fully_shard(tower, mesh=dmesh)
    try:
        pipeline_place(tower, make_pipe_mesh(2, 2))
    except ValueError:
        return True
    return False


def _tp_refused(plan) -> bool:
    """True where pipeline_place refuses a tower split over a model axis."""
    from vitlens_tpu_torch.models.vit import VisionTower
    from vitlens_tpu_torch.parallel.mesh import make_mesh
    from vitlens_tpu_torch.parallel.pp import make_pipe_mesh, pipeline_place
    from vitlens_tpu_torch.parallel.tp import shard_vision_tower

    case = plan["towers"]["tower_2x2"]
    tower = VisionTower(case["pcfg"], device="cpu")
    tower.load_state_dict(case["state_dict"])
    shard_vision_tower(tower, make_mesh(n_model=2))
    try:
        pipeline_place(tower, make_pipe_mesh(2, 2))
    except ValueError:
        return True
    return False


def _worker(plan_path, out_dir) -> int:
    from vitlens_tpu_torch.parallel.mesh import init_distributed
    from vitlens_tpu_torch.parallel.pp import make_pipe_mesh

    rank = init_distributed(device="cpu", timeout_s=120)
    with open(plan_path, "rb") as f:
        plan = pickle.load(f)
    res = {}
    for name, (stages, n_data) in LAYOUTS.items():
        res[name] = _run_layout(plan, name, make_pipe_mesh(stages, n_data))
    try:
        make_pipe_mesh(3)
        res["bad_layout_raises"] = False
    except ValueError:
        res["bad_layout_raises"] = True
    res["tp_refused"] = _tp_refused(plan)
    res["fsdp_refused"] = _fsdp_refused(plan)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    # a hang here must cost the two-tower tests alone: the other results
    # are written, and the watchdog ends the rank with its stack in the log
    faulthandler.dump_traceback_later(TWO_WATCHDOG_S, exit=True)
    two = {name: _run_two_towers(plan, make_pipe_mesh(stages, n_data))
           for name, (stages, n_data) in LAYOUTS.items()}
    faulthandler.cancel_dump_traceback_later()
    with open(os.path.join(out_dir, f"rank{rank}_two.pkl"), "wb") as f:
        pickle.dump(two, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_worker(*sys.argv[1:]))


# ---------------------------------------------------------------------------
# the parent: plan, JAX's results, comparisons
# ---------------------------------------------------------------------------


def _jax_mesh(name):
    from tests.conftest import cpu_devices
    from vitlens_tpu.parallel.pp import make_pipe_mesh

    stages, n_data = LAYOUTS[name]
    return make_pipe_mesh(stages, n_data, devices=cpu_devices()[:WORLD])


def _jax_trunks(name, p, plan):
    """JAX's pipelined trunk on ``name``'s mesh: the forwards, the remat
    gradient and the tail's output and gradient."""
    import jax
    import jax.numpy as jnp

    from vitlens_tpu.models.layers import gelu
    from vitlens_tpu.parallel.pp import pipeline_transformer, shard_trunk_pipeline

    mesh = _jax_mesh(name)
    ps = shard_trunk_pipeline(p, mesh)
    out = {"forward": {}}
    for case, (b, m, causal) in FORWARDS.items():
        mask = jnp.asarray(_causal(N)) if causal else None
        out["forward"][case] = np.asarray(jax.jit(lambda p, v: pipeline_transformer(
            v, p, HEADS, gelu, mask, mesh=mesh, n_microbatches=m))(
                ps, jnp.asarray(plan["x"][:b])))

    def pp(p, v, **kw):
        return pipeline_transformer(v, p, HEADS, gelu, mesh=mesh, **kw)

    xg = jnp.asarray(plan["xg"])
    kw = dict(n_microbatches=GRAD_M[name], remat=True)
    y, (gp, gx) = jax.jit(_out_and_grad(lambda p, v: pp(p, v, **kw),
                                        lambda y: jnp.sum(y ** 2), (0, 1)))(ps, xg)
    out["grad"] = (np.asarray(y), np.asarray(gx), jax.device_get(gp))
    w = jnp.asarray(plan["w"])
    kw = dict(n_microbatches=TAIL_M, tail_fn=lambda h: h.mean(axis=1) @ w)
    x = jnp.asarray(plan["x"])
    y, gp = jax.jit(_out_and_grad(lambda p, v: pp(p, v, **kw),
                                  lambda y: jnp.sum(y ** 2)))(ps, x)
    out["tail"] = (np.asarray(y), jax.device_get(gp))
    return out


def _out_and_grad(f, loss, argnums=0):
    """(f's output, the gradient of loss(f's output)) in one program: one
    trace and one compile where a forward and a jax.grad took two."""
    import jax

    def with_out(*a):
        y = f(*a)
        return loss(y), y

    def fn(*a):
        (_, y), g = jax.value_and_grad(with_out, argnums, has_aux=True)(*a)
        return y, g

    return fn


# JAX's pipelined_trunks hook is one module global, read at trace time: a
# thread holds this while it traces under the hook
_HOOK = threading.Lock()


def _jax_hooked_tower(case, tower, plan):
    """JAX's features of a tower case and the gradient of sum(features *
    ct), under pipelined_trunks after pipeline_place: one program, traced
    holding :data:`_HOOK`, compiled after."""
    import jax
    import jax.numpy as jnp

    from vitlens_tpu.models.vit import vision_tower_apply
    from vitlens_tpu.parallel.pp import pipeline_place, pipelined_trunks

    jcfg, params, state = tower
    x, ct = jnp.asarray(plan["xt"]), jnp.asarray(plan["ct"])
    mesh = _jax_mesh(_towers()[case][0])
    placed = pipeline_place(params, mesh)

    def feats(p, v):
        return vision_tower_apply(p, state, v, jcfg)[0]

    with _HOOK, pipelined_trunks(mesh, n_microbatches=TOWER_M):
        fg = jax.jit(_out_and_grad(feats, lambda y: jnp.sum(y * ct))).lower(
            placed, x)
    f, g = fg.compile()(placed, x)
    return np.asarray(f), jax.device_get(g)


def _jax_hooked(trunk3, plan):
    """The 3-block trunk's forward under JAX's trace-time hook (plain),
    traced holding :data:`_HOOK` and compiled after, with its
    shard_trunk_pipeline's assert."""
    import jax
    import jax.numpy as jnp

    from vitlens_tpu.models.layers import gelu, transformer
    from vitlens_tpu.parallel.pp import pipelined_trunks, shard_trunk_pipeline

    out = {"three": {}, "three_raises": {}}
    for name in LAYOUTS:
        mesh = _jax_mesh(name)
        try:
            shard_trunk_pipeline(trunk3, mesh)
            out["three_raises"][name] = False
        except AssertionError:
            out["three_raises"][name] = True
        with _HOOK, pipelined_trunks(mesh, n_microbatches=2):
            three = jax.jit(lambda p, v: transformer(v, p, HEADS, gelu)).lower(
                trunk3, jnp.asarray(plan["x"]))
        out["three"][name] = np.asarray(three.compile()(
            trunk3, jnp.asarray(plan["x"])))
    return out


def _jax_clip_loss(v, t):
    """:func:`_clip_loss` in JAX."""
    import jax
    import jax.numpy as jnp

    logits = 10.0 * (v / jnp.linalg.norm(v, axis=-1, keepdims=True)) @ (
        t / jnp.linalg.norm(t, axis=-1, keepdims=True)).T
    d = jnp.arange(logits.shape[0])
    return -(jax.nn.log_softmax(logits, -1)[d, d].mean()
             + jax.nn.log_softmax(logits.T, -1)[d, d].mean()) / 2


def _two_towers_init(plan, vision):
    """The two-tower cases' JAX trees ({case: (vision config, text arch,
    vision params, vision state, text params)}; the LoRA case's trees carry
    rank-2 factors with b away from zero) and their port state dicts in
    ``plan["two"]``; the global batch in ``plan["two_x"]`` and
    ``plan["two_text"]`` (each text's highest id, its EOT, at a random
    place). ``vision``: the tower_1x4 case's (config, params, state)."""
    import jax

    from tests.test_torch_fsdp import _with_lora
    from tests.test_torch_tp import _biased
    from vitlens_tpu import config as JC
    from vitlens_tpu.models.text import text_tower_init
    from vitlens_tpu_torch import config as PC
    from vitlens_tpu_torch.models.text import TextTower
    from vitlens_tpu_torch.models.vit import VisionTower
    from vitlens_tpu_torch.train.lora import lora_init
    from vitlens_tpu_torch.weights.from_jax import load_params

    rng = np.random.RandomState(21)
    plan["two_x"] = rng.randn(TWO_B, 8, 16).astype(np.float32)
    text = rng.randint(1, 49, size=(TWO_B, 8)).astype(np.int32)
    text[np.arange(TWO_B), rng.randint(1, 8, size=TWO_B)] = 49
    plan["two_text"] = text
    vj, vp, vs = vision
    tj = _text_arch(JC)
    tp = text_tower_init(jax.random.PRNGKey(32), tj, 32)
    tp = dict(tp, trunk=_biased(tp["trunk"], 32))
    lora = _with_lora({"visual": vp, "text": tp},
                      {"visual": TWO_RANK, "text": TWO_RANK}, seed=33)
    trees = {"plain": (vj, tj, vp, vs, tp),
             "lora": (vj, tj, lora["visual"], vs, lora["text"])}
    plan["two"] = {}
    for case, (_, _, v, _, t) in trees.items():
        vcfg, tcfg = _tower(PC, TWO_LAYERS), _text_arch(PC)
        towers = (VisionTower(vcfg, device="cpu"), TextTower(tcfg, 32, device="cpu"))
        if case == "lora":
            for tower in towers:
                lora_init(tower, TWO_RANK, torch.Generator())
        plan["two"][case] = {
            "vcfg": vcfg, "tcfg": tcfg,
            "visual": load_params(towers[0], v).state_dict(),
            "text": load_params(towers[1], t).state_dict()}
    return trees


def _jax_two_towers(name, case, tree, plan):
    """(loss, {port name: gradient}) of jax.value_and_grad of the global
    contrastive loss on layout ``name``: both towers pipeline_place'd and
    traced under JAX's pipelined_trunks (M = 2), the trace holding
    :data:`_HOOK`, the compile not."""
    import jax
    import jax.numpy as jnp

    from vitlens_tpu.models.text import text_tower_apply
    from vitlens_tpu.models.vit import vision_tower_apply
    from vitlens_tpu.parallel.pp import pipeline_place, pipelined_trunks
    from vitlens_tpu_torch.weights.from_jax import flatten

    vcfg, tcfg, vp, vs, tp = tree
    x, text = jnp.asarray(plan["two_x"]), jnp.asarray(plan["two_text"])

    def loss(p):
        v = vision_tower_apply(p["visual"], vs, x, vcfg)[0]
        return _jax_clip_loss(v, text_tower_apply(p["text"], text, tcfg))

    mesh = _jax_mesh(name)
    placed = {"visual": pipeline_place(vp, mesh), "text": pipeline_place(tp, mesh)}
    with _HOOK, pipelined_trunks(mesh, n_microbatches=TWO_M):
        lowered = jax.jit(jax.value_and_grad(loss)).lower(placed)
    value, g = lowered.compile()(placed)
    return float(value), flatten(jax.device_get(g))


def _wait(ranks, root):
    """``wait_ranks``; a failure after every rank wrote its results of the
    other cases (so in the two-tower cases) is returned, not raised: it
    fails those tests alone."""
    try:
        wait_ranks(*ranks)
    except AssertionError as e:
        if not all((root / f"rank{r}.pkl").exists() for r in range(WORLD)):
            raise
        return str(e)
    return None


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Writes the plan, starts the ranks, computes JAX's results while they
    run. Returns (plan, JAX's results, the ranks' results)."""
    import jax

    from tests.test_torch_tp import _biased
    from vitlens_tpu import config as JC
    from vitlens_tpu.models.layers import transformer_init
    from vitlens_tpu.models.vit import vision_tower_init
    from vitlens_tpu_torch import config as PC
    from vitlens_tpu_torch.models.layers import Transformer
    from vitlens_tpu_torch.models.vit import VisionTower
    from vitlens_tpu_torch.weights.from_jax import load_params

    root = tmp_path_factory.mktemp("pp")
    rng = np.random.RandomState(0)
    trunk = _biased(transformer_init(jax.random.PRNGKey(0), DIM, LAYERS), 1)
    trunk3 = _biased(transformer_init(jax.random.PRNGKey(3), DIM, 3), 3)
    plan = {"x": rng.randn(8, N, DIM).astype(np.float32),
            "xg": rng.randn(GRAD_B, GRAD_N, DIM).astype(np.float32),
            "w": (rng.randn(DIM, TAIL_OUT) / np.sqrt(DIM)).astype(np.float32),
            "xt": rng.randn(TOWER_B, 8, 16).astype(np.float32),
            "ct": rng.randn(TOWER_B, 32).astype(np.float32),
            "trunk": load_params(Transformer(DIM, LAYERS, HEADS, device="cpu"),
                                 trunk).state_dict(),
            "trunk3": load_params(Transformer(DIM, 3, HEADS, device="cpu"),
                                  trunk3).state_dict(),
            "towers": {}}
    towers = {}
    for i, (case, (_, layers, skip)) in enumerate(_towers().items()):
        jcfg, pcfg = _tower(JC, layers, skip), _tower(PC, layers, skip)
        p, s = vision_tower_init(jax.random.PRNGKey(5 + i), jcfg)
        p = dict(p, trunk=_biased(p["trunk"], 5 + i))
        towers[case] = (jcfg, p, s)
        plan["towers"][case] = {"pcfg": pcfg, "state_dict": load_params(
            VisionTower(pcfg, device="cpu"), p).state_dict()}
    trees = _two_towers_init(plan, towers["tower_1x4"])
    with open(root / "plan.pkl", "wb") as f:
        pickle.dump(plan, f)
    ranks = start_ranks([sys.executable, os.path.abspath(__file__),
                         str(root / "plan.pkl"), str(root)], str(root / "logs"),
                        world=WORLD)
    try:
        with ThreadPoolExecutor(7) as pool:
            trunks = {n: pool.submit(_jax_trunks, n, trunk, plan) for n in LAYOUTS}
            hooked = pool.submit(_jax_hooked, trunk3, plan)
            hooked_towers = {c: pool.submit(_jax_hooked_tower, c, t, plan)
                             for c, t in towers.items()}
            two = {(n, c): pool.submit(_jax_two_towers, n, c, tree, plan)
                   for n in LAYOUTS for c, tree in trees.items()}
            jax_out = {"trunks": {n: f.result() for n, f in trunks.items()},
                       "hooked": dict(hooked.result(), towers={
                           c: f.result() for c, f in hooked_towers.items()}),
                       "trunk": trunk,
                       "towers": {c: v[1] for c, v in towers.items()},
                       "two": {k: f.result() for k, f in two.items()}}
    finally:
        two_failed = _wait(ranks, root)
    jax_out["two_failed"] = two_failed
    got = []
    for r in range(WORLD):
        with open(root / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
        if two_failed is None:
            with open(root / f"rank{r}_two.pkl", "rb") as f:
                got[r]["two"] = pickle.load(f)
    return plan, jax_out, got


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1e-12, np.abs(want).max())


def _place(r, name):
    """(data row, stage) of rank r on layout ``name``."""
    stages, _ = LAYOUTS[name]
    return divmod(r, stages)


def _merged(got, name, key):
    """{port name: gradient} of a trunk case, each block's from the rank of
    data row 0 that holds it."""
    out = {}
    for r, res in enumerate(got):
        if _place(r, name)[0] == 0:
            out.update(key(res[name]))
    return out


# -- the layout -----------------------------------------------------------------


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_matches_jax(run, name):
    """Each rank's place is its device's in JAX's [data, pipe] device array
    (pipe innermost); the data axis's group is the ranks of its stage, the
    pipe's the ranks of its data row; the hook is set inside
    pipelined_trunks and reset on leaving it by an exception; a placed trunk
    outside the hook raises; a layout that does not fill the world raises;
    pipeline_place refuses a tower split over a model axis."""
    from tests.conftest import cpu_devices

    _, _, got = run
    stages, n_data = LAYOUTS[name]
    devices = _jax_mesh(name).devices
    for r, res in enumerate(got):
        d, s = _place(r, name)
        assert devices[d, s] == cpu_devices()[r]
        assert res[name]["mesh"] == (
            n_data, stages, d, s, "gloo",
            [s + i * stages for i in range(n_data)],
            list(range(d * stages, (d + 1) * stages)),
            {"data": n_data, "model": 1, "pipe": stages})
        assert res[name]["hook_set"] and res[name]["hook_reset"]
        assert res[name]["held"] == [s * LAYERS // stages + i
                                     for i in range(LAYERS // stages)]
        assert res[name]["outside_raises"] and res["bad_layout_raises"]
        assert res["tp_refused"]


# -- the trunk: forward, gradient, tail -------------------------------------------


@pytest.mark.parametrize("case", list(FORWARDS))
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_forward_matches_jax(run, name, case):
    """pipeline_transformer on each data rank's rows against JAX's
    pipelined trunk on the same layout (rtol 2e-5, atol 1e-5), equal on
    every stage of a data row."""
    _, jax_out, got = run
    want = jax_out["trunks"][name]["forward"][case]
    _, n_data = LAYOUTS[name]
    for r, res in enumerate(got):
        np.testing.assert_allclose(res[name]["forward"][case],
                                   _rows(want, _place(r, name)[0], n_data),
                                   rtol=2e-5, atol=1e-5)
        np.testing.assert_array_equal(
            res[name]["forward"][case],
            got[r - _place(r, name)[1]][name]["forward"][case])


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_grad_with_remat_matches_jax(run, name):
    """remat=True: the output and x's gradient rows on every rank, and each
    block's gradient (summed over the data axis, from the stage that holds
    it) against jax.grad of JAX's pipelined trunk, 1e-5 of max|ref|; every
    block is covered once a data row."""
    from vitlens_tpu_torch.weights.from_jax import flatten

    _, jax_out, got = run
    y, gx, gp = jax_out["trunks"][name]["grad"]
    want = flatten({"blocks": gp["blocks"]})
    _, n_data = LAYOUTS[name]
    for r, res in enumerate(got):
        d = _place(r, name)[0]
        oy, ogx, _ = res[name]["grad"]
        assert _rel(oy, _rows(y, d, n_data)) < 1e-5
        assert _rel(ogx, _rows(gx, d, n_data)) < 1e-5
    merged = _merged(got, name, lambda res: res["grad"][2])
    assert sorted(merged) == sorted(want)
    for n, g in merged.items():
        assert _rel(g, want[n]) < 1e-5, n


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_tail_fn_forward_and_grad(run, name):
    """tail_fn banked on the last stage: the [B, 16] output rows (rtol 2e-5,
    atol 1e-5) and every block's gradient of sum(out ** 2) (1e-5 of
    max|ref|) against JAX's."""
    from vitlens_tpu_torch.weights.from_jax import flatten

    _, jax_out, got = run
    y, gp = jax_out["trunks"][name]["tail"]
    want = flatten({"blocks": gp["blocks"]})
    _, n_data = LAYOUTS[name]
    for r, res in enumerate(got):
        out = res[name]["tail"][0]
        assert out.shape == (8 // n_data, TAIL_OUT)
        np.testing.assert_allclose(out, _rows(y, _place(r, name)[0], n_data),
                                   rtol=2e-5, atol=1e-5)
    merged = _merged(got, name, lambda res: res["tail"][1])
    assert sorted(merged) == sorted(want)
    for n, g in merged.items():
        assert _rel(g, want[n]) < 1e-5, n


# -- the tower under the hook -------------------------------------------------------


@pytest.mark.parametrize("case", list(_towers()))
def test_tower_via_pipelined_trunks(run, case):
    """The EEG tower after pipeline_place under pipelined_trunks (M = 2)
    against JAX's under its hook: the features (rtol 2e-5, atol 1e-5) and
    every parameter's gradient of sum(features * ct) (1e-5 of max|ref|; a
    trunk block's from the stage that holds it, a replicated parameter's
    equal on every rank). With skip_first_n 2 of 4 blocks the 2 stages hold
    blocks 2 and 3 alone; on 4 stages the 2 blocks that run do not divide
    and every rank holds and runs the whole trunk."""
    from vitlens_tpu_torch.weights.from_jax import flatten

    _, jax_out, got = run
    name, layers, skip = _towers()[case]
    stages, n_data = LAYOUTS[name]
    f, gp = jax_out["hooked"]["towers"][case]
    want = flatten(gp)
    first = skip or 0
    divides = (layers - first) % stages == 0
    per = (layers - first) // stages
    merged = {}
    for r, res in enumerate(got):
        d, s = _place(r, name)
        t = res[name]["towers"][case]
        np.testing.assert_allclose(t["feats"], _rows(f, d, n_data),
                                   rtol=2e-5, atol=1e-5)
        assert t["held"] == (list(range(first + s * per, first + (s + 1) * per))
                             if divides else list(range(layers)))
        for n, g in t["grads"].items():
            if n.startswith("trunk.blocks."):
                if d == 0:
                    merged[n] = g
            else:
                assert _rel(g, want[n]) < 1e-5, (r, n)
    for n in want:
        if n.startswith("trunk.blocks.") and int(n.split(".")[2]) >= first:
            assert _rel(merged[n], want[n]) < 1e-5, n


# -- the fallback and the kernel routes -------------------------------------------


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_depth_not_dividing_raises_and_runs_plain(run, name):
    """A 3-block trunk: shard_trunk_pipeline raises on both layouts, as
    JAX's asserts; under the hook the trunk runs plain, JAX's output rows
    (rtol 2e-5, atol 1e-5)."""
    _, jax_out, got = run
    _, n_data = LAYOUTS[name]
    assert jax_out["hooked"]["three_raises"][name]
    want = jax_out["hooked"]["three"][name]
    for r, res in enumerate(got):
        assert res[name]["three_raises"]
        np.testing.assert_allclose(res[name]["three"],
                                   _rows(want, _place(r, name)[0], n_data),
                                   rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_kernel_routes(run, name):
    """bf16 under the hook at M = 2: each rank calls attention and the
    fused MLP once a block of its stage a microbatch, (L - skip) / S x M
    times, at the microbatch's shapes; with 2 of 4 blocks skipped on 4
    stages the trunk runs plain (2 blocks on the rank's whole rows)."""
    _, _, got = run
    stages, n_data = LAYOUTS[name]
    rows = 8 // n_data

    def calls(blocks, b):
        attn = ("attn", (b, HEADS, N, DIM // HEADS), (b, HEADS, N, DIM // HEADS))
        return [attn, ("mlp", (b * N, DIM))] * blocks

    mb = rows // 2
    want = {"all": calls(LAYERS // stages, mb) * 2,
            "skip2": (calls(2 // stages, mb) * 2 if 2 % stages == 0
                      else calls(2, rows))}
    for res in got:
        assert res[name]["routes"] == want


# -- two trained towers in one backward ---------------------------------------------


@pytest.mark.parametrize("case", TWO_CASES)
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_two_trained_towers_pipelined_in_one_backward(run, name, case):
    """The vision and the text tower, both pipelined (M = 2) under one
    pipelined_trunks and trained by one backward of a contrastive loss over
    the global batch, every parameter ("plain") or the LoRA factors of
    both trunks alone ("lora"): the loss on every rank 1e-5 relative to
    JAX's, and each gradient (summed over the data axis) 1e-5 of its
    max|ref| against jax.value_and_grad under JAX's pipelined_trunks; a
    trunk block's (or its factors') from the stage that runs it, the others
    on every rank. The ranks run these cases under a watchdog: a hang ends
    them within 45 s and fails these tests alone."""
    _, jax_out, got = run
    assert jax_out["two_failed"] is None, jax_out["two_failed"]
    loss, want = jax_out["two"][name, case]
    merged, seen = {}, set()
    for r, res in enumerate(got):
        d, _ = _place(r, name)
        got_loss, grads = res["two"][name][case]
        assert _rel(got_loss, loss) < 1e-5, r
        seen.update(grads)
        for n, g in grads.items():
            if ".trunk.blocks." in n:
                if d == 0:
                    merged[n] = merged.get(n, 0) + g
            else:
                assert _rel(g, want[n]) < 1e-5, (r, n)
    trained = [n for n in want if case == "plain" or (
        ".lora." in n and n.endswith((".a", ".b")))]
    assert sorted(seen) == sorted(trained)
    assert len(trained) == (len(want) if case == "plain" else 2 * 4 * 4 * 2)
    for n, g in merged.items():
        assert _rel(g, want[n]) < 1e-5, n


def test_pipeline_place_refuses_fsdp_tower(run):
    """A tower wrapped by FSDP2 as fsdp_place wraps it (each trunk block,
    then the tower) is refused by pipeline_place on every rank."""
    _, _, got = run
    assert [res["fsdp_refused"] for res in got] == [True] * WORLD
