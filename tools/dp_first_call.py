#!/usr/bin/env python3
"""First call of the data-parallel and FSDP phases on the card
(chip_smoke.py phases 4dp and 4fs), without the rest of chip_smoke.py:

    python3 tools/dp_first_call.py           # the first call
    python3 tools/dp_first_call.py --plant   # phase 4dp (b) against two faults
    python3 tools/dp_first_call.py --fsdp    # phases 4dp/4fs (a), (b), (c)
    python3 tools/dp_first_call.py --fsdp --plant [NAME]  # 4fs (b), faults
    python3 tools/dp_first_call.py --tp      # phase 4tp
    python3 tools/dp_first_call.py --tp --plant [NAME]    # 4tp (b), faults
    python3 tools/dp_first_call.py --pp      # point-to-point probe, phase 4pp
    python3 tools/dp_first_call.py --pp --plant [NAME]    # 4pp, faults
    python3 tools/dp_first_call.py --lora    # the LoRA parts of 4fs, 4tp, 4pp
    python3 tools/dp_first_call.py --fsdp --lora          # 4fs (b)'s alone
    python3 tools/dp_first_call.py --tp --lora   # 4tp (b)'s and 4pp (c)'s

1. two ranks that both take cuda:0 under NCCL: prints what NCCL says (it
   refuses two ranks on one device);
2. two gloo ranks on cuda:0: all_gather, all_reduce and broadcast of CUDA
   tensors, results checked;
3. phase 4dp (a) on phase 4b's vitlensL audio recipe (a fresh state), (b)
   and (c), as chip_smoke.py runs them.

Exits non-zero when a check fails.

With ``--plant``, phase 4dp (b) runs twice, each time with a fault planted
in both rank processes (the step's functions replaced at run time; no file
changes): ``unsynced-bn`` (BatchNorm normalised over the rank's own rows)
and ``summed-grads`` (the gradients summed over the ranks, not averaged).
Exits 0 only when the phase fails under each fault.

With ``--fsdp``: the gloo probe, then phases 4dp (a) and 4fs (a) on a
fresh vitlensL audio state, then the two rank processes of 4dp (b), which
run 4fs (b) and (c) after it. With ``--fsdp --plant``, 4fs (b) runs under
each fault of FS_FAULTS (or the one named), planted in the FSDP step
alone, so that 4dp (b) still passes: ``autograd-grad`` (the gradients
through ``torch.autograd.grad`` where a parameter is sharded: FSDP2's sharded
parameters are not in the graph), ``local-norm`` (grad_norm over this
rank's shards and the replicated gradients, not all-reduced) and
``unsynced-bn`` (the FSDP step's BatchNorm over the rank's own rows).

With ``--tp``: the gloo probe, then phase 4tp (four ranks sharing the card,
[data 2, model 2]: the encodes of (a), the 2D steps of (b)). With ``--tp
--plant``, 4tp runs under each fault of TP_FAULTS (or the one named),
planted in (b)'s steps alone, so that (a) still passes: ``bias-twice`` (a
split block's out_b added on each model rank before the all-reduce, i.e.
tp + 1 times in all) and ``unsummed-sp`` (under sequence parallelism, the
gradients of a block's LayerNorm parameters left as each rank's part, not
summed over the model axis).

With ``--pp``: the point-to-point probe (two gloo ranks on cuda:0 exchange
4 MB CUDA tensors, bf16 and fp32, by ``send``/``recv``, by ``isend``/
``irecv``, by ``batch_isend_irecv`` and staged through host copies; each
op in rank processes of its own, what arrived printed), then phase 4pp in
four rank processes of its own (chip_smoke.py ``--pp-rank``). With ``--pp
--plant``, 4pp runs under each fault of PP_FAULTS (or the one named):
``no-input-sum`` (Megatron's f in front of a pipelined trunk without its
backward's all-reduce: the pre-trunk gradients are zero on the stages past
the first) and ``stored-depth-stages`` (the stages split the stored blocks,
ignoring ``skip_first_n``: the vitlensG stages run 0, 8, 12 and 12 of its
32 blocks).

With ``--lora``: the gloo and FSDP2-over-gloo probes, then the LoRA
sub-phases alone: 4fs (b)'s LoRA recipe in two rank processes
(chip_smoke.py ``--dp-rank --lora``), then 4tp (b)'s LoRA step and 4pp
(c)'s LoRA variant in four (``--tp-rank --lora``). ``--fsdp --lora`` runs
the first of those, ``--tp --lora`` (or ``--pp --lora``) the second.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def probe(kind: str) -> int:
    """A rank of the two-rank probes (torchrun's variables set)."""
    import torch
    import torch.distributed as dist

    env = os.environ
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    torch.cuda.set_device(0)
    dist.init_process_group(
        kind, init_method=f"tcp://127.0.0.1:{env['MASTER_PORT']}",
        world_size=world, rank=rank, timeout=datetime.timedelta(seconds=60))
    x = torch.full((4, 3), float(rank + 1), device="cuda")
    try:
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        y = x.clone()
        dist.all_reduce(y)
        z = x.clone()
        dist.broadcast(z, src=0)
        torch.cuda.synchronize()
        ok = (all(torch.equal(p, torch.full_like(x, i + 1.0))
                  for i, p in enumerate(parts))
              and torch.equal(y, torch.full_like(x, 3.0))
              and torch.equal(z, torch.full_like(x, 1.0)))
        print(f"{kind} rank {rank}: all_gather, all_reduce, broadcast of CUDA "
              f"tensors {'correct' if ok else 'WRONG'}", flush=True)
        return 0 if ok else 1
    except Exception as e:  # noqa: BLE001 - printed for the record
        print(f"{kind} rank {rank}: {type(e).__name__}: {str(e)[:600]}",
              flush=True)
        return 2
    finally:
        try:
            dist.destroy_process_group()
        except Exception:  # noqa: BLE001
            pass


def probe_fsdp() -> int:
    """A rank of the FSDP probe: gloo on cuda:0, each stage printed before it
    runs (a crash's Python stack from faulthandler): all_gather_into_tensor
    and reduce_scatter_tensor of CUDA tensors, then fully_shard of two
    Linear layers, a forward and backward, the gradients checked against
    one process's, gathered with ``parallel.fsdp.full_tensor``
    (``DTensor.full_tensor`` crashes a gloo group on CUDA tensors)."""
    import faulthandler

    import torch
    import torch.distributed as dist

    faulthandler.enable()
    sys.path.insert(0, REPO)
    env = os.environ
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{env['MASTER_PORT']}",
        world_size=world, rank=rank, timeout=datetime.timedelta(seconds=60))

    def say(msg):
        print(f"fsdp rank {rank}: {msg}", flush=True)

    x = torch.full((4, 3), float(rank + 1), device="cuda")
    try:
        say("all_gather_into_tensor")
        out = x.new_empty((4 * world, 3))
        dist.all_gather_into_tensor(out, x)
        say(f"  {out[::4, 0].tolist()}")
        say("reduce_scatter_tensor")
        y = x.new_empty((4 // world, 3))
        dist.reduce_scatter_tensor(y, x)
        say(f"  {y[:, 0].tolist()}")
    except Exception as e:  # noqa: BLE001 - printed for the record
        say(f"{type(e).__name__}: {str(e)[:600]}")
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.fsdp import fully_shard

    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(64, 64), torch.nn.Linear(64, 8)).cuda()
    ref = [p.detach().clone() for p in net.parameters()]
    inp = torch.randn(8, 64, device="cuda")
    try:
        say("fully_shard")
        mesh = DeviceMesh.from_group(dist.group.WORLD, "cuda")
        for m in net:
            fully_shard(m, mesh=mesh)
        say("forward")
        loss = net(inp[rank * 4:(rank + 1) * 4]).square().sum()
        say("backward")
        loss.backward()
        torch.cuda.synchronize()
        from vitlens_tpu_torch.parallel.fsdp import full_tensor

        g = [full_tensor(p.grad) for p in net.parameters()]
        one = torch.nn.Sequential(torch.nn.Linear(64, 64), torch.nn.Linear(64, 8)).cuda()
        with torch.no_grad():
            for p, r in zip(one.parameters(), ref):
                p.copy_(r)
        (one(inp).square().sum() / world).backward()
        err = max((a - p.grad).abs().max().item() for a, p in zip(g, one.parameters()))
        say(f"gradients against one process: max abs diff {err:.3e}")
        return 0 if err < 1e-4 else 1
    except Exception as e:  # noqa: BLE001 - printed for the record
        say(f"{type(e).__name__}: {str(e)[:600]}")
        return 2
    finally:
        dist.destroy_process_group()


PP_PROBE_BYTES = 4 << 20   # 4 MB a tensor, bf16 and fp32
PP_OPS = ("send", "isend", "batch", "staged")


def probe_pp(op: str) -> int:
    """A rank of the point-to-point probe: two gloo ranks on cuda:0, each
    sends a 4 MB CUDA tensor (bf16, then fp32) to the other by ``op``:
    ``send`` (rank 0 a blocking send, rank 1 a blocking recv, then the
    other way), ``isend`` (isend and irecv both posted, then both waited),
    ``batch`` (``dist.batch_isend_irecv`` of the pair), ``staged`` (the
    isend/irecv pair on host copies, the received one copied to the card).
    Prints what arrived and the ms of the exchange (the second of two);
    each op runs in rank processes of its own, so that a crash of one
    leaves the others' answers."""
    import torch
    import torch.distributed as dist

    env = os.environ
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    peer = 1 - rank
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{env['MASTER_PORT']}",
        world_size=world, rank=rank, timeout=datetime.timedelta(seconds=30))

    def say(msg):
        print(f"pp rank {rank}: {op} {msg}", flush=True)

    def exchange(x, got):
        if op == "send":
            for src in (0, 1):
                if rank == src:
                    dist.send(x, peer)
                else:
                    dist.recv(got, peer)
            return got
        if op == "isend":
            works = [dist.isend(x, peer), dist.irecv(got, peer)]
        elif op == "batch":
            works = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                            dist.P2POp(dist.irecv, got, peer)])
        else:  # staged through the host
            host = torch.empty(got.shape, dtype=got.dtype)
            works = [dist.isend(x.cpu(), peer), dist.irecv(host, peer)]
        for w in works:
            w.wait()
        if op == "staged":
            got.copy_(host)
        return got

    status = 0
    for dtype in (torch.bfloat16, torch.float32):
        n = PP_PROBE_BYTES // torch.tensor([], dtype=dtype).element_size()
        x = torch.arange(n, device="cuda").to(dtype) * 0 + (rank + 1)
        x[: 1024] = torch.arange(1024, device="cuda").to(dtype) + rank
        want = torch.arange(n, device="cuda").to(dtype) * 0 + (peer + 1)
        want[: 1024] = torch.arange(1024, device="cuda").to(dtype) + peer
        try:
            got = exchange(x, torch.zeros_like(x))
            torch.cuda.synchronize()
            ok = torch.equal(got, want)
            t = time.time()
            exchange(x, torch.zeros_like(x))
            torch.cuda.synchronize()
            say(f"{dtype} CUDA 4 MB: {'correct' if ok else 'WRONG'}, "
                f"{(time.time() - t) * 1e3:.2f} ms")
            status |= 0 if ok else 1
        except Exception as e:  # noqa: BLE001 - printed for the record
            say(f"{dtype} CUDA 4 MB: {type(e).__name__}: {str(e)[:400]}")
            status |= 2
    try:
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001
        pass
    return status


def run_probe(kind: str, *more):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    out = tempfile.mkdtemp(prefix=f"dp_probe_{kind}_")
    procs, logs = [], []
    for r in range(2):
        logs.append(os.path.join(out, f"rank{r}.log"))
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(r), MASTER_PORT=port)
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--probe", kind,
                 *more],
                stdout=f, stderr=subprocess.STDOUT, env=env))
    for p in procs:
        try:
            p.wait(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    for r, log in enumerate(logs):
        text = open(log).read().strip().splitlines()
        said = [ln for ln in text if ln.startswith(kind)] or text[-3:]
        print(f"[probe {kind} {' '.join(more)}] rank {r} exit "
              f"{procs[r].returncode}: " + " | ".join(said), flush=True)
        if procs[r].returncode:
            print("\n".join(text[-40:]), flush=True)
    return [p.returncode for p in procs]


FAULTS = ("unsynced-bn", "summed-grads")
FS_FAULTS = ("autograd-grad", "local-norm", "unsynced-bn")
TP_FAULTS = ("bias-twice", "unsummed-sp")
PP_FAULTS = ("no-input-sum", "stored-depth-stages")


def plant_pp(fault: str) -> None:
    """Plant ``fault`` (PP_FAULTS) in parallel/pp.py."""
    from vitlens_tpu_torch.parallel import pp as PP

    if fault == "no-input-sum":
        PP.axis_copy = lambda x, group: x
    elif fault == "stored-depth-stages":
        def stored(layers, first, n_stages, stage):
            per = layers // n_stages
            return range(max(first, stage * per), (stage + 1) * per)

        PP.stage_blocks = stored
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {PP_FAULTS}")


def plant_tp(fault: str) -> None:
    """Plant ``fault`` (TP_FAULTS) in the split blocks' forward
    (models/layers.py), from phase 4tp (b)'s steps on."""
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as CS
    from vitlens_tpu_torch.models import layers as L

    forward = L.ResBlock.model_axis_forward
    if fault == "bias-twice":
        def planted(self, x, mask=None, sp=None):
            if self.tp is None:
                return forward(self, x, mask, sp)
            b = self.attn.out_b
            keep = b.detach().clone()
            with torch.no_grad():
                b.mul_(self.tp.model + 1)
            try:
                return forward(self, x, mask, sp)
            finally:
                with torch.no_grad():
                    b.copy_(keep)
    elif fault == "unsummed-sp":
        copy = L.model_copy

        def planted(self, x, mask=None, sp=None):
            if sp is None:
                return forward(self, x, mask, sp)
            lns = {id(t) for m in (self.ln_1, self.ln_2)
                   for t in (m.scale, m.bias)}
            L.model_copy = lambda t, mesh: t if id(t) in lns else copy(t, mesh)
            try:
                return forward(self, x, mask, sp)
            finally:
                L.model_copy = copy
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {TP_FAULTS}")
    step = CS.tp_step

    def planted_step(*a, **k):
        L.ResBlock.model_axis_forward = planted
        return step(*a, **k)

    CS.tp_step = planted_step


def plant_fsdp(fault: str) -> None:
    """Plant ``fault`` (FS_FAULTS) in the FSDP step of train/step.py."""
    import torch

    from vitlens_tpu_torch.parallel import fsdp as F
    from vitlens_tpu_torch.train import step as S

    if fault == "autograd-grad":
        backward = S._backward_grads
        S._backward_grads = lambda loss, params: (
            S._grads if any(F.shard_axis(p) is not None
                            for p in params.values()) else backward)(
                                loss, params)
    elif fault == "local-norm":
        S.sharded_norm = lambda grads, mesh: torch.sqrt(sum(
            F.local_tensor(g).float().square().sum() for g in grads.values()))
    elif fault == "unsynced-bn":
        synced = S.batch_norm_synced
        S.batch_norm_synced = lambda model, mesh: synced(
            model, None if F.fsdp_units(model) else mesh)
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FS_FAULTS}")


def plant_rank(fault: str, out_dir: str) -> int:
    """A rank of phase 4dp (b) with ``fault`` planted in the train step
    (``fsdp:<fault>``: in the FSDP step alone)."""
    sys.path.insert(0, REPO)
    import chip_smoke as CS
    from vitlens_tpu_torch.train import step as S

    if fault.startswith("tp:"):
        plant_tp(fault[len("tp:"):])
        return CS.tp_rank_main(out_dir)
    if fault.startswith("pp:"):
        plant_pp(fault[len("pp:"):])
        return CS.pp_rank_main(out_dir)
    if fault.startswith("fsdp:"):
        plant_fsdp(fault[len("fsdp:"):])
    elif fault == "unsynced-bn":
        synced = S.batch_norm_synced
        S.batch_norm_synced = lambda model, mesh: synced(model, None)
    elif fault == "summed-grads":
        average = S.average_gradients_

        def summed(grads, mesh):
            average(grads, mesh)
            for g in grads.values():
                g.mul_(mesh.data)
            return grads

        S.average_gradients_ = summed
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    return CS.dp_rank_main(out_dir)


def plant_main(faults=FAULTS, prefix="") -> int:
    """Phase 4dp (b) (with ``prefix`` "fsdp:", its 4fs (b); with "tp:",
    phase 4tp; with "pp:", phase 4pp) under each of ``faults``: 0 when
    every one fails it on its checks (a rank that crashes catches
    nothing)."""
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as CS
    from vitlens_tpu_torch.ops import _build

    t0 = time.time()
    _build.library()
    card = CS.card_line()
    print(f"{card} | torch {torch.__version__} cuda {torch.version.cuda}; "
          f"kernels built in {time.time() - t0:.1f} s", flush=True)
    phase = {"": "4dp (b)", "fsdp:": "4fs (b)", "tp:": "4tp", "pp:": "4pp"}[prefix]
    run_phase = {"tp:": CS.tp_ranks_phase, "pp:": CS.pp_ranks_phase}.get(
        prefix, CS.dp_ranks_phase)
    passed = []
    for fault in faults:
        t = time.time()
        try:
            run_phase(torch, dict.fromkeys(CS.COUNTED, 0), card,
                      rank_argv=[sys.executable, os.path.abspath(__file__),
                                 "--plant-rank", prefix + fault])
        except SystemExit as e:
            if not any(w in str(e) for w in ("exited", "ran out",
                                             "exit codes")):
                print(f"[plant {fault}] {card} | phase {phase} failed, as it "
                      f"must ({time.time() - t:.1f} s): {e}", flush=True)
                continue
            print(f"[plant {fault}] {card} | phase {phase} did not run to "
                  f"its checks: {e}", flush=True)  # a crash catches nothing
        passed.append(fault)
        print(f"[plant {fault}] {card} | phase {phase} PASSED with the fault "
              f"planted", flush=True)
    print(f"[done] faults the phase let through or crashed on: "
          f"{passed or 'none'}; "
          f"{time.time() - t0:.1f} s", flush=True)
    return 1 if passed else 0


def tp_main() -> int:
    """The gloo probe, then phase 4tp as chip_smoke.py runs it."""
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as CS
    from vitlens_tpu_torch.ops import _build

    t0 = time.time()
    _build.library()
    card = CS.card_line()
    print(f"{card} | torch {torch.__version__} cuda {torch.version.cuda}; "
          f"kernels built in {time.time() - t0:.1f} s", flush=True)
    if run_probe("gloo") != [0, 0]:
        CS.fail("gloo collectives on CUDA tensors")
    totals = dict.fromkeys(CS.COUNTED, 0)
    tp_s = CS.tp_ranks_phase(torch, totals, card)
    print(f"[done] {card} | phase 4tp {tp_s:.1f} s; launches {totals}; "
          f"{time.time() - t0:.1f} s", flush=True)
    return 0


def pp_main() -> int:
    """The point-to-point probe, then phase 4pp in four rank processes of
    its own. The hop's gloo route (``parallel.pp``) is the staged one: the
    probe must find it correct; the direct ops' answers are printed."""
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as CS
    from vitlens_tpu_torch.ops import _build

    t0 = time.time()
    _build.library()
    card = CS.card_line()
    print(f"{card} | torch {torch.__version__} cuda {torch.version.cuda}; "
          f"kernels built in {time.time() - t0:.1f} s", flush=True)
    said = {op: run_probe("pp", op) for op in PP_OPS}
    print(f"[probe pp] {card} | exit codes a rank: {said}", flush=True)
    if said["staged"] != [0, 0]:
        CS.fail("gloo point-to-point staged through the host")
    totals = dict.fromkeys(CS.COUNTED, 0)
    pp_s = CS.pp_ranks_phase(torch, totals, card)
    print(f"[done] {card} | phase 4pp {pp_s:.1f} s; launches {totals}; "
          f"{time.time() - t0:.1f} s", flush=True)
    return 0


def lora_main(fsdp: bool = True, tp: bool = True) -> int:
    """The probes, then the LoRA sub-phases of 4fs (b) (``fsdp``) and of
    4tp (b) and 4pp (c) (``tp``) as chip_smoke.py runs them."""
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as CS
    from vitlens_tpu_torch.ops import _build

    t0 = time.time()
    _build.library()
    card = CS.card_line()
    print(f"{card} | torch {torch.__version__} cuda {torch.version.cuda}; "
          f"kernels built in {time.time() - t0:.1f} s", flush=True)
    if run_probe("gloo") != [0, 0]:
        CS.fail("gloo collectives on CUDA tensors")
    if fsdp and run_probe("fsdp") != [0, 0]:
        CS.fail("FSDP2 over gloo on CUDA tensors")
    totals = dict.fromkeys(CS.COUNTED, 0)
    if fsdp:
        t = time.time()
        CS.dp_ranks_phase(torch, totals, card, lora_only=True)
        print(f"[4fs lora] {card} | {time.time() - t:.1f} s", flush=True)
    if tp:
        t = time.time()
        CS.tp_ranks_phase(torch, totals, card, lora_only=True)
        print(f"[4tp, 4pp lora] {card} | {time.time() - t:.1f} s", flush=True)
    print(f"[done] {card} | launches {totals}; {time.time() - t0:.1f} s",
          flush=True)
    return 0


def main(fsdp: bool = False) -> int:
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as CS
    from vitlens_tpu_torch.ops import _build

    t0 = time.time()
    _build.library()
    card = CS.card_line()
    print(f"{card} | torch {torch.__version__} cuda {torch.version.cuda}; "
          f"kernels built in {time.time() - t0:.1f} s", flush=True)
    if not fsdp:
        run_probe("nccl")
    if run_probe("gloo") != [0, 0]:
        CS.fail("gloo collectives on CUDA tensors")
    if fsdp and run_probe("fsdp") != [0, 0]:
        CS.fail("FSDP2 over gloo on CUDA tensors")

    from vitlens_tpu_torch.factory import create_model, make_trainable_
    from vitlens_tpu_torch.train.freeze import tri_model_mask
    from vitlens_tpu_torch.train.step import (OptimizerConfig, StepConfig,
                                              init_train_state, make_optimizer)

    counters = CS.launch_counters()
    totals = dict.fromkeys(counters, 0)
    model = create_model("ViT-L-14", "audio", seed=CS.SEED, device="cuda",
                         dtype=torch.float32)
    mask = tri_model_mask(model, model.cfg, lock_visual=True, lock_text=True,
                          unlock_cls=True)
    tx, mask = make_optimizer(model, OptimizerConfig(
        lr=1e-4, warmup=10, total_steps=1000, grad_clip_norm=1.0), mask)
    make_trainable_(model, mask, torch.bfloat16)
    state = init_train_state(model, tx)
    acfg = model.cfg.tower
    rng = np.random.RandomState(CS.SEED)

    def batch(b):
        text = rng.randint(1, 49000, size=(b, 77))
        text[:, 0], text[:, -1] = 49406, 49407
        fb = rng.randn(b, acfg.audio.target_length, acfg.audio.mel_bins) * 0.5
        return {"text": torch.from_numpy(text).long(),
                "visual": torch.from_numpy(fb.astype(np.float32))}

    sc = StepConfig(n_tower=2, align_to="text", compute_dtype=torch.bfloat16)
    fs_a = CS.dp_nccl_phase(torch, np, counters, totals, model, state, tx, mask,
                            sc, batch)
    del model, state
    fs_bc = CS.dp_ranks_phase(torch, totals, card)
    print(f"[4fs] {card} | phase 4fs {fs_a + fs_bc:.1f} s: (a) {fs_a:.1f} s, "
          f"(b) and (c) {fs_bc:.1f} s in the rank processes", flush=True)
    if not fsdp:
        CS.dp_encode_phase(torch, np, counters, totals, card)
    print(f"[done] {card} | launches {totals}; {time.time() - t0:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:3] == ["--probe", "fsdp"]:
        sys.exit(probe_fsdp())
    if sys.argv[1:3] == ["--probe", "pp"]:
        sys.exit(probe_pp(sys.argv[3]))
    if sys.argv[1:2] == ["--probe"]:
        sys.exit(probe(sys.argv[2]))
    if sys.argv[1:2] == ["--plant-rank"]:
        sys.exit(plant_rank(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--plant"]:
        sys.exit(plant_main())
    if sys.argv[1:2] == ["--lora"]:
        sys.exit(lora_main())
    if sys.argv[1:3] == ["--fsdp", "--lora"]:
        sys.exit(lora_main(tp=False))
    if sys.argv[1:3] in (["--tp", "--lora"], ["--pp", "--lora"]):
        sys.exit(lora_main(fsdp=False))
    if sys.argv[1:3] == ["--fsdp", "--plant"]:
        sys.exit(plant_main(tuple(sys.argv[3:]) or FS_FAULTS, "fsdp:"))
    if sys.argv[1:2] == ["--fsdp"]:
        sys.exit(main(fsdp=True))
    if sys.argv[1:3] == ["--tp", "--plant"]:
        sys.exit(plant_main(tuple(sys.argv[3:]) or TP_FAULTS, "tp:"))
    if sys.argv[1:2] == ["--tp"]:
        sys.exit(tp_main())
    if sys.argv[1:3] == ["--pp", "--plant"]:
        sys.exit(plant_main(tuple(sys.argv[3:]) or PP_FAULTS, "pp:"))
    if sys.argv[1:2] == ["--pp"]:
        sys.exit(pp_main())
    sys.exit(main())
