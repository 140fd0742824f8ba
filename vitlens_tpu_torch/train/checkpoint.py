"""Checkpoint save/resume (port of vitlens_tpu/train/checkpoint.py).

The directory policy is the JAX package's, step for step (reference
audio_main.py:119-185, :404-437, :564-611): per-epoch ``epoch_N``
checkpoints (or a ``tag`` such as ``preempt_step_N``) with a ``meta.json``
of ``epoch``, ``extra`` and ``best_metric``; ``epoch_latest`` copied to a tmp
directory and renamed over the old one; ``checkpoint_best`` with
``best.json`` kept while the summed val metric improves; resume from the
newest of ``epoch_latest`` and a ``latest.json`` pointer (by mtime), else the
highest ``epoch_N``; ``load_checkpoint(ckpt_only=True)`` restores the weights
only (--resume-ckpt-only); an ``AsyncSaver`` that writes on one worker thread
and re-raises a failed save; and ``start_remote_sync``.

The serialization is the port's own: one ``tree.pt`` per checkpoint, written
with ``torch.save``, of plain CPU tensors. A ``TrainState`` is saved as
``{"params": {name: tensor}, "model_state": {buffer name: tensor},
"opt_state": {"count": int, "mu": {name: tensor}, "nu": {...}}, "step":
int}``: the model's parameters (trainable fp32 masters and frozen weights in
their stored dtype), its buffers (BatchNorm statistics), the AdamW moments
and the step. JAX's checkpoints are orbax trees, and orbax needs JAX, so the
port neither reads nor writes them. A data-parallel run's state is
replicated: its rank 0 writes it, and the trainer's other ranks wait at a
barrier for the write before any of them reads it back.

An FSDP state (``parallel.fsdp.fsdp_place``) is saved collectively
(``save_checkpoint_sharded``, ``save_best_sharded``): the same tree, written
with ``torch.distributed.checkpoint`` (DCP), every rank writing its own
shards and rank 0 the replicated tensors, with no gather; rank 0 writes
``meta.json`` (``"sharded": true``) and a ``latest.json`` pointer (tmp +
rename) in place of a copy to ``epoch_latest``. ``load_checkpoint_sharded``
restores onto the target's placements: a placed state of any number of
ranks, or a whole state in one process (DCP reshards on read, as orbax does
for JAX). A 2D state's TP slices (``parallel.fsdp.fsdp_tp_place``) are
written whole, in JAX's packed-qkv layout (gathered over the model axis at
save, ``parallel.tp.gather_whole``), and cut to each rank's slice again at
load, so the checkpoint is the same tree whatever the layout of its run.
"""

from __future__ import annotations

import glob
import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional

import torch

from vitlens_tpu_torch.train.step import TrainState

TREE_FILE = "tree.pt"


def _ckpt_path(root: str, tag: str) -> str:
    return os.path.join(root, tag)


def snapshot(state: Any) -> Any:
    """A host copy of ``state`` (a TrainState, or a nested dict of tensors
    and numbers) as a tree of CPU tensors, decoupled from the live state:
    the caller takes it synchronously and a saver may write it later."""
    if isinstance(state, TrainState):
        model = state.model
        return {
            "params": {n: p.detach().to("cpu", copy=True)
                       for n, p in model.named_parameters()},
            "model_state": {n: b.detach().to("cpu", copy=True)
                            for n, b in model.named_buffers() if b is not None},
            "opt_state": snapshot(state.opt_state),
            "step": int(state.step),
        }
    if isinstance(state, dict):
        return {k: snapshot(v) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    return state


def save_checkpoint(
    root: str,
    state: Any,
    epoch: int,
    *,
    is_latest: bool = True,
    best_metric: Optional[float] = None,
    extra: Optional[Dict] = None,
    tag: Optional[str] = None,
) -> str:
    """Save ``state`` (a TrainState or its :func:`snapshot`) under
    epoch_{N} (or ``tag``, e.g. a mid-epoch preemption snapshot); update
    epoch_latest atomically via tmp+rename (audio_main.py:590-597). Its
    files are hard links to epoch_{N}'s where the filesystem allows (a
    checkpoint's files are replaced, never rewritten in place), else
    copies."""
    os.makedirs(root, exist_ok=True)
    path = _ckpt_path(root, tag or f"epoch_{epoch}")
    _save_tree(path, state)
    meta = {"epoch": epoch, "extra": extra or {}}
    if best_metric is not None:
        meta["best_metric"] = best_metric
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    if is_latest:
        tmp = _ckpt_path(root, "epoch_latest.tmp")
        latest = _ckpt_path(root, "epoch_latest")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        shutil.copytree(path, tmp, copy_function=_link_or_copy)
        if os.path.exists(latest):
            shutil.rmtree(latest)
        os.replace(tmp, latest)
    return path


def _link_or_copy(src: str, dst: str) -> None:
    try:
        os.link(src, dst)
    except OSError:  # no hard links here (another device, a FAT volume)
        shutil.copy2(src, dst)


def save_best(root: str, state: Any, epoch: int, metric: float) -> Optional[str]:
    """Keep checkpoint_best if ``metric`` improves (audio_main.py:599-611)."""
    best_meta = os.path.join(root, "best.json")
    prev = -float("inf")
    if os.path.exists(best_meta):
        with open(best_meta) as f:
            prev = json.load(f)["metric"]
    if metric <= prev:
        return None
    path = _ckpt_path(root, "checkpoint_best")
    if os.path.exists(path):
        shutil.rmtree(path)
    _save_tree(path, state)
    with open(best_meta, "w") as f:
        json.dump({"metric": metric, "epoch": epoch}, f)
    return path


def get_latest_checkpoint(root: str) -> Optional[str]:
    """Newest epoch checkpoint (reference get_latest_checkpoint
    audio_main.py:63-83): epoch_latest or the latest.json pointer if present
    (whichever was written last), else the highest epoch_N."""
    cands_marked = []
    latest = _ckpt_path(root, "epoch_latest")
    if os.path.isdir(latest):
        cands_marked.append((os.path.getmtime(latest), latest))
    pointer = os.path.join(root, "latest.json")
    if os.path.exists(pointer):
        with open(pointer) as f:
            p = os.path.join(root, json.load(f)["tag"])
        if os.path.isdir(p):
            cands_marked.append((os.path.getmtime(pointer), p))
    if cands_marked:
        return max(cands_marked)[1]
    cands = []
    for p in glob.glob(os.path.join(root, "epoch_*")):
        m = re.match(r".*epoch_(\d+)$", p)
        if m:
            cands.append((int(m.group(1)), p))
    return max(cands)[1] if cands else None


def load_checkpoint(path: str, target: Any, *, ckpt_only: bool = False) -> Any:
    """Restore a checkpoint written by save_checkpoint into ``target``.

    A TrainState is restored in place (each tensor copied into the live
    one, cast to its dtype) and returned; with ``ckpt_only=True`` only the
    model's parameters and buffers (--resume-ckpt-only), not the optimizer
    state or the step. Any other target (a nested dict of tensors) is
    returned as a new tree of the loaded tensors, each cast to its target's
    dtype and device. An ``nn.Module`` target takes a ``{"params": {name:
    tensor}, "state": {buffer name: tensor}}`` checkpoint (the OpenShape
    trainer's, which holds no optimizer state) in place, every parameter
    and buffer present."""
    raw = torch.load(os.path.join(path, TREE_FILE), map_location="cpu",
                     weights_only=True)
    if isinstance(target, torch.nn.Module):
        with torch.no_grad():
            for kind, live in (("params", target.named_parameters()),
                               ("state", target.named_buffers())):
                for name, t in live:
                    if name not in raw[kind]:
                        raise KeyError(f"checkpoint missing leaf {kind}.{name!r}")
                    t.copy_(raw[kind][name])
        return target
    if not isinstance(target, TrainState):
        return _graft(raw, target, "")
    model = target.model
    with torch.no_grad():
        for kind, live in (("params", dict(model.named_parameters())),
                           ("model_state", dict(model.named_buffers()))):
            for name, t in live.items():
                if t is None:
                    continue
                if name not in raw[kind]:
                    raise KeyError(f"checkpoint missing leaf {kind}.{name!r}")
                t.copy_(raw[kind][name])
    if not ckpt_only:
        opt = target.opt_state
        for moment in ("mu", "nu"):
            for name, t in opt[moment].items():
                if name not in raw["opt_state"][moment]:
                    raise KeyError(f"checkpoint missing leaf "
                                   f"opt_state.{moment}.{name!r}")
                with torch.no_grad():
                    t.copy_(raw["opt_state"][moment][name])
        opt["count"] = int(raw["opt_state"]["count"])
        target.step = int(raw["step"])
    return target


def _graft(raw: Any, target: Any, key: str) -> Any:
    if isinstance(target, dict):
        if not isinstance(raw, dict):
            raise KeyError(f"checkpoint has no subtree {key!r}")
        out = {}
        for k, v in target.items():
            if k not in raw:
                raise KeyError(f"checkpoint missing leaf {key + str(k)!r}")
            out[k] = _graft(raw[k], v, f"{key}{k}.")
        return out
    if isinstance(target, torch.Tensor):
        return raw.to(device=target.device, dtype=target.dtype)
    return raw


def load_meta(path: str) -> Dict:
    mp = os.path.join(path, "meta.json")
    if os.path.exists(mp):
        with open(mp) as f:
            return json.load(f)
    return {}


def _save_tree(path: str, tree: Any) -> None:
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    tmp = os.path.join(path, TREE_FILE + ".tmp")
    torch.save(snapshot(tree) if isinstance(tree, TrainState) else tree, tmp)
    os.replace(tmp, os.path.join(path, TREE_FILE))


# ---------------------------------------------------------------------------
# distributed (sharded, collective) checkpointing
# ---------------------------------------------------------------------------


def _live_tree(state: TrainState) -> Dict[str, Any]:
    """The state's tree of live tensors (a sharded parameter's or moment's
    ``DTensor``, a plain tensor otherwise; the counts as 0-dim tensors) for
    DCP to write from or read into."""
    from vitlens_tpu_torch.parallel.fsdp import reshard_

    if not isinstance(state, TrainState):
        raise TypeError(f"a collective checkpoint holds a TrainState, got "
                        f"{type(state).__name__}")
    model = state.model
    reshard_(model)
    opt = state.opt_state
    return {
        "params": {n: p.detach() for n, p in model.named_parameters()},
        "model_state": {n: b for n, b in model.named_buffers()
                        if b is not None},
        "opt_state": {"count": torch.tensor(int(opt["count"])),
                      "mu": dict(opt["mu"]), "nu": dict(opt["nu"])},
        "step": torch.tensor(int(state.step)),
    }


def _split_entries(tree: Dict[str, Any], model):
    """[(subtree, name, block)] of the tree's TP slices (``parallel.tp``)."""
    from vitlens_tpu_torch.parallel.tp import split_params

    split = split_params(model)
    return [(sub, n, split[n])
            for sub in (tree["params"], tree.get("opt_state", {}).get("mu", {}),
                        tree.get("opt_state", {}).get("nu", {}))
            for n in sub if n in split]


def _collective_save(path: str, state: TrainState) -> None:
    """DCP save of ``state`` into ``path`` (replaced): every process calls
    it; each writes its own shards, a TP slice gathered whole."""
    import torch.distributed.checkpoint as dcp

    from vitlens_tpu_torch.parallel.mesh import barrier, process_index
    from vitlens_tpu_torch.parallel.tp import gather_whole

    if process_index() == 0 and os.path.exists(path):
        shutil.rmtree(path)
    tree = _live_tree(state)
    for sub, n, block in _split_entries(tree, state.model):
        sub[n] = gather_whole(n, sub[n], block)
    barrier()  # no rank writes before the old directory is gone
    dcp.save(tree, checkpoint_id=os.path.abspath(path))


def save_checkpoint_sharded(
    root: str,
    state: TrainState,
    epoch: int,
    *,
    is_latest: bool = True,
    extra: Optional[Dict] = None,
    tag: Optional[str] = None,
) -> str:
    """The collective counterpart of :func:`save_checkpoint` for a state
    sharded over processes: every rank writes its shards under epoch_{N}
    (or ``tag``); rank 0 writes ``meta.json`` with ``"sharded": true`` and,
    with ``is_latest``, points ``latest.json`` at it (a pointer, not a copy:
    tmp + rename). ``root`` must be visible to every process. COLLECTIVE:
    every process calls it with its part of the same state."""
    from vitlens_tpu_torch.parallel.mesh import process_index

    os.makedirs(root, exist_ok=True)
    path = _ckpt_path(root, tag or f"epoch_{epoch}")
    _collective_save(path, state)
    if process_index() == 0:
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"epoch": epoch, "extra": extra or {}, "sharded": True}, f)
        if is_latest:
            tmp = os.path.join(root, "latest.json.tmp")
            with open(tmp, "w") as f:
                json.dump({"tag": os.path.basename(path)}, f)
            os.replace(tmp, os.path.join(root, "latest.json"))
    return path


def save_best_sharded(root: str, state: TrainState, epoch: int,
                      metric: float) -> Optional[str]:
    """:func:`save_best` for a state sharded over processes. Rank 0 alone
    reads and writes best.json; its decision is broadcast, so that every
    rank enters the collective save or none does."""
    from vitlens_tpu_torch.parallel.mesh import broadcast_object, process_index

    best_meta = os.path.join(root, "best.json")
    improved = None
    if process_index() == 0:
        prev = -float("inf")
        if os.path.exists(best_meta):
            with open(best_meta) as f:
                prev = json.load(f)["metric"]
        improved = bool(metric > prev)
    if not broadcast_object(improved):
        return None
    os.makedirs(root, exist_ok=True)
    path = _ckpt_path(root, "checkpoint_best")
    _collective_save(path, state)
    if process_index() == 0:
        with open(best_meta, "w") as f:
            json.dump({"metric": metric, "epoch": epoch}, f)
    return path


def load_checkpoint_sharded(path: str, target: TrainState, *,
                            ckpt_only: bool = False) -> TrainState:
    """Restore a collective checkpoint into ``target`` in place, onto its
    placements: a state placed by ``fsdp_place`` (after the placement, as
    in JAX) or a whole state, each rank reading what it holds; with
    ``ckpt_only=True`` the parameters and buffers only. COLLECTIVE when a
    process group is up: every process calls it."""
    import torch.distributed.checkpoint as dcp

    from vitlens_tpu_torch.parallel.tp import local_of, split_axis

    tree = _live_tree(target)
    if ckpt_only:
        tree = {"params": tree["params"], "model_state": tree["model_state"]}
    split = _split_entries(tree, target.model)
    live = {}
    for sub, n, block in split:  # read whole, then cut to this rank's slice
        live[id(sub), n] = t = sub[n]
        shape = list(t.shape)
        shape[split_axis(n)] *= block.tp.model
        sub[n] = t.new_empty(shape)
    dcp.load(tree, checkpoint_id=os.path.abspath(path))
    with torch.no_grad():
        for sub, n, block in split:
            live[id(sub), n].copy_(local_of(n, sub[n], block))
    if not ckpt_only:
        target.opt_state["count"] = int(tree["opt_state"]["count"])
        target.step = int(tree["step"])
    return target


# ---------------------------------------------------------------------------
# async saving
# ---------------------------------------------------------------------------


class AsyncSaver:
    """Overlap checkpoint disk writes with training.

    The caller takes the host snapshot (:func:`snapshot`, which decouples
    it from the parameters the next step updates in place); the write and
    the latest/best bookkeeping run on ONE background worker, so writes stay
    strictly ordered (epoch_N before epoch_N+1, best.json reads see prior
    writes). ``wait()`` and ``close()`` re-raise the first failed save (a
    silently dropped checkpoint must not look like a saved one)."""

    def __init__(self):
        import queue

        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            fn = self._q.get()
            if fn is None:
                self._q.task_done()
                return
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 - reported at wait()
                if self._err is None:
                    self._err = e
            finally:
                self._q.task_done()

    def submit(self, fn) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise err
        self._q.put(fn)

    def wait(self) -> None:
        """Block until every submitted save has finished."""
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._q.join()


# ---------------------------------------------------------------------------
# remote sync (reference file_utils.py:11-60)
# ---------------------------------------------------------------------------


def start_remote_sync(local_dir: str, remote_dir: str,
                      frequency_s: float = 300.0,
                      exclude: str = "epoch_latest") -> threading.Event:
    """Background mirror of the checkpoint dir to a remote fsspec location
    every ``frequency_s`` seconds, excluding the fast-churn latest
    checkpoint. Returns a stop Event."""
    stop = threading.Event()

    def sync_once():
        try:
            import fsspec

            fs, root = fsspec.core.url_to_fs(remote_dir)
            for dirpath, _dirs, files in os.walk(local_dir):
                if exclude and exclude in dirpath:
                    continue
                rel = os.path.relpath(dirpath, local_dir)
                for fn in files:
                    src = os.path.join(dirpath, fn)
                    dst = os.path.join(root, rel, fn) if rel != "." else os.path.join(root, fn)
                    fs.makedirs(os.path.dirname(dst), exist_ok=True)
                    fs.put(src, dst)
            return True
        except Exception:
            return False

    def loop():
        while not stop.wait(frequency_s):
            sync_once()
        sync_once()  # final sync (reference audio_main.py:617-628)

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    return stop
