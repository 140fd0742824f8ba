"""The torch thread counts of the port's tests on the CPU.

torch's intra-op pool takes one OpenMP thread a core in every process. Under
pytest-xdist each worker is such a process, so six workers on an 8-core host
ran 48 threads that spin while they wait, beside JAX's own pool; six
processes of tests/test_torch_api.py's encodes took 233 s at torch's default
and 88 s at one thread each. Every port test module calls
:func:`share_cores` at import: the worker's torch takes its share of the
cores. A run without xdist keeps torch's default. The processes the tests
start (gloo ranks, CLI children) take :func:`child_threads` through
``OMP_NUM_THREADS``.
"""

import os

import torch


def cores() -> int:
    """The cores this process may run on."""
    return len(os.sched_getaffinity(0))


def workers(env=None) -> int:
    """pytest-xdist's worker count (0 outside xdist)."""
    env = os.environ if env is None else env
    return int(env.get("PYTEST_XDIST_WORKER_COUNT") or 0)


def worker_threads(env=None, n_cores=None):
    """A worker's share of the cores (at least 1), or None outside xdist."""
    n = workers(env)
    return max(1, (n_cores or cores()) // n) if n else None


def child_threads(procs=1, env=None, n_cores=None) -> int:
    """Threads for each of ``procs`` processes a test starts and waits on:
    they share the cores with the other workers, the starting one being
    idle while it waits (at least 1)."""
    others = max(workers(env) - 1, 0)
    return max(1, (n_cores or cores()) // (others + procs))


def child_env(procs=1, env=None) -> dict:
    """``os.environ`` (updated with ``env``) with OMP_NUM_THREADS set to
    :func:`child_threads`, less xdist's worker count: a child that imports
    a port test module (a rank) keeps that count."""
    out = dict(os.environ, **(env or {}))
    out.pop("PYTEST_XDIST_WORKER_COUNT", None)
    out["OMP_NUM_THREADS"] = str(child_threads(procs))
    return out


def share_cores():
    """Bound this process's torch threads to its worker's share; returns
    the count set (None: left at torch's default)."""
    n = worker_threads()
    if n is not None and torch.get_num_threads() != n:
        torch.set_num_threads(n)
    return n


share_cores()


def test_worker_share_fits_the_host():
    """Six workers on 8 cores take one thread each, two on 8 take four; a
    worker never gets 0; outside xdist nothing is set."""
    assert worker_threads({"PYTEST_XDIST_WORKER_COUNT": "6"}, 8) == 1
    assert worker_threads({"PYTEST_XDIST_WORKER_COUNT": "2"}, 8) == 4
    assert worker_threads({"PYTEST_XDIST_WORKER_COUNT": "16"}, 8) == 1
    assert worker_threads({}, 8) is None


def test_children_fit_beside_the_other_workers():
    """Four gloo ranks beside five other workers on 8 cores: one thread
    each; four ranks alone on 8 cores: two; one child of a lone process:
    every core."""
    six = {"PYTEST_XDIST_WORKER_COUNT": "6"}
    assert child_threads(4, six, 8) == 1
    assert child_threads(2, six, 8) == 1
    assert child_threads(4, {}, 8) == 2
    assert child_threads(1, {}, 8) == 8
    env = child_env(2, {"A": "1"})
    assert env["OMP_NUM_THREADS"] == str(child_threads(2)) and env["A"] == "1"
    assert "PYTEST_XDIST_WORKER_COUNT" not in env


def test_this_worker_is_bounded():
    """Under xdist this process's torch runs at its share."""
    n = worker_threads()
    assert n is None or torch.get_num_threads() == n
