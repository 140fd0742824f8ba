"""The port's DP train step on the CPU over two gloo ranks against JAX's
``shard_map`` DP step on two virtual CPU devices, for the pc tri step with
synced BatchNorm (the ranks given JAX's FPS starts, folded with the rank)
and the video distill-tokens step, with ``local_loss`` on and off: the
machinery and the bars of test_torch_parallel.py (``check_dp_step``), in a
file of their own so that its JAX compiles run beside that file's.
test_torch_parallel_accum.py runs accum_freq 2 the same way."""

import os
import pickle
import sys

import pytest

from tests import test_torch_parallel as TP
from tests.test_torch_threads import share_cores

share_cores()

HERE = ("pc_sync_bn", "video_distill")
CASES = TP.cases_of(HERE)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(plan, JAX's results, [rank 0's, rank 1's]) for this file's cases."""
    root = tmp_path_factory.mktemp("parallel_pc_video")
    plans, jax_in = TP._step_plans(HERE)
    plan = {"steps": plans}
    with open(root / "plan.pkl", "wb") as f:
        pickle.dump(plan, f)
    ranks = TP.start_ranks([sys.executable, os.path.abspath(TP.__file__),
                            str(root / "plan.pkl"), str(root)], str(root))
    try:
        jax_out = {"steps": TP._jax_steps(jax_in)}
    finally:
        TP.wait_ranks(*ranks)
    got = []
    for r in range(TP.WORLD):
        with open(root / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return plan, jax_out, got


@pytest.mark.parametrize("name,local", CASES,
                         ids=[TP._case_name(n, l) for n, l in CASES])
def test_dp_step_matches_jax_shard_map(run, name, local):
    """The DP step against JAX's shard_map DP step, to check_dp_step's
    bars (the pc case's BatchNorm running statistics, synced, too)."""
    TP.check_dp_step(run, name, local)
