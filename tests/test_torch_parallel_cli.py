"""The port's data-parallel entry points on the CPU:

- ``parallel.mesh``'s environment discovery (torchrun's and SLURM's
  variables, the SLURM node-list parse, the loud refusals), mirroring
  tests/test_multihost.py, and the mesh constructors; no process group;
- two gloo ranks (one pair of processes for every case below; the ranks
  write their results to files, the parent compares):
  * the trainer's eval over the mesh (each rank encodes its slice of every
    batch, the features gather) equals one process's eval, mirroring
    tests/test_eval_sharded.py (7 samples in batches of 3: pads and trims);
  * ``cli.train`` for 2 steps at --batch-size 2 a rank: both ranks agree on
    the run name (no --name: a timestamp), rank 0 alone writes the
    checkpoints, results and out.log (rank 1 its out.rank1.log), and the
    logged loss and grad_norm equal one process's run at --batch-size 4,
    1e-5 relative;
  * ``cli.train_openshape`` (a PointNet bind, synced BatchNorm) for 2
    steps at 2 objects a rank against one process at 4, the same way;
- ``ViTLens(mesh=make_mesh(devices=["cpu", "cpu"]))`` row for row against
  one device (the image, text and 4-D audio clip paths; odd row counts
  pad), mirroring tests/test_api.py's mesh test, 2e-6 absolute;
- the served path over the ``--data-parallel 2 --device cpu`` mesh against
  one device (the infer CLI's run with it: test_torch_infer_export_hub.py).

Run this file as a script (``python tests/test_torch_parallel_cli.py PLAN
OUT``, torchrun's variables set) to run one rank.
"""

import json
import os
import pickle
import sys
import threading

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tests.test_torch_parallel import WORLD, start_ranks, wait_ranks  # noqa: E402
from tests.test_torch_threads import cores, share_cores  # noqa: E402

share_cores()


class _SavesCounted:
    """Counts the calls of ``train.checkpoint.save_checkpoint``."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **k):
        self.calls += 1
        return self.fn(*a, **k)


def _fake_eval_ds(cfg, n=7, seed=0):
    """An EEG val set of ``n`` samples (tests/test_eval_sharded.py's)."""
    e = cfg.tower.eeg
    rng = np.random.RandomState(seed)
    data = rng.randn(n, e.chans, e.time_len).astype(np.float32)
    labels = (np.arange(n) % 2).astype(np.int64)

    class FakeDS:
        eval_metric = "acc"
        classnames = ["alpha", "beta"]
        templates = ["a photo of {}."]

        def __len__(self):
            return n

        def __getitem__(self, i):
            return {"id": i, "eeg": data[i], "label": int(labels[i])}

    return FakeDS()


def _eval(mesh=None):
    """The trainer's zero-shot eval of the seeded tiny EEG model on the
    fake val set."""
    from vitlens_tpu_torch.cli import train as T
    from vitlens_tpu_torch.cli.args import TrainArgs

    args = TrainArgs(modality="eeg", model="ViT-Tiny-Test", val_data="fake",
                     precision="fp32", batch_size=3, workers=1, device="cpu")
    cfg, tok, model, _ = T.build_model(args, torch.device("cpu"))
    saved = T._build_real_dataset
    T._build_real_dataset = lambda args, spec, train, cfg=None: _fake_eval_ds(cfg)
    try:
        return T.evaluate(args, model, cfg, tok, mesh=mesh)["fake"]
    finally:
        T._build_real_dataset = saved


class _PerObjectRNG:
    """The dataset's RNG, drawing from a RandomState seeded with the index
    of the object that the calling loader thread is loading."""

    def __init__(self):
        self.local = threading.local()

    def __getattr__(self, name):
        return getattr(self.local.rs, name)


def _unaugmented(OS):
    """OpenShapeTripletDataset without its random rotation and rgb drop,
    and with each object's point sample drawn from the object's index: each
    object is then the same, point order included, on a rank as in one
    process, whatever loader thread loads it. The dataset's own RNG gives
    each loader thread a stream of its own, so which thread loads an object
    (the machine's load decides) would pick its point order, and the
    synced BatchNorm's sums over points round by that order."""
    class Plain(OS.OpenShapeTripletDataset):
        def __init__(self, *a, **k):
            super().__init__(*a, **dict(k, augment=False))
            self.rng = _PerObjectRNG()

        def __getitem__(self, idx):
            self.rng.local.rs = np.random.RandomState(idx)
            return super().__getitem__(idx)

    return Plain


def _openshape(argv):
    from vitlens_tpu_torch.cli import train_openshape as PCLI

    saved = PCLI.OS.OpenShapeTripletDataset
    PCLI.OS.OpenShapeTripletDataset = _unaugmented(PCLI.OS)
    try:
        return PCLI.main(argv)
    finally:
        PCLI.OS.OpenShapeTripletDataset = saved


def _worker(plan_path, out_dir) -> int:
    from vitlens_tpu_torch.cli import train as T
    from vitlens_tpu_torch.parallel import mesh as PM
    from vitlens_tpu_torch.train import checkpoint as C

    with open(plan_path, "rb") as f:
        plan = pickle.load(f)
    rank = PM.init_distributed(device="cpu", timeout_s=120)
    mesh = PM.make_mesh()
    rows = torch.arange(10.0).reshape(5, 2)
    res = {"eval": _eval(mesh), "device": str(mesh.device),
           "named_device": str(PM.make_mesh(device="cpu").device),
           "mapped": PM.map_rank_rows(mesh, lambda v: v * 2 + 1, rows).numpy()}
    saves = C.save_checkpoint = _SavesCounted(C.save_checkpoint)
    assert T.main(plan["train"]) == 0
    assert _openshape(plan["openshape"]) == 0
    res["saves"] = saves.calls
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_worker(*sys.argv[1:]))


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


def _train_argv(logs, batch, *more):
    return ["--modality", "audio", "--model", "ViT-Tiny-Test", "--device", "cpu",
            "--precision", "fp32", "--n-tower", "2", "--align-to", "text",
            "--unlock-cls", "--batch-size", str(batch), "--warmup", "1",
            "--lr", "5e-4", "--log-every-n-steps", "1", "--workers", "1",
            "--dataset-type", "synthetic", "--train-data", "synthetic",
            "--train-num-samples", "8", "--epochs", "1", "--logs", str(logs),
            *more]


def _openshape_files(root):
    rng = np.random.RandomState(0)
    os.makedirs(root / "train")
    for i in range(8):
        blob = {"xyz": rng.randn(80, 3).astype(np.float32),
                "text_feat": rng.randn(1, 16).astype(np.float32),
                "img_feat": rng.randn(16).astype(np.float32)}
        if i % 2:
            blob["rgb"] = rng.rand(80, 3).astype(np.float32)
        np.save(root / "train" / f"o{i}.npy", blob)
    return str(root / "train" / "*.npy")


def _openshape_argv(files, logs, batch):
    return ["--pc-model", "PointNet", "--pc-scaling", "1", "--out-channel", "16",
            "--device", "cpu", "--npoints", "80", "--batch-size", str(batch),
            "--warmup", "1", "--log-every-n-steps", "1", "--logs", str(logs),
            "--name", "run", "--precision", "fp32", "--train-files", files,
            "--epochs", "1"]


def _records(run_dir):
    """The train records of results.jsonl: {metric: value}."""
    with open(os.path.join(run_dir, "results.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [{k[len("train/"):]: v for k, v in r.items() if k.startswith("train/")}
            for r in recs if "train/loss" in r]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Runs the two ranks and one process's counterparts. Returns (the
    ranks' results, the DP logs dir, one process's eval, its train logs
    dir, the OpenShape logs dirs (DP, one process))."""
    root = tmp_path_factory.mktemp("parallel_cli")
    files = _openshape_files(root)
    plan = {"train": _train_argv(root / "dp", 2, "--n-devices", "2"),
            "openshape": _openshape_argv(files, root / "os_dp", 2)}
    with open(root / "plan.pkl", "wb") as f:
        pickle.dump(plan, f)
    procs = start_ranks([sys.executable, os.path.abspath(__file__),
                         str(root / "plan.pkl"), str(root)], str(root / "logs"))
    # one process's runs, meanwhile, on torch's whole pool (one thread a
    # core), as in a lone process: the OpenShape run's BatchNorm variances
    # agree with the ranks' to 1.4e-5 of their max on 8 cores there and to
    # 1.2e-4 at 1 or 2 threads (the reduction order, amplified by AdamW's
    # eps of 1e-8; test_cli_train_openshape_two_ranks holds 1e-4)
    share = torch.get_num_threads()
    torch.set_num_threads(cores())
    try:
        one_eval = _eval()
        from vitlens_tpu_torch.cli import train as T

        assert T.main(_train_argv(root / "one", 4, "--name", "one")) == 0
        assert _openshape(_openshape_argv(files, root / "os_one", 4)) == 0
    finally:
        torch.set_num_threads(share)
        wait_ranks(*procs)
    got = []
    for r in range(WORLD):
        with open(root / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return got, root / "dp", one_eval, root / "one" / "one", (
        root / "os_dp" / "run", root / "os_one" / "run")


def _rel(got, want):
    return abs(got - want) / max(1e-12, abs(want))


def _rel_arr(got, want):
    return np.abs(got - want).max() / max(1e-12, np.abs(want).max())


def test_eval_over_ranks_matches_one_process(ranks):
    """accuracy, score_cnt and top1/top5 on every rank equal one process's
    (no sample counted twice: 7, not 14)."""
    got, _, want, _, _ = ranks
    for res in got:
        ev = res["eval"]
        assert ev["score_cnt"] == want["score_cnt"] == 7
        for k in ("accuracy", "top1", "top5"):
            assert ev[k] == pytest.approx(want[k]), k


def test_map_rank_rows_and_the_rank_device(ranks):
    """map_rank_rows over 2 ranks (5 rows: padded to 6, 3 a rank) gives
    every rank the whole of fn(rows); a gloo rank's mesh is on the CPU, by
    default and when named."""
    got, _, _, _, _ = ranks
    want = np.arange(10.0).reshape(5, 2) * 2 + 1
    for res in got:
        np.testing.assert_array_equal(res["mapped"], want)
        assert res["device"] == res["named_device"] == "cpu"


def test_cli_train_two_ranks(ranks):
    """The ranks agree on one run directory (its name a timestamp), rank 0
    alone writes out.log, params.txt, results.jsonl and the checkpoints
    (rank 1 logs to out.rank1.log); the per-step loss, grad_norm and
    logit_scale equal one process's at twice the batch, 1e-5 relative."""
    got, dp, _, one, _ = ranks
    runs = os.listdir(dp)
    assert len(runs) == 1, runs
    run = dp / runs[0]
    for name in ("out.log", "out.rank1.log", "params.txt", "results.jsonl"):
        assert (run / name).exists(), name
    assert not (run / "out.rank0.log").exists()
    assert [r["saves"] for r in got] == [2, 0]  # cli.train's epoch_1, OpenShape's
    assert (run / "checkpoints" / "epoch_1").is_dir()
    dp_recs, one_recs = _records(run), _records(one)
    assert len(dp_recs) == len(one_recs) == 2
    for a, b in zip(dp_recs, one_recs):
        for k in ("loss", "grad_norm", "logit_scale"):
            assert _rel(a[k], b[k]) < 1e-5, k


def test_cli_train_openshape_two_ranks(ranks):
    """2 steps of the PointNet bind at 2 objects a rank: the logged loss
    and its metrics equal one process's at 4, 1e-5 relative at the first
    step and 1e-4 at the second (the OpenShape AdamW's eps is optax's 1e-8:
    it moves an element whose gradient is fp32 rounding noise by about lr,
    as test_torch_cli_train.py's bar allows); rank 0's checkpoint holds the
    synced BatchNorm running variances one process reaches, 1e-4 of their
    max. Not the running means: the biases in front of each BatchNorm have
    a gradient that is zero in exact arithmetic, which that eps turns into
    lr-sized steps of either sign, and a mean carries its bias."""
    from vitlens_tpu_torch.train import checkpoint as C

    _, _, _, _, (dp, one) = ranks
    dp_recs, one_recs = _records(dp), _records(one)
    assert len(dp_recs) == len(one_recs) == 2
    for (a, b), tol in zip(zip(dp_recs, one_recs), (1e-5, 1e-4)):
        for k in ("loss", "text_loss", "img_loss"):
            assert _rel(a[k], b[k]) < tol, k
    t_dp = torch.load(dp / "checkpoints" / "epoch_1" / C.TREE_FILE, weights_only=True)
    t_one = torch.load(one / "checkpoints" / "epoch_1" / C.TREE_FILE,
                       weights_only=True)
    bn = [k for k in t_one["state"] if k.endswith(".var")]
    assert len(bn) == 6
    for k in bn:
        assert _rel_arr(t_dp["state"][k].numpy(), t_one["state"][k].numpy()) < 1e-4, k


# -- no process group ----------------------------------------------------------


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"WORLD_SIZE": "1"}, None),
    ({"WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "1", "MASTER_ADDR": "h0",
      "MASTER_PORT": "1234"}, ("h0:1234", 4, 2, 1)),
    ({"WORLD_SIZE": "2", "RANK": "1", "COORDINATOR_ADDRESS": "c:9"},
     ("c:9", 2, 1, 0)),
    ({"SLURM_NTASKS": "8", "SLURM_PROCID": "5", "SLURM_LOCALID": "1",
      "COORDINATOR_ADDRESS": "co:77"}, ("co:77", 8, 5, 1)),
    ({"SLURM_NTASKS": "2", "SLURM_PROCID": "0", "MASTER_ADDR": "m"},
     ("m:29500", 2, 0, 0)),
    ({"SLURM_NTASKS": "4", "SLURM_PROCID": "3", "SLURM_LOCALID": "3",
      "SLURM_STEP_NODELIST": "gpu-node[03-06,09],other"}, ("gpu-node03:29500", 4, 3, 3)),
], ids=["none", "world1", "torchrun", "coordinator", "slurm-coordinator",
        "slurm-master", "slurm-nodelist"])
def test_distributed_env_cases(env, want):
    """The run each environment describes: (address, world, rank, local
    rank), or None for one process."""
    from vitlens_tpu_torch.parallel.mesh import distributed_env

    got = distributed_env(env)
    assert (got if got is None else tuple(got)) == want


def test_distributed_env_refusals_and_nodelists():
    """WORLD_SIZE > 1 without an address or without RANK, and SLURM without
    any way to name rank 0's host, raise rather than run N single-process
    jobs; the node-list parse of JAX's SlurmCluster plugin."""
    from vitlens_tpu_torch.parallel import mesh as PM

    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        PM.distributed_env({"WORLD_SIZE": "4", "RANK": "0"})
    with pytest.raises(RuntimeError, match="RANK is not set"):
        PM.distributed_env({"WORLD_SIZE": "4", "MASTER_ADDR": "h"})
    with pytest.raises(RuntimeError, match="COORDINATOR_ADDRESS"):
        PM.distributed_env({"SLURM_NTASKS": "4", "SLURM_PROCID": "0"})
    for nodes, first in (("node[03-06]", "node03"), ("a1,b2", "a1"),
                         ("gpu-[7,9]-x", "gpu-7-x"), ("solo", "solo"),
                         ("r[1-2]n[05-08]", "r1n05"), (" x[10] ", "x10")):
        assert PM.slurm_first_host(nodes) == first, nodes
    with pytest.raises(ValueError):
        PM.slurm_first_host("")


def test_init_distributed_single_process_and_meshes(monkeypatch):
    """One process: init_distributed returns rank 0 and joins nothing; a
    rank whose device is the CUDA default raises without a card; the local
    meshes; the data axis is unbound without a group; the model axis waits
    for item 12c; FSDP without a mesh is the one-device step."""
    import torch.distributed as dist

    from vitlens_tpu_torch.parallel import mesh as PM
    from vitlens_tpu_torch.train import step as PStep

    for var in ("WORLD_SIZE", "RANK", "SLURM_NTASKS", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    assert PM.init_distributed(device="cpu") == 0 and not dist.is_initialized()
    assert (PM.process_index(), PM.process_count()) == (0, 1)
    assert PM.broadcast_object({"a": 1}) == {"a": 1}
    assert PM.all_gather_object(3) == [3]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PM.rank_device(0)
    assert PM.rank_device(1, "cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PM.make_mesh()
    mesh = PM.make_mesh(devices=["cpu", "cpu", "cpu"], n_data=2)
    assert (mesh.data, mesh.shape, mesh.spans_processes) == (
        2, {"data": 2, "model": 1}, False)
    assert PM.local_batch_size(mesh, 8) == 4
    chunks, rows = PM.split_rows(mesh, torch.arange(5.0)[:, None])
    assert rows == 5 and [c.tolist() for c in chunks] == [[[0.], [1.], [2.]],
                                                         [[3.], [4.], [0.]]]
    x = torch.ones(2)
    one = PM.make_mesh(devices=["cpu"])
    assert PM.replicate(one, x) is x
    assert PM.all_gather(x, one) is x and PM.all_reduce_mean(x, one) is x
    with pytest.raises(ValueError, match="spans processes"):
        PM.all_gather(x, mesh)
    with pytest.raises(RuntimeError, match="unbound"):
        PM.data_axis("data")
    # a model axis needs one process a rank (four ranks: test_torch_tp.py)
    with pytest.raises(ValueError, match="one process a rank"):
        PM.make_mesh(n_model=2, devices=["cpu"] * 2)
    # FSDP is ported: without a mesh, or on one device, the one-device
    # step (as in JAX); a local mesh of several devices raises
    assert PStep._step_mesh(None, "fsdp") is None
    assert PStep._step_mesh(one, "fsdp") is None
    with pytest.raises(ValueError, match="FSDP step runs one process a rank"):
        PStep._step_mesh(mesh, "fsdp")
    with pytest.raises(ValueError, match="one process a rank"):
        PStep._step_mesh(mesh, "ddp")
    assert PStep._step_mesh(one, "ddp") is None


def test_device_prefetcher_places_on_the_mesh_device():
    """DevicePrefetcher(mesh=) stages on this rank's device: on the CPU a
    pass-through of the mapped batches; a device other than the mesh's
    raises."""
    from vitlens_tpu_torch.data.loader import DevicePrefetcher
    from vitlens_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=["cpu"])
    batches = [{"x": np.full((2, 3), float(i))} for i in range(3)]
    got = list(DevicePrefetcher(batches, mesh=mesh,
                                map_fn=lambda b: {"x": b["x"] + 1}))
    assert [float(b["x"][0, 0]) for b in got] == [1.0, 2.0, 3.0]
    with pytest.raises(ValueError, match="mesh"):
        DevicePrefetcher(batches, mesh=mesh, device="meta")


# -- the mesh encode, served and from the CLI -------------------------------------


@pytest.fixture(scope="module")
def meshed():
    """ViTLens image, text and audio towers on one device, and over
    make_mesh(devices=["cpu", "cpu"]), from the same seed, at the test
    trunk (ViT-Tiny-Test in place of vitlensB's ViT-B-16: the split, pad
    and gather are the same at any width)."""
    from vitlens_tpu_torch import api as PA
    from vitlens_tpu_torch.parallel.mesh import make_mesh

    mods = ("image", "text", "audio")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(PA._TRUNKS, "vitlensB", "ViT-Tiny-Test")
        one = PA.ViTLens("vitlensB", mods, device="cpu", seed=1)
        dp = PA.ViTLens("vitlensB", mods, seed=1,
                        mesh=make_mesh(devices=["cpu", "cpu"]))
    for m in mods:
        for (n, p), q in zip(one.towers[m].state_dict().items(),
                             dp.towers[m].state_dict().values()):
            assert torch.equal(p, q), n
    return one, dp


def test_mesh_encode_is_row_exact(meshed):
    """2 images (no pad), 5 captions (padded to 6) and one 3-clip fbank (the
    4-D clip path, padded to 2): the same rows as one device, 2e-6."""
    one, dp = meshed
    rng = np.random.RandomState(0)
    a = one.towers["audio"].cfg.audio
    hw = one.towers["image"].cfg.arch.image_size
    inputs = {"image": rng.randn(2, 3, hw, hw).astype(np.float32),
              "text": ["a bird", "a dog", "sea wave", "rain", "thunder"],
              "audio": rng.randn(1, 3, a.target_length, a.mel_bins).astype(np.float32)}
    for m, x in inputs.items():
        pre = m != "text"
        want = one.encode({m: x}, preprocessed=pre)[m]
        got = dp.encode({m: x}, preprocessed=pre)[m]
        assert got.shape == want.shape, m
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6, err_msg=m)


def test_served_data_parallel_matches_one_device(meshed):
    """The server over the --data-parallel 2 --device cpu mesh answers the
    captions as the one-device model encodes them; serve's mesh helper."""
    import json as _json
    import threading
    import urllib.request

    from vitlens_tpu_torch.cli import serve as S
    from vitlens_tpu_torch.serve import make_server

    one, dp = meshed
    mesh = S.data_parallel_mesh(2, "cpu")
    assert (mesh.data, [str(d) for d in mesh.devices]) == (2, ["cpu", "cpu"])
    assert S.data_parallel_mesh(0) is None
    srv = make_server(dp, port=0, max_batch=8, max_wait_ms=5)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        caps = ["a dog barking", "rain", "an engine"]
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/v1/encode",
            data=_json.dumps({"inputs": {"text": caps}}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            got = np.asarray(_json.loads(r.read())["embeddings"]["text"])
    finally:
        srv.shutdown()
        srv.encoder.close()
        srv.server_close()
        th.join(30)
    want = one.encode({"text": caps})["text"].numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)
