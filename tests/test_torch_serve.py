"""The port's inference server (vitlens_tpu_torch/serve.py and
vitlens_tpu_torch/cli/serve.py) on CPU: the cases of tests/test_serve.py
(batching, overload shedding, timeouts, keep-alive, the preprocess/device
pipeline, the SIGTERM drain of the CLI) on a tiny ``ViTLens`` built with
``device="cpu"``, plus WAV and FLAC path items against direct encodes, a
drain that outlasts the JAX server's 5 s join cap, and the CLI's parser and
default buckets."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tools.reference_layout import pcm_from_float, write_flac, write_wav
from vitlens_tpu_torch.serve import (
    BatchingEncoder, ServerOverloadedError, _decode_items, make_server,
)
from tests.test_torch_threads import child_env, share_cores

share_cores()


class _FakeModel:
    """Stands in for api.ViTLens: records every device-batch size."""

    def __init__(self):
        self.modalities = ["text"]
        self.batch_sizes = []
        self.lock = threading.Lock()

    def encode(self, inputs, normalize=False):
        (m, items), = inputs.items()
        with self.lock:
            self.batch_sizes.append(len(items))
        # embedding = [len(item), 1] so rows are attributable to items
        return {m: np.asarray([[float(len(s)), 1.0] for s in items])}


def test_batching_coalesces_concurrent_requests():
    model = _FakeModel()
    enc = BatchingEncoder(model, max_batch=8, max_wait_ms=2000)
    try:
        results = {}

        def ask(name, items):
            results[name] = enc.encode("text", items, normalize=False)

        t1 = threading.Thread(target=ask, args=("a", ["xx", "yyy"]))
        t2 = threading.Thread(target=ask, args=("b", ["zzzz"]))
        t1.start(); t2.start(); t1.join(); t2.join()

        np.testing.assert_array_equal(results["a"][:, 0], [2.0, 3.0])
        np.testing.assert_array_equal(results["b"][:, 0], [4.0])
        # both requests rode ONE device dispatch
        assert model.batch_sizes == [3]
        assert {k: enc.stats[k] for k in ("requests", "batches", "items")} \
            == {"requests": 2, "batches": 1, "items": 3}
    finally:
        enc.close()


def test_serial_mode_matches_pipelined():
    """pipeline=False (one-thread collect->preprocess->dispatch, the bench
    A/B baseline) returns the same embeddings/stats as the pipelined path."""
    model = _FakeModel()
    enc = BatchingEncoder(model, max_batch=8, max_wait_ms=2000,
                          pipeline=False)
    try:
        assert enc._pre_worker is None
        results = {}

        def ask(name, items):
            results[name] = enc.encode("text", items, normalize=False)

        t1 = threading.Thread(target=ask, args=("a", ["xx", "yyy"]))
        t2 = threading.Thread(target=ask, args=("b", ["zzzz"]))
        t1.start(); t2.start(); t1.join(); t2.join()

        np.testing.assert_array_equal(results["a"][:, 0], [2.0, 3.0])
        np.testing.assert_array_equal(results["b"][:, 0], [4.0])
        assert model.batch_sizes == [3]  # still coalesced into one dispatch
        assert enc.stats["batches"] == 1 and enc.stats["items"] == 3
    finally:
        enc.close()


def test_batching_respects_max_batch_and_normalize():
    model = _FakeModel()
    enc = BatchingEncoder(model, max_batch=2, max_wait_ms=2000)
    try:
        results = {}

        def ask(name, items, norm):
            results[name] = enc.encode("text", items, normalize=norm)

        ts = [threading.Thread(target=ask, args=("a", ["xx", "yyy"], True)),
              threading.Thread(target=ask, args=("b", ["zzzz"], False))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        # max_batch=2 forces two dispatches regardless of arrival order
        assert sorted(model.batch_sizes) == [1, 2]
        np.testing.assert_allclose(
            np.linalg.norm(results["a"], axis=-1), 1.0, atol=1e-6)
        assert abs(np.linalg.norm(results["b"][0]) - 1.0) > 1e-3
    finally:
        enc.close()


def test_batching_error_and_validation():
    model = _FakeModel()
    enc = BatchingEncoder(model, max_wait_ms=1)
    try:
        with pytest.raises(KeyError):
            enc.encode("thermal", ["x"])
        with pytest.raises(ValueError):
            enc.encode("text", [])

        def boom(inputs, normalize=False):
            raise RuntimeError("device on fire")

        model.encode = boom
        with pytest.raises(RuntimeError, match="device on fire"):
            enc.encode("text", ["x"])
    finally:
        enc.close()


class _SlowModel(_FakeModel):
    """Fake device with a fixed per-batch latency, for overload tests."""

    def __init__(self, batch_s=0.2):
        super().__init__()
        self.batch_s = batch_s

    def encode(self, inputs, normalize=False):
        time.sleep(self.batch_s)
        return super().encode(inputs, normalize)


def test_decode_items_numeric_is_list_of_arrays():
    out = _decode_items([[1.0, 2.0], [3.0, 4.0]])
    assert isinstance(out, list) and len(out) == 2
    assert all(isinstance(a, np.ndarray) and a.dtype == np.float32
               for a in out)
    assert _decode_items(["a", "b"]) == ["a", "b"]


def test_encode_accepts_ndarray_items():
    model = _FakeModel()
    model.encode = lambda inputs, normalize=False: {
        "text": np.stack([np.asarray([a.sum(), 1.0], np.float32)
                          for a in next(iter(inputs.values()))])}
    enc = BatchingEncoder(model, max_wait_ms=1)
    try:
        feats = enc.encode("text", np.ones((3, 4), np.float32),
                           normalize=False)
        np.testing.assert_array_equal(feats[:, 0], [4.0, 4.0, 4.0])
    finally:
        enc.close()


def test_overload_sheds_instead_of_stalling():
    """Burst beyond capacity: excess requests get ServerOverloadedError
    fast; admitted ones complete; the queue never grows unbounded."""
    model = _SlowModel(batch_s=0.15)
    enc = BatchingEncoder(model, max_batch=2, max_wait_ms=1,
                          queue_capacity=4, default_timeout_s=30)
    try:
        outcomes = []
        lock = threading.Lock()

        def ask(i):
            try:
                enc.encode("text", [f"req{i}"], normalize=False)
                out = "ok"
            except ServerOverloadedError:
                out = "shed"
            with lock:
                outcomes.append(out)

        ts = [threading.Thread(target=ask, args=(i,)) for i in range(12)]
        t0 = time.monotonic()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        took = time.monotonic() - t0
        assert outcomes.count("shed") >= 1, outcomes
        assert outcomes.count("ok") >= 4, outcomes
        # shedding means total time ~ admitted/throughput, not 12 batches
        assert took < 12 * model.batch_s, took
        with enc._lock:
            assert enc._pending_items == 0  # budget fully released
        assert enc.stats["rejected"] == outcomes.count("shed")
    finally:
        enc.close()


def test_timeout_cancels_queued_request():
    """A timed-out request is skipped by the batcher (never encoded) and
    its budget is released."""
    model = _SlowModel(batch_s=0.3)
    enc = BatchingEncoder(model, max_batch=1, max_wait_ms=1,
                          queue_capacity=8, default_timeout_s=30)
    try:
        # occupy the worker, then queue one request with a tiny timeout
        t_busy = threading.Thread(
            target=enc.encode, args=("text", ["busy"]), kwargs={})
        t_busy.start()
        time.sleep(0.05)  # busy request now in flight
        with pytest.raises(TimeoutError):
            enc.encode("text", ["late"], timeout=0.01)
        t_busy.join()
        # give the worker a turn to find + skip the cancelled request
        enc.encode("text", ["after"])
        assert enc.stats["cancelled_skipped"] == 1
        with enc._lock:
            assert enc._pending_items == 0
        # "late" was never dispatched: only "busy" and "after" batches ran
        assert model.batch_sizes == [1, 1]
    finally:
        enc.close()


def test_nonfitting_request_leads_next_batch():
    """A request deferred for modality/size reasons is carried to the
    FRONT of the next batch, not re-queued behind newer arrivals."""
    model = _SlowModel(batch_s=0.15)
    enc = BatchingEncoder(model, max_batch=2, max_wait_ms=60,
                          queue_capacity=64)
    try:
        order = []
        lock = threading.Lock()

        def ask(name, items):
            enc.encode("text", items, normalize=False)
            with lock:
                order.append(name)

        # "big" (2 items) + "deferred" (2 items, doesn't fit with big)
        t1 = threading.Thread(target=ask, args=("big", ["aa", "bb"]))
        t1.start()
        time.sleep(0.02)
        t2 = threading.Thread(target=ask, args=("deferred", ["cc", "dd"]))
        t2.start()
        time.sleep(0.02)
        t3 = threading.Thread(target=ask, args=("newer", ["ee", "ff"]))
        t3.start()
        for t in (t1, t2, t3):
            t.join()
        assert order.index("deferred") < order.index("newer"), order
    finally:
        enc.close()


def test_http_numeric_inputs_accepted():
    """The documented nested-list (raw array) request form is not rejected
    with 400."""
    model = _FakeModel()
    srv = make_server(model, port=0, max_batch=8, max_wait_ms=1)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/encode",
            data=json.dumps({"inputs": {"text": [[1.0, 2.0], [3.0, 4.0]]},
                             "normalize": False}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as r:
            out = json.loads(r.read())
        emb = np.asarray(out["embeddings"]["text"])
        assert emb.shape == (2, 2)  # one row per item, not 400
    finally:
        srv.shutdown()
        srv.encoder.close()
        srv.server_close()


def test_http_overload_returns_503():
    model = _SlowModel(batch_s=0.3)
    srv = make_server(model, port=0, max_batch=1, max_wait_ms=1,
                      queue_capacity=2, default_timeout_s=30)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]
    try:
        codes = []
        lock = threading.Lock()

        def post(i):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/encode",
                data=json.dumps(
                    {"inputs": {"text": [f"x{i}"]}}).encode(),
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req) as r:
                    codes.append((200, json.loads(r.read())["dim"]))
            except urllib.error.HTTPError as e:
                with lock:
                    codes.append((e.code, None))

        ts = [threading.Thread(target=post, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        got = [c for c, _ in codes]
        assert got.count(503) >= 1, got
        assert got.count(200) >= 2, got
        # healthz exposes the shed counter
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz") as r:
            stats = json.loads(r.read())["stats"]
        assert stats["rejected"] == got.count(503)
        assert stats["pending_items"] == 0
    finally:
        srv.shutdown()
        srv.encoder.close()
        srv.server_close()


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """A vitlensB ViTLens for text and audio on the CPU, its trunks cut to
    two blocks, behind the server; and two audio files."""
    from vitlens_tpu_torch.api import ViTLens

    model = ViTLens("vitlensB", ("text", "audio"), device="cpu")
    for tower in model.towers.values():
        tower.trunk.blocks = tower.trunk.blocks[:2]
    d = tmp_path_factory.mktemp("audio")
    rng = np.random.RandomState(0)
    wav, flac = str(d / "a.wav"), str(d / "b.flac")
    write_wav(wav, pcm_from_float(0.2 * rng.randn(1, 24000), 16), 16000)
    write_flac(flac, pcm_from_float(0.2 * rng.randn(2, 30000), 16), 22050)
    srv = make_server(model, port=0, max_batch=8, max_wait_ms=5)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield srv, model, [wav, flac]
    srv.shutdown()
    srv.encoder.close()
    srv.server_close()


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/encode",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def test_http_encode_matches_direct(server):
    srv, model, _ = server
    port = srv.server_address[1]

    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz") as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and "text" in health["modalities"]
    assert health["device"] == "cpu" and health["device_name"] == "cpu"

    texts = ["a bird", "sea wave"]
    out = _post(port, {"inputs": {"text": texts}, "normalize": True})
    got = np.asarray(out["embeddings"]["text"], np.float32)
    assert got.shape == (2, out["dim"])
    want = model.encode({"text": texts}, normalize=True)["text"].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_http_audio_file_items_match_direct(server):
    """WAV and FLAC paths as items: decoded, resampled and cut into clips by
    the preprocess stage, then one encode."""
    srv, model, paths = server
    port = srv.server_address[1]
    out = _post(port, {"inputs": {"audio": paths}})
    got = np.asarray(out["embeddings"]["audio"], np.float32)
    want = model.encode({"audio": paths})["audio"].numpy()
    assert got.shape == want.shape == (2, out["dim"])
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_http_depth_eeg_video_items_match_direct(tmp_path):
    """One served request of each new modality, items as a user sends them:
    a depth .npy and a 16-bit .png, an EEG .pt and a numeric EEG item, a
    video frame directory; each reply equals the direct encode of the same
    items, and /healthz lists the three modalities."""
    from PIL import Image

    from vitlens_tpu_torch.api import ViTLens

    model = ViTLens("vitlensB", ("depth", "eeg", "video"), device="cpu")
    for tower in model.towers.values():
        tower.trunk.blocks = tower.trunk.blocks[:2]
    rng = np.random.RandomState(1)
    npy, png, pt = (str(tmp_path / n) for n in ("d.npy", "d.png", "e.pt"))
    np.save(npy, (rng.rand(240, 320) * 80).astype(np.float32))
    Image.fromarray((rng.rand(200, 300) * 5e4).astype(np.uint16)).save(png)
    torch.save(torch.from_numpy(rng.randn(128, 480).astype(np.float32)), pt)
    frames = tmp_path / "clip"
    frames.mkdir()
    for i in range(10):
        Image.fromarray(rng.randint(0, 255, (240, 320, 3), np.uint8)).save(
            frames / f"{i:03d}.jpg")
    eeg = rng.randn(128, 500).astype(np.float32)
    items = {"depth": [npy, png], "eeg": [pt, eeg.tolist()],
             "video": [str(frames)]}
    direct = {"depth": [npy, png], "eeg": [pt, eeg], "video": [str(frames)]}
    srv = make_server(model, port=0, max_batch=8, max_wait_ms=5)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        port = srv.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            assert json.loads(r.read())["modalities"] == ["depth", "eeg", "video"]
        for m in ("depth", "eeg", "video"):
            if m == "eeg":  # a path, then a numeric item: one request each
                got = np.concatenate([np.asarray(_post(port, {"inputs": {m: [x]}})
                                                 ["embeddings"][m], np.float32)
                                      for x in items[m]])
            else:
                got = np.asarray(_post(port, {"inputs": {m: items[m]}})
                                 ["embeddings"][m], np.float32)
            want = model.encode({m: direct[m]})[m].numpy()
            assert got.shape == want.shape == (len(items[m]), 512)
            np.testing.assert_allclose(got, want, atol=1e-5)
    finally:
        srv.shutdown()
        srv.encoder.close()
        srv.server_close()
        th.join(30)
    assert not th.is_alive()


def test_http_keepalive_connection_reuse(server):
    """HTTP/1.1 with Content-Length: many requests down one persistent
    connection, on the same socket throughout."""
    import http.client

    srv, _, _ = server
    port = srv.server_address[1]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        sock_ids = set()
        for i in range(4):
            body = json.dumps({"inputs": {"text": [f"query {i}"]}})
            conn.request("POST", "/v1/encode", body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            payload = json.loads(resp.read())
            assert resp.status == 200, payload
            assert resp.version == 11  # HTTP/1.1, not 1.0
            assert resp.getheader("Connection") != "close"
            sock_ids.add(id(conn.sock))
        assert len(sock_ids) == 1, sock_ids
    finally:
        conn.close()


def test_http_error_paths(server):
    srv, _, _ = server
    port = srv.server_address[1]
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/encode",
        data=json.dumps({"inputs": {"thermal": ["x"]}}).encode())
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/nope")
    assert e.value.code == 404


def test_dispatch_copies_tensors_back_to_numpy():
    """The device stage turns the encode's tensor (on the card in
    production) into fp32 numpy rows: bf16 output is cast up."""
    class _TensorModel(_FakeModel):
        def encode(self, inputs, normalize=False):
            rows = super().encode(inputs, normalize)["text"]
            return {"text": torch.as_tensor(rows).bfloat16()}

    enc = BatchingEncoder(_TensorModel(), max_wait_ms=1)
    try:
        feats = enc.encode("text", ["abc", "de"], normalize=False)
        assert feats.dtype == np.float32
        np.testing.assert_array_equal(feats[:, 0], [3.0, 2.0])
    finally:
        enc.close()


def test_close_drains_without_a_time_cap():
    """close() returns only once the in-flight batch is answered and both
    workers have exited, even when the batch outlasts the JAX server's 5 s
    join cap."""
    release = threading.Event()

    class _Blocked(_FakeModel):
        def encode(self, inputs, normalize=False):
            release.wait(30)
            return super().encode(inputs, normalize)

    enc = BatchingEncoder(_Blocked(), max_batch=4, max_wait_ms=1)
    result = {}
    asker = threading.Thread(
        target=lambda: result.setdefault("a", enc.encode("text", ["xyz"])))
    asker.start()
    time.sleep(0.2)  # the request is in flight
    closer = threading.Thread(target=enc.close)
    closer.start()
    timer = threading.Timer(5.5, release.set)
    timer.start()
    closer.join(5.2)
    assert closer.is_alive(), "close() returned while a batch was in flight"
    closer.join(30)
    asker.join(30)
    timer.cancel()
    assert not closer.is_alive() and not asker.is_alive()
    assert not enc._worker.is_alive() and not enc._pre_worker.is_alive()
    np.testing.assert_allclose(np.linalg.norm(result["a"], axis=-1), 1.0)


def test_preprocess_overlaps_device_compute():
    """The two-stage pipeline: host preprocessing of batch N+1 must start
    while the device stage still computes batch N."""
    spans = {"proc": [], "enc": []}
    lock = threading.Lock()

    class _Timed:
        modalities = ["text"]

        class _Proc:
            def __call__(self, items):
                t0 = time.monotonic()
                time.sleep(0.25)
                with lock:
                    spans["proc"].append((t0, time.monotonic()))
                return np.asarray([[float(len(s))] for s in items])

        processors = {"text": _Proc()}

        def encode(self, inputs, normalize=False, preprocessed=False):
            assert preprocessed, "pipeline must hand the device stage arrays"
            (m, x), = inputs.items()
            t0 = time.monotonic()
            time.sleep(0.25)
            with lock:
                spans["enc"].append((t0, time.monotonic()))
            return {m: np.concatenate([x, np.ones_like(x)], axis=-1)}

    enc = BatchingEncoder(_Timed(), max_batch=2, max_wait_ms=1.0)
    try:
        results = {}

        def ask(name, items):
            results[name] = enc.encode("text", items, normalize=False)

        # two groups (max_batch=2 each) so the pipeline has two batches
        ts = [threading.Thread(target=ask, args=("a", ["xx", "yyy"])),
              threading.Thread(target=ask, args=("b", ["zzzz", "w"]))]
        ts[0].start()
        time.sleep(0.05)  # deterministic batch order: "a" first
        ts[1].start()
        for t in ts:
            t.join()

        np.testing.assert_array_equal(results["a"][:, 0], [2.0, 3.0])
        np.testing.assert_array_equal(sorted(results["b"][:, 0]), [1.0, 4.0])
        assert len(spans["proc"]) == 2 and len(spans["enc"]) == 2
        # preprocess of batch 2 began BEFORE device compute of batch 1 ended
        enc1_end = spans["enc"][0][1]
        proc2_start = spans["proc"][1][0]
        assert proc2_start < enc1_end, (spans, "no overlap")
    finally:
        enc.close()


def test_healthz_latency_percentiles():
    """Completed requests feed the rolling latency window exposed by
    latency_stats() (and /healthz)."""
    model = _FakeModel()
    enc = BatchingEncoder(model, max_batch=4, max_wait_ms=1.0)
    try:
        assert enc.latency_stats() == {"count": 0}
        for _ in range(3):
            enc.encode("text", ["ab"], normalize=False)
        stats = enc.latency_stats()
        assert stats["count"] == 3
        assert 0 <= stats["p50_ms"] <= stats["p95_ms"] <= stats["max_ms"]
    finally:
        enc.close()


def test_serve_cli_sigterm_graceful_drain(tmp_path):
    """SIGTERM to the serve CLI drains and exits 0: requests admitted before
    the signal are answered (the encoder's FIFO shutdown sentinel lands
    behind them), and the process logs the drain. The CLI warms up its
    buckets (1 and 2) first. A subprocess, because signals need a real
    process."""
    import http.client
    import os
    import re
    import signal
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = child_env(1, {"PYTHONPATH": repo})
    cmd = [sys.executable, "-m", "vitlens_tpu_torch.cli.serve",
           "--model-var", "vitlensB", "--modalities", "text",
           "--precision", "fp32", "--device", "cpu", "--port", "0",
           "--max-batch", "2", "--max-wait-ms", "2"]
    outf, errf = tmp_path / "out.txt", tmp_path / "err.txt"
    # child stderr to a FILE (64K pipe backpressure blocks the child)
    with open(outf, "w") as of, open(errf, "w") as ef:
        p = subprocess.Popen(cmd, env=env, cwd=repo, stdout=of, stderr=ef)
        try:
            port = None
            deadline = time.time() + 300
            while time.time() < deadline and port is None:
                m = re.search(r"listening on http://[^:]+:(\d+)",
                              outf.read_text())
                if m:
                    port = int(m.group(1))
                    break
                assert p.poll() is None, errf.read_text()[-2000:]
                time.sleep(0.05)
            assert port, "server never printed its port"
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            conn.request("POST", "/v1/encode",
                         json.dumps({"inputs": {"text": ["a dog"]}}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            assert resp.status == 200, body
            conn.close()
            p.send_signal(signal.SIGTERM)
            p.wait(timeout=120)
        finally:
            if p.poll() is None:
                p.kill()
    assert p.returncode == 0, errf.read_text()[-2000:]
    out = outf.read_text()
    assert "draining" in out, out[-2000:]
    assert re.search(r"drained, exiting \(served [1-9]\d* items", out), \
        out[-2000:]


def test_serve_cli_default_buckets():
    """Default --batch-buckets covers every coalescible batch size up to
    --max-batch with power-of-2 buckets, so that warmup runs the sizes the
    batcher dispatches."""
    from vitlens_tpu_torch.cli.serve import default_buckets

    assert default_buckets(64) == [1, 2, 4, 8, 16, 32, 64]
    assert default_buckets(1) == [1]
    assert default_buckets(48) == [1, 2, 4, 8, 16, 32, 48]


def test_serve_cli_parser():
    """The port's flags: bf16 by default, mapped to torch dtypes; --device;
    --data-parallel N needs N cards (or --device cpu) and raises before any
    model is built without them."""
    from vitlens_tpu_torch.cli import serve as S

    args = S.build_parser().parse_args([])
    assert (args.model_var, args.precision, args.modalities, args.device) == \
        ("vitlensL", "bf16", ["image", "text"], None)
    assert args.warmup and args.pipeline and args.max_batch == 64
    args = S.build_parser().parse_args(
        ["--ckpt", "all=/x.pt", "--ckpt", "text=/y.pt", "--no-warmup",
         "--device", "cpu", "--batch-buckets", "1", "8"])
    assert args.ckpt == ["all=/x.pt", "text=/y.pt"] and not args.warmup
    assert args.batch_buckets == [1, 8] and args.device == "cpu"
    with pytest.raises(RuntimeError, match="--data-parallel 4: .* CUDA device"):
        S.main(["--data-parallel", "4"])
