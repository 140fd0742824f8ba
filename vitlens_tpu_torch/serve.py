"""Inference server (port of vitlens_tpu/serve.py): an HTTP front end over
``api.ViTLens`` with cross-request micro-batching.

Concurrent requests for one modality are coalesced into one device batch
instead of each being dispatched alone; with ``ViTLens(batch_buckets=...)``
every coalesced batch pads onto a size that ``ViTLens.warmup`` already ran.

Overload behaviour: admission is bounded by a pending-item budget
(``queue_capacity``, default 4x max_batch). A burst beyond the device's
throughput is rejected with ``ServerOverloadedError`` -> HTTP 503 instead of
growing an unbounded queue, and every request carries a default timeout ->
HTTP 504, so handler threads never block forever. Timed-out requests are
marked cancelled and skipped by the batcher.

Endpoints (JSON):
  GET  /healthz     -> {"status": "ok", "modalities": [...], "device": ...,
                        "device_name": ..., "stats": ..., "latency": ...}
  POST /v1/encode   -> body {"inputs": {modality: [item, ...]},
                             "normalize": true}
                       item: a string (a caption, a file path or a video
                       frame directory) or a nested list (a raw array, e.g. a
                       cloud or an EEG recording, which the modality's
                       processor takes).
                       reply {"embeddings": {modality: [[...], ...]},
                              "dim": D}

The batcher is a two-stage pipeline: a preprocess thread runs the host-side
modality processor for batch N+1 while the device thread computes batch N.
``max_wait_ms`` is the coalescing window, counted from the first item of a
forming batch: small at low load (a lone request pays at most that much),
and at saturation long enough to cover the clients' resubmit time, or
underfilled batches pad to their bucket and spend device time on empty rows.

Stdlib only (http.server and threads).
"""

from __future__ import annotations

import collections
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class ServerOverloadedError(RuntimeError):
    """Pending-item budget exhausted; shed load (HTTP 503)."""


@dataclass
class _Pending:
    modality: str
    items: Sequence[Any]
    normalize: bool
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[BaseException] = None
    # set by the waiting client on timeout; the batcher skips (and never
    # encodes) a cancelled request that is still queued
    cancelled: bool = False
    # admission time, for the /healthz latency percentiles
    t_enqueue: float = 0.0


class BatchingEncoder:
    """Coalesces concurrent encode requests into one device batch.

    A worker thread drains the request queue; requests for the same
    modality that arrive within `max_wait_ms` of each other (up to
    `max_batch` total items) run as ONE `ViTLens.encode` call and the
    rows are handed back per request. Encoding always runs with
    normalize=False and L2-normalizes host-side for the requests that
    asked for it — identical to in-model normalization (both normalize
    the final pooled embedding), and it lets mixed normalize flags share
    a batch.

    Backpressure: at most `queue_capacity` items (default 4x max_batch)
    may be pending (queued or in flight); `encode` raises
    ServerOverloadedError beyond that. Each call also has a default
    timeout so callers cannot block indefinitely behind a wedged device.
    """

    def __init__(self, model, max_batch: int = 64, max_wait_ms: float = 5.0,
                 queue_capacity: Optional[int] = None,
                 default_timeout_s: float = 600.0,
                 pipeline: bool = True):
        # default_timeout_s must cover the cold start, not the steady state:
        # without warmup, the first request builds the kernels (nvcc runs
        # for minutes) and a steady-state default would 504 it while the
        # device works. Operators tune it with --request-timeout.
        self.model = model
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.queue_capacity = int(queue_capacity if queue_capacity is not None
                                  else 4 * self.max_batch)
        self.default_timeout_s = float(default_timeout_s)
        self._q: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        # a non-fitting request is held here (NOT re-queued at the tail)
        # and leads the next batch — no reordering behind newer arrivals
        self._carry: Optional[_Pending] = None
        self._lock = threading.Lock()  # guards stats + _pending_items
        self._pending_items = 0
        self.stats = {"requests": 0, "batches": 0, "items": 0,
                      "rejected": 0, "timeouts": 0, "cancelled_skipped": 0}
        # rolling window of request latencies (admission -> result ready),
        # exposed as p50/p95/max via /healthz
        self._latencies: "collections.deque[float]" = collections.deque(
            maxlen=512)
        # two-stage pipeline: host preprocessing of batch N+1 (file decode,
        # resample, FPS, tokenization) overlaps device compute of batch N.
        # Depth 1: a deeper queue only adds latency under backpressure.
        # pipeline=False serializes the two stages in one thread (the
        # baseline against which the overlap is measured).
        self.pipeline = bool(pipeline)
        self._staged: "queue.Queue[Optional[tuple]]" = queue.Queue(maxsize=1)
        if self.pipeline:
            self._pre_worker = threading.Thread(
                target=self._preprocess_loop, daemon=True,
                name="vitlens-serve-preprocess")
            self._worker = threading.Thread(
                target=self._device_loop, daemon=True,
                name="vitlens-serve-batcher")
            self._pre_worker.start()
        else:
            self._pre_worker = None
            self._worker = threading.Thread(
                target=self._serial_loop, daemon=True,
                name="vitlens-serve-batcher")
        self._worker.start()

    # -- client side --------------------------------------------------------

    def encode(self, modality: str, items: Sequence[Any],
               normalize: bool = True,
               timeout: Optional[float] = None) -> np.ndarray:
        if modality not in self.model.modalities:
            raise KeyError(f"modality {modality!r} not loaded; "
                           f"have {self.model.modalities}")
        if isinstance(items, np.ndarray):
            # raw-array batch (e.g. _decode_items legacy callers): split
            # into per-item arrays so len()/extend()/row-slicing hold
            items = list(items)
        if not isinstance(items, (list, tuple)) or not items:
            raise ValueError("items must be a non-empty list")
        if timeout is None:
            timeout = self.default_timeout_s
        with self._lock:
            if self._pending_items + len(items) > self.queue_capacity:
                self.stats["rejected"] += 1
                raise ServerOverloadedError(
                    f"server overloaded: {self._pending_items} items pending "
                    f"(capacity {self.queue_capacity})")
            self._pending_items += len(items)
            self.stats["requests"] += 1
        p = _Pending(modality, items, bool(normalize),
                     t_enqueue=time.monotonic())
        self._q.put(p)
        if not p.done.wait(timeout):
            # leave the budget to the worker: it releases the items when it
            # skips the cancelled request (or finishes the in-flight batch)
            p.cancelled = True
            with self._lock:
                self.stats["timeouts"] += 1
            raise TimeoutError("encode timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def latency_stats(self) -> Dict[str, Any]:
        """Rolling request-latency percentiles (admission -> result ready)
        over the last 512 completed requests."""
        with self._lock:
            lat = sorted(self._latencies)
        if not lat:
            return {"count": 0}

        def q(p: float) -> float:
            return lat[min(len(lat) - 1, int(p * len(lat)))]

        return {"count": len(lat),
                "p50_ms": round(q(0.50) * 1e3, 2),
                "p95_ms": round(q(0.95) * 1e3, 2),
                "max_ms": round(lat[-1] * 1e3, 2)}

    def close(self) -> None:
        """Drain and stop: the shutdown sentinel lands behind every admitted
        request (FIFO), and both workers are joined with no time cap, so
        when this returns every admitted request has been answered and both
        threads have exited."""
        self._q.put(None)
        if self._pre_worker is not None:
            self._pre_worker.join()
        self._worker.join()

    # -- worker side --------------------------------------------------------

    def _release(self, *pendings: _Pending) -> None:
        with self._lock:
            for p in pendings:
                self._pending_items -= len(p.items)

    def _next_live(self, block: bool) -> Optional[_Pending]:
        """Pop the carry slot or the queue, skipping cancelled requests
        (releasing their budget). Returns None on shutdown/empty."""
        while True:
            if self._carry is not None:
                p, self._carry = self._carry, None
            else:
                try:
                    p = self._q.get(block=block)
                except queue.Empty:
                    return None
            if p is None:
                return None
            if p.cancelled:
                self._release(p)
                with self._lock:
                    self.stats["cancelled_skipped"] += 1
                continue
            return p

    def _collect(self) -> List[_Pending]:
        """One blocking get, then drain everything that lands within the
        coalescing window (same modality, staying under max_batch)."""
        first = self._next_live(block=True)
        if first is None:
            return []
        group, n = [first], len(first.items)
        deadline = time.monotonic() + self.max_wait_s
        while n < self.max_batch:
            wait = deadline - time.monotonic()
            if wait <= 0:
                break
            try:
                nxt = self._q.get(timeout=wait)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # re-deliver shutdown after this batch
                break
            if nxt.cancelled:
                self._release(nxt)
                with self._lock:
                    self.stats["cancelled_skipped"] += 1
                continue
            if (nxt.modality != first.modality
                    or n + len(nxt.items) > self.max_batch):
                self._carry = nxt  # leads the NEXT batch; no tail re-queue
                break
            group.append(nxt)
            n += len(nxt.items)
        return group

    def _stage(self, group: List[_Pending]) -> tuple:
        """Stage 1 body: run the host-side modality processor (file decode /
        resample / FPS / tokenization) for one collected batch. Returns
        (group, x, preprocessed, error-or-None)."""
        items: List[Any] = []
        for p in group:
            items.extend(p.items)
        m = group[0].modality
        proc = getattr(self.model, "processors", {}).get(m)
        if proc is None:  # model preprocesses inside encode()
            return (group, items, False, None)
        try:
            x = np.asarray(proc(items))
        except BaseException as e:  # noqa: BLE001 - fail this group only
            return (group, None, True, e)
        return (group, x, True, None)

    def _preprocess_loop(self) -> None:
        """Pipelined stage 1: hand staged batches to the device stage so
        host work on batch N+1 overlaps device compute of batch N."""
        while True:
            group = self._collect()
            if not group:
                self._staged.put(None)
                return
            self._staged.put(self._stage(group))

    def _serial_loop(self) -> None:
        """pipeline=False: collect -> preprocess -> dispatch in ONE thread
        (no host/device overlap; the measurement baseline)."""
        while True:
            group = self._collect()
            if not group:
                return
            self._dispatch(self._stage(group))

    def _drop_cancelled(self, group: List[_Pending], x):
        """Requests can time out while their batch sits staged (the pipeline
        widens the window between collection and dispatch): re-check here so
        a cancelled request never reaches the device. Returns the live
        pendings and x with the cancelled rows removed."""
        # snapshot the flags ONCE: clients flip p.cancelled concurrently
        # (encode() on timeout), and reading it per-pass could desync the
        # kept row indices from the live list (mis-attributed embeddings)
        # or leak a pending from both lists (budget leak)
        flags = [p.cancelled for p in group]
        if not any(flags):
            return group, x
        keep, off = [], 0
        for p, c in zip(group, flags):
            if not c:
                keep.extend(range(off, off + len(p.items)))
            off += len(p.items)
        cancelled = [p for p, c in zip(group, flags) if c]
        live = [p for p, c in zip(group, flags) if not c]
        with self._lock:
            self.stats["cancelled_skipped"] += len(cancelled)
        self._release(*cancelled)
        if x is not None:
            x = x[keep] if isinstance(x, np.ndarray) \
                else [x[i] for i in keep]
        return live, x

    def _device_loop(self) -> None:
        """Pipelined stage 2: device dispatch + per-request result fan-out."""
        while True:
            staged = self._staged.get()
            if staged is None:
                return
            self._dispatch(staged)

    def _dispatch(self, staged: tuple) -> None:
        """Stage 2 body: one staged batch through the device + fan-out."""
        group, x, preprocessed, err = staged
        m = group[0].modality
        group, x = self._drop_cancelled(group, x if err is None else None)
        if not group:
            return
        try:
            if err is not None:
                raise err
            feats = _to_numpy(
                self.model.encode({m: x}, normalize=False,
                                  **({"preprocessed": True}
                                     if preprocessed else {}))[m])
            n_items = sum(len(p.items) for p in group)
            now = time.monotonic()
            with self._lock:
                self.stats["batches"] += 1
                self.stats["items"] += n_items
                self._latencies.extend(
                    now - p.t_enqueue for p in group)
            off = 0
            for p in group:
                rows = feats[off:off + len(p.items)]
                off += len(p.items)
                if p.normalize:
                    nrm = np.linalg.norm(rows, axis=-1, keepdims=True)
                    rows = rows / np.maximum(nrm, 1e-12)
                p.result = rows
                p.done.set()
        except BaseException as e:  # noqa: BLE001 - propagate per request
            for p in group:
                p.error = e
                p.done.set()
        finally:
            self._release(*group)


def _to_numpy(feats) -> np.ndarray:
    """The encode's output as fp32 numpy: a tensor on the card is copied
    back (``np.asarray`` cannot read a CUDA tensor)."""
    if hasattr(feats, "detach"):
        return feats.detach().float().cpu().numpy()
    return np.asarray(feats, dtype=np.float32)


def _device_info(model) -> Dict[str, str]:
    """The model's device and, on CUDA, the card's name."""
    dev = getattr(model, "device", None)
    if dev is None:
        return {"device": "unknown", "device_name": "unknown"}
    name = str(dev)
    if getattr(dev, "type", None) == "cuda":
        import torch

        name = torch.cuda.get_device_name(dev)
    return {"device": str(dev), "device_name": name}


def _decode_items(raw: Sequence[Any]) -> Sequence[Any]:
    """JSON items: strings pass through (captions / file paths); lists of
    numbers become a list of per-item float32 arrays (pre-processed raw
    inputs) — a LIST, not one stacked ndarray, so the batcher's
    len()/extend()/row accounting treats each array as one item."""
    if all(isinstance(x, str) for x in raw):
        return list(raw)
    return [np.asarray(x, dtype=np.float32) for x in raw]


def make_server(model, host: str = "127.0.0.1", port: int = 0,
                max_batch: int = 64,
                max_wait_ms: float = 5.0,
                queue_capacity: Optional[int] = None,
                default_timeout_s: float = 600.0,
                pipeline: bool = True) -> ThreadingHTTPServer:
    """Build (don't start) the HTTP server. `serve_forever()` to run;
    `.encoder` carries the batching stats; port 0 picks a free port
    (read it back from `server.server_address`)."""
    encoder = BatchingEncoder(model, max_batch=max_batch,
                              max_wait_ms=max_wait_ms,
                              queue_capacity=queue_capacity,
                              default_timeout_s=default_timeout_s,
                              pipeline=pipeline)

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: every _reply carries Content-Length, so
        # persistent client connections are safe. With the http.server
        # default (HTTP/1.0, Connection: close) a client reusing one
        # connection would see the server hang up after every response.
        protocol_version = "HTTP/1.1"
        # Idle keep-alive connections are reaped so a vanished client
        # cannot pin a handler thread forever. Applies only BETWEEN
        # requests — in-flight encodes block in encoder.encode(), which
        # has its own default_timeout_s.
        timeout = 300.0

        def log_message(self, *a):  # quiet; observability via /healthz
            pass

        def _reply(self, code: int, payload: Dict[str, Any]) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 - http.server API
            if self.path != "/healthz":
                return self._reply(404, {"error": "not found"})
            enc = self.server.encoder
            with enc._lock:
                stats = dict(enc.stats)
                stats["pending_items"] = enc._pending_items
            self._reply(200, {
                "status": "ok",
                "modalities": list(enc.model.modalities),
                **_device_info(enc.model),
                "stats": stats,
                "latency": enc.latency_stats(),
            })

        def do_POST(self):  # noqa: N802 - http.server API
            if self.path != "/v1/encode":
                return self._reply(404, {"error": "not found"})
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n))
                normalize = bool(req.get("normalize", True))
                out: Dict[str, Any] = {}
                dim = 0
                for m, raw in req["inputs"].items():
                    feats = self.server.encoder.encode(
                        m, _decode_items(raw), normalize=normalize)
                    out[m] = feats.tolist()
                    dim = int(feats.shape[-1])
                self._reply(200, {"embeddings": out, "dim": dim})
            except ServerOverloadedError as e:
                self._reply(503, {"error": repr(e)})
            except TimeoutError as e:
                self._reply(504, {"error": repr(e)})
            except (KeyError, ValueError, TypeError) as e:
                self._reply(400, {"error": repr(e)})
            except Exception as e:  # noqa: BLE001 - surface as 500, keep serving
                self._reply(500, {"error": repr(e)})

    class Server(ThreadingHTTPServer):
        # Deep listen backlog: closed-loop fleets (100+ persistent
        # clients) open their connections in one burst; the socketserver
        # default of 5 resets the overflow at the TCP layer.
        request_queue_size = 256
        daemon_threads = True

    srv = Server((host, port), Handler)
    srv.encoder = encoder  # type: ignore[attr-defined]
    return srv
