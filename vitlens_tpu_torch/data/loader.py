"""Host-side data pipeline (port of vitlens_tpu/data/loader.py).

Re-design of the reference training/data.py (:42-107 PrefetchLoader,
:150-170 CsvDataset, :184-194 DataInfo, :355-405 deterministic worker/shard
seeding, :633-657 SyntheticDataset, :691-958 loader constructors): a lightweight
thread-pooled loader with deterministic per-(seed, epoch, shard) shuffling,
so the same ``(seed, epoch)`` gives the JAX package's batches, and a device
prefetcher that overlaps the host->device copy with compute (pinned host
memory, a side CUDA stream).

Datasets are plain objects with __len__/__getitem__ returning dicts of numpy
arrays (the reference's Sample containers collapse to plain dicts here).
"""

from __future__ import annotations

import concurrent.futures as cf
import glob
import hashlib
import os
import re
import tarfile
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# Sampler: deterministic, sharded, epoch-keyed
# ---------------------------------------------------------------------------


def _epoch_rng(seed: int, epoch: int) -> np.random.RandomState:
    h = hashlib.sha256(f"{seed}:{epoch}".encode()).digest()
    return np.random.RandomState(int.from_bytes(h[:4], "little"))


class ShardedSampler:
    """Deterministic shuffle keyed on (seed, epoch), split across shards —
    the DistributedSampler + detshuffle2 equivalent (data.py:375-405)."""

    def __init__(self, n: int, shard_id: int = 0, n_shards: int = 1,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True):
        self.n = n
        self.shard_id = shard_id
        self.n_shards = n_shards
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        idx = np.arange(self.n)
        if self.shuffle:
            _epoch_rng(self.seed, self.epoch).shuffle(idx)
        if self.drop_last:
            per = self.n // self.n_shards
            idx = idx[: per * self.n_shards]
        else:
            pad = (-len(idx)) % self.n_shards
            if pad:
                idx = np.concatenate([idx, idx[:pad]])
        return idx[self.shard_id::self.n_shards]


# ---------------------------------------------------------------------------
# Collation
# ---------------------------------------------------------------------------


def default_collate(samples: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Stack dict-of-arrays samples (the BatchCollator/SampleCollator
    equivalent; util/Sample.py)."""
    out: Dict[str, Any] = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals)
        elif isinstance(vals[0], (int, np.integer)):
            out[k] = np.asarray(vals, np.int64)
        elif isinstance(vals[0], (float, np.floating)):
            out[k] = np.asarray(vals, np.float32)
        else:
            out[k] = vals  # strings etc.
    return out


# ---------------------------------------------------------------------------
# Loader
# ---------------------------------------------------------------------------


@dataclass
class DataInfo:
    """Loader + sampler bundle (reference data.py:184-194)."""

    dataloader: Any
    sampler: Optional[ShardedSampler] = None

    def set_epoch(self, epoch: int):
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)
        if hasattr(self.dataloader, "set_epoch"):
            self.dataloader.set_epoch(epoch)

    @property
    def num_batches(self):
        return len(self.dataloader)

    @property
    def num_samples(self):
        return getattr(self.dataloader, "num_samples", None)


class DataLoader:
    """Thread-pooled map-style loader with retry-on-error substitution
    (reference modal_audio/datasets.py:396-402: up to 10 random substitute
    indices on decode failure)."""

    def __init__(self, dataset, batch_size: int, sampler: Optional[ShardedSampler] = None,
                 collate_fn: Callable = default_collate, num_workers: int = 4,
                 drop_last: bool = True, retries: int = 10,
                 prefetch_batches: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or ShardedSampler(len(dataset), shuffle=False)
        self.collate_fn = collate_fn
        self.num_workers = max(num_workers, 1)
        self.drop_last = drop_last
        self.retries = retries
        self.prefetch_batches = prefetch_batches

    def set_epoch(self, epoch: int):
        self.sampler.set_epoch(epoch)

    def __len__(self):
        n = len(self.sampler.indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    @property
    def num_samples(self):
        return len(self.sampler.indices())

    def _fetch(self, idx: int):
        rng = np.random.RandomState(idx)
        last: Exception | None = None
        for _attempt in range(self.retries + 1):
            try:
                return self.dataset[idx]
            except Exception as e:  # noqa: BLE001 - substitution then re-raise
                last = e
                idx = int(rng.randint(0, len(self.dataset)))
        raise RuntimeError(
            f"failed to load sample after {self.retries} retries"
        ) from last

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idxs = self.sampler.indices()
        n_batches = len(self)
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            def load_batch(b):
                lo = b * self.batch_size
                chunk = idxs[lo: lo + self.batch_size]
                return self.collate_fn([self._fetch(int(i)) for i in chunk])

            pending: Dict[int, cf.Future] = {}
            nxt = 0
            for b in range(n_batches):
                while nxt < n_batches and len(pending) < self.prefetch_batches + 1:
                    pending[nxt] = pool.submit(load_batch, nxt)
                    nxt += 1
                yield pending.pop(b).result()


class DevicePrefetcher:
    """Host->device staging, ``depth`` batches ahead, on a worker thread (the
    reference's CUDA-stream PrefetchLoader, data.py:42-107).

    On a CUDA ``device`` the worker maps the raw batch (``map_fn``), pins
    each numpy array or tensor and copies it with ``non_blocking=True`` on a
    side stream, then records an event there. Before a batch is handed out,
    the consumer's current stream waits on that event, and each staged
    tensor is marked with ``record_stream`` for the consumer's stream:
    without it the caching allocator could hand the tensor's memory to the
    side stream's next copy while the consumer's kernels still read it. On
    the CPU (``device`` None or "cpu") the prefetcher is a pass-through of
    the mapped batches. ``mesh`` is the data-parallel placement, not yet
    ported (ROADMAP Queue 1, item 12)."""

    def __init__(self, loader: Iterable, mesh=None, exclude_keys=(),
                 depth: int = 1, map_fn: Optional[Callable] = None,
                 device=None):
        # depth=1 already gives full overlap (stage N+1 while N computes) at
        # a 2-batch device watermark, the same as the synchronous path
        if mesh is not None:
            raise NotImplementedError(
                "sharding batches over a mesh is not yet ported: ROADMAP "
                "Queue 1, item 12 (parallelism)")
        import torch

        self.loader = loader
        self.exclude = set(exclude_keys)
        self.depth = max(int(depth), 1)
        self.map_fn = map_fn
        self.device = torch.device(device) if device is not None else None
        self.cuda = self.device is not None and self.device.type == "cuda"
        self._stream = None

    def _put(self, batch):
        import torch

        if self.map_fn is not None:
            batch = self.map_fn(batch)
        if not self.cuda:
            return batch, None
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        staged = {}
        with torch.cuda.stream(self._stream):
            for k, v in batch.items():
                if k in self.exclude or not isinstance(v, (np.ndarray,
                                                           torch.Tensor)):
                    staged[k] = v
                    continue
                t = torch.as_tensor(v)
                if not t.is_pinned():
                    t = t.pin_memory()
                staged[k] = t.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return staged, ready

    def _hand_out(self, staged, ready):
        if ready is None:
            return staged
        import torch

        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(ready)
        for v in staged.values():
            if isinstance(v, torch.Tensor) and v.is_cuda:
                v.record_stream(consumer)
        return staged

    def __iter__(self):
        from collections import deque

        it = iter(self.loader)

        def task():  # runs on the single worker thread only (serialized)
            return self._put(next(it))

        with cf.ThreadPoolExecutor(1) as pool:
            pending = deque(pool.submit(task) for _ in range(self.depth))
            while pending:
                fut = pending.popleft()
                try:
                    staged, ready = fut.result()
                except StopIteration:
                    break
                pending.append(pool.submit(task))
                yield self._hand_out(staged, ready)

    def __len__(self):
        return len(self.loader)


# ---------------------------------------------------------------------------
# Basic datasets
# ---------------------------------------------------------------------------


class SyntheticDataset:
    """Fixed random tensors for input-pipeline-free throughput tests
    (reference data.py:633-657)."""

    def __init__(self, spec: Dict[str, tuple], n: int = 1024, seed: int = 0):
        rng = np.random.RandomState(seed)
        self.sample = {
            k: (rng.randn(*shape).astype(np.float32) if dtype == "f"
                else rng.randint(0, 100, size=shape).astype(np.int32))
            for k, (shape, dtype) in spec.items()
        }
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        # roll the fixed sample per index: contrastive losses over identical
        # batch rows are exactly 2*ln(B)/... with zero gradient by symmetry,
        # which makes training smokes meaningless. A roll keeps the
        # no-per-item-RNG throughput-test property while decorrelating rows.
        shift = idx % 17 + 1
        return {k: np.roll(v, shift, axis=0) for k, v in self.sample.items()}


class CsvDataset:
    """Image-caption CSV (reference data.py:150-170): sep-separated columns
    for image path and caption; processors applied lazily."""

    def __init__(self, csv_path: str, img_key: str = "filepath",
                 caption_key: str = "title", sep: str = "\t",
                 image_processor=None, text_processor=None,
                 root: str = ""):
        import csv as _csv

        with open(csv_path, newline="") as f:
            reader = _csv.DictReader(f, delimiter=sep)
            rows = list(reader)
        if rows and (img_key not in rows[0] or caption_key not in rows[0]):
            raise ValueError(
                f"csv {csv_path!r} has columns {list(rows[0])} — expected "
                f"{img_key!r} and {caption_key!r}; check --csv-separator / "
                f"--csv-img-key / --csv-caption-key")
        self.images = [os.path.join(root, r[img_key]) for r in rows]
        self.captions = [r[caption_key] for r in rows]
        self.image_processor = image_processor
        self.text_processor = text_processor

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        out = {}
        if self.image_processor is not None:
            out["image"] = self.image_processor([self.images[idx]])[0]
        if self.text_processor is not None:
            out["text"] = self.text_processor([self.captions[idx]])[0]
        out["caption_str"] = self.captions[idx]
        return out


# ---------------------------------------------------------------------------
# Tar-shard ("webdataset"-style) pipeline
# ---------------------------------------------------------------------------


def brace_expand(pattern: str) -> List[str]:
    """'{000..002}.tar' style expansion (data.py braceexpand usage)."""
    m = re.search(r"\{(\d+)\.\.(\d+)\}", pattern)
    if not m:
        return sorted(glob.glob(pattern)) or [pattern]
    lo, hi = m.group(1), m.group(2)
    width = len(lo)
    out = []
    for i in range(int(lo), int(hi) + 1):
        out.append(pattern[: m.start()] + str(i).zfill(width) + pattern[m.end():])
    return out


class TarShardDataset:
    """Iterable over (key, {ext: bytes}) groups from tar shards with
    deterministic epoch-keyed shard shuffling (detshuffle2, data.py:375-405)
    and shard splitting across (shard_id, workers)."""

    def __init__(self, urls: str, shard_id: int = 0, n_shards: int = 1,
                 shuffle: bool = True, seed: int = 0,
                 decoders: Optional[Dict[str, Callable]] = None,
                 resample_weights: Optional[Sequence[float]] = None,
                 n_resampled: Optional[int] = None):
        """resample_weights + n_resampled: weighted with-replacement shard
        resampling (the reference ResampledShards2, data.py:407-462)."""
        self.shards = brace_expand(urls)
        self.shard_id = shard_id
        self.n_shards = n_shards
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.decoders = decoders or {}
        self.resample_weights = (
            np.asarray(resample_weights, np.float64) / np.sum(resample_weights)
            if resample_weights is not None else None
        )
        self.n_resampled = n_resampled

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _my_shards(self) -> List[str]:
        rng = _epoch_rng(self.seed, self.epoch)
        if self.resample_weights is not None:
            n = self.n_resampled or len(self.shards)
            idx = rng.choice(len(self.shards), size=n, replace=True,
                             p=self.resample_weights)
            shards = [self.shards[i] for i in idx]
        else:
            shards = list(self.shards)
            if self.shuffle:
                rng.shuffle(shards)
        return shards[self.shard_id::self.n_shards]

    def __iter__(self):
        for shard in self._my_shards():
            with tarfile.open(shard) as tf:
                current_key, group = None, {}
                for member in tf:
                    if not member.isfile():
                        continue
                    base = os.path.basename(member.name)
                    key, _, ext = base.partition(".")
                    if current_key is not None and key != current_key and group:
                        yield current_key, self._decode(group)
                        group = {}
                    current_key = key
                    group[ext] = tf.extractfile(member).read()
                if group:
                    yield current_key, self._decode(group)

    def _decode(self, group):
        out = {}
        for ext, raw in group.items():
            fn = self.decoders.get(ext)
            out[ext] = fn(raw) if fn else raw
        return out


def build_loader(dataset, *, batch_size: int, shard_id: int = 0,
                 n_shards: int = 1, shuffle: bool = True, seed: int = 0,
                 num_workers: int = 4, drop_last: bool = True,
                 collate_fn: Callable = default_collate) -> DataInfo:
    sampler = ShardedSampler(len(dataset), shard_id, n_shards, shuffle, seed,
                             drop_last)
    loader = DataLoader(dataset, batch_size, sampler, collate_fn,
                        num_workers, drop_last)
    return DataInfo(dataloader=loader, sampler=sampler)
