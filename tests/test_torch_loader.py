"""The port's host data pipeline (vitlens_tpu_torch/data/loader.py) against
the JAX package's loader.py: sampler indices for every (seed, epoch, shard),
collated batches, build_loader epochs over the synthetic and CSV datasets,
tar-shard order and brace expansion, and the DevicePrefetcher, which on the
CPU hands out the mapped batches unchanged (on the card it is held by
chip_smoke.py's trainer phase)."""

import io
import os
import tarfile

import numpy as np
import pytest
from PIL import Image

from vitlens_tpu.data import loader as JLd
from vitlens_tpu_torch.data import loader as PLd
from tests.test_torch_threads import share_cores

share_cores()


def _equal_batches(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("n,shards,shuffle,drop_last", [
    (10, 1, True, True), (37, 4, True, True), (37, 4, False, False),
    (5, 3, True, False), (64, 8, True, True)])
def test_sampler_indices(n, shards, shuffle, drop_last):
    for seed in (0, 7):
        for epoch in (0, 1, 5):
            for shard in range(shards):
                j = JLd.ShardedSampler(n, shard, shards, shuffle, seed, drop_last)
                p = PLd.ShardedSampler(n, shard, shards, shuffle, seed, drop_last)
                j.set_epoch(epoch)
                p.set_epoch(epoch)
                np.testing.assert_array_equal(p.indices(), j.indices())


def test_default_collate():
    rng = np.random.RandomState(0)
    samples = [{"x": rng.randn(3, 2).astype(np.float32), "id": i,
                "w": float(i) / 3, "s": f"caption {i}", "n": np.int32(i)}
               for i in range(4)]
    _equal_batches(PLd.default_collate(samples), JLd.default_collate(samples))


def _spec():
    return {"image": ((3, 8, 8), "f"), "text": ((77,), "i"),
            "visual": ((16, 4), "f")}


@pytest.mark.parametrize("workers,drop_last", [(1, True), (3, False)])
def test_build_loader_epochs_synthetic(workers, drop_last):
    jds = JLd.SyntheticDataset(_spec(), n=21, seed=3)
    pds = PLd.SyntheticDataset(_spec(), n=21, seed=3)
    for i in range(21):
        _equal_batches(pds[i], jds[i])
    ji = JLd.build_loader(jds, batch_size=4, seed=5, num_workers=workers,
                          drop_last=drop_last)
    pi = PLd.build_loader(pds, batch_size=4, seed=5, num_workers=workers,
                          drop_last=drop_last)
    assert pi.num_batches == ji.num_batches and pi.num_samples == ji.num_samples
    for epoch in (0, 1, 2):
        ji.set_epoch(epoch)
        pi.set_epoch(epoch)
        jb, pb = list(ji.dataloader), list(pi.dataloader)
        assert len(jb) == len(pb) == ji.num_batches
        for a, b in zip(pb, jb):
            _equal_batches(a, b)


def _csv(tmp_path, n=5):
    rows = ["filepath\ttitle"]
    rng = np.random.RandomState(0)
    for i in range(n):
        p = tmp_path / f"im{i}.png"
        Image.fromarray(rng.randint(0, 255, (20, 24, 3), np.uint8)).save(p)
        rows.append(f"{p.name}\ta picture number {i}")
    path = tmp_path / "train.tsv"
    path.write_text("\n".join(rows))
    return str(path)


def test_csv_dataset_and_loader(tmp_path):
    from vitlens_tpu.data import processors as JP
    from vitlens_tpu_torch.data import processors as PP

    path = _csv(tmp_path)
    jds = JLd.CsvDataset(path, image_processor=JP.ImageProcessor(image_size=28),
                         text_processor=JP.TextProcessor(), root=str(tmp_path))
    pds = PLd.CsvDataset(path, image_processor=PP.ImageProcessor(image_size=28),
                         text_processor=PP.TextProcessor(), root=str(tmp_path))
    assert len(pds) == len(jds) == 5
    for i in range(5):
        _equal_batches(pds[i], jds[i])
    ji = JLd.build_loader(jds, batch_size=2, seed=1, num_workers=2)
    pi = PLd.build_loader(pds, batch_size=2, seed=1, num_workers=2)
    for a, b in zip(list(pi.dataloader), list(ji.dataloader)):
        _equal_batches(a, b)
    bad = tmp_path / "bad.tsv"
    bad.write_text("path\tcaption\nx.png\ty\n")
    with pytest.raises(ValueError, match="expected 'filepath' and 'title'"):
        PLd.CsvDataset(str(bad))


def test_loader_substitutes_failed_samples():
    """A sample that raises is replaced by seeded random substitutes, as in
    JAX; after the retries the loader raises."""
    class Flaky:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i % 2:
                raise OSError(f"bad {i}")
            return {"id": i}

    def ids(L):
        return [b["id"].tolist() for b in L.DataLoader(Flaky(), 3, num_workers=1)]

    assert ids(PLd) == ids(JLd)

    class Broken(Flaky):
        def __getitem__(self, i):
            raise OSError("always")

    with pytest.raises(RuntimeError, match="after 10 retries"):
        list(PLd.DataLoader(Broken(), 2, num_workers=1))


def test_tar_shards_and_brace_expand(tmp_path):
    for s in range(3):
        with tarfile.open(tmp_path / f"shard-{s:03d}.tar", "w") as tf:
            for k in range(2):
                for ext, data in (("txt", f"cap {s} {k}".encode()),
                                  ("cls", str(s * 10 + k).encode())):
                    info = tarfile.TarInfo(f"s{s}k{k}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    pattern = str(tmp_path / "shard-{000..002}.tar")
    assert PLd.brace_expand(pattern) == JLd.brace_expand(pattern)
    assert PLd.brace_expand(str(tmp_path / "*.tar")) == JLd.brace_expand(
        str(tmp_path / "*.tar"))
    dec = {"cls": lambda b: int(b.decode())}
    for kw in ({"shuffle": True}, {"shuffle": False},
               {"resample_weights": [1, 2, 3], "n_resampled": 5},
               {"n_shards": 2, "shard_id": 1}):
        for epoch in (0, 3):
            j = JLd.TarShardDataset(pattern, seed=4, decoders=dec, **kw)
            p = PLd.TarShardDataset(pattern, seed=4, decoders=dec, **kw)
            j.set_epoch(epoch)
            p.set_epoch(epoch)
            assert list(p) == list(j)


def test_device_prefetcher_on_cpu_is_a_pass_through():
    ds = PLd.SyntheticDataset(_spec(), n=12, seed=0)
    info = PLd.build_loader(ds, batch_size=4, seed=2, num_workers=2)
    want = [dict(b, extra=b["visual"].sum()) for b in info.dataloader]
    for device in (None, "cpu"):
        pf = PLd.DevicePrefetcher(info.dataloader, device=device, depth=2,
                                  map_fn=lambda b: dict(b, extra=b["visual"].sum()))
        got = list(pf)
        assert len(pf) == len(got) == 3
        for a, b in zip(got, want):
            _equal_batches(a, b)


def test_device_prefetcher_raises_on_a_mesh():
    """A mesh places on its (this rank's) device: on the CPU a pass-through;
    a device that is not the mesh's raises."""
    from vitlens_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=["cpu"])
    got = list(PLd.DevicePrefetcher([{"x": np.ones(2)}], mesh=mesh))
    assert len(got) == 1 and got[0]["x"].sum() == 2
    with pytest.raises(ValueError, match="mesh"):
        PLd.DevicePrefetcher([], mesh=mesh, device="meta")
