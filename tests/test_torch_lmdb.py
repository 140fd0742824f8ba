"""The port's pure-Python LMDB reader and writer (vitlens_tpu_torch/data/
lmdb_reader.py) against the JAX package's: each side reads the other's
write_lmdb output (point gets, stats, in-order cursors), the writers emit the
same bytes, and the port's ObjaverseDataset reads a JAX-written bucket."""

import os

import numpy as np
import pytest

from vitlens_tpu.data import lmdb_reader as JL
from vitlens_tpu_torch.data import lmdb_reader as PL
from tests.test_torch_threads import share_cores

share_cores()


def _items(n, big_every, seed):
    rng = np.random.RandomState(seed)
    items = {}
    for i in range(n):
        size = 9000 if big_every and i % big_every == 0 else int(rng.randint(1, 600))
        items[str(i).encode("ascii")] = rng.bytes(size)
    return items


CASES = [("one_leaf", 3, 0, 4096), ("branch_overflow", 120, 7, 4096),
         ("deep_small_pages", 400, 0, 512), ("big_pages", 60, 5, 16384)]


@pytest.mark.parametrize("writer,reader", [(JL, PL), (PL, JL), (PL, PL)])
@pytest.mark.parametrize("name,n,big_every,psize", CASES)
def test_cross_read(tmp_path, writer, reader, name, n, big_every, psize):
    items = _items(n, big_every, seed=n)
    path = str(tmp_path / f"{name}_0")
    writer.write_lmdb(path, items, psize=psize)
    env = reader.open(path, readonly=True, lock=False)
    with env.begin() as txn:
        assert txn.stat()["entries"] == n
        for k, v in items.items():
            assert txn.get(k) == v
        assert txn.get(b"missing") is None
        assert list(txn.cursor()) == sorted(items.items())
    assert env.stat() == JL.open(path, readonly=True, lock=False).stat()
    env.close()


@pytest.mark.parametrize("name,n,big_every,psize", CASES)
def test_writers_emit_the_same_bytes(tmp_path, name, n, big_every, psize):
    items = _items(n, big_every, seed=n + 1)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    JL.write_lmdb(a, items, psize=psize)
    PL.write_lmdb(b, items, psize=psize)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_reader_is_read_only(tmp_path):
    path = str(tmp_path / "x_0")
    PL.write_lmdb(path, {b"a": b"1"})
    with pytest.raises(NotImplementedError, match="read-only"):
        PL.open(path, readonly=False)
