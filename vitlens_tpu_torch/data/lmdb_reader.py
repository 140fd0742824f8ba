"""Minimal pure-Python LMDB file reader (+ a tiny writer for fixtures); a copy
of vitlens_tpu/data/lmdb_reader.py, which the port may not import.

The reference's Objaverse/ULIP2 training data ships as LMDB buckets read
with py-lmdb (reference modal_3d/datasets.py:395-494: `lmdb.open(...)`,
`txn.get(str(i).encode())`, `txn.stat()["entries"]`). This module implements
the on-disk format directly, for installs without the lmdb package — enough
to open a data file read-only and serve point `get`s and in-order cursors.
The byte layout follows the LMDB 0.9.x sources (mdb.c: MDB_meta, MDB_db,
MDB_page, MDB_node; MDB_DATA_VERSION = 1, 64-bit build):

  page 0/1   meta pages (magic 0xBEEFC0DE, pick the larger mm_txnid)
  MDB_db     {pad(u32) flags(u16) depth(u16) branch/leaf/overflow
              pages(u64 x3) entries(u64) root(u64)}; dbs[0].pad = page size
  page hdr   {pgno(u64) pad(u16) flags(u16) lower(u16) upper(u16)} (16 B)
  node       {lo(u16) hi(u16) flags(u16) ksize(u16) key data}
             leaf: datasize = lo | hi<<16 (F_BIGDATA 0x01 -> data is the
             overflow pgno); branch: child pgno = lo | hi<<16 | flags<<32
  overflow   hdr flags 0x04, `pages` count in the lower/upper union; data
             runs contiguously from byte 16 across the chained pages

Key order is LMDB's default compare (memcmp, shorter-first on ties).

`write_lmdb` emits the same structures (multi-level branch trees, overflow
chains, any power-of-two page size) so real-LMDB code paths can be
exercised in tests without the C library; it is also a practical way to
pack small pickle datasets into one file.

Known gap: reader and writer are both implemented from the LMDB 0.9 sources
and have not been checked against files written by liblmdb; the tests
exercise adversarial structure (deep trees, odd page sizes, page-boundary
values) and each side reading the other package's files.

API subset mirrors py-lmdb: `open(path, ...)` -> Environment with
`begin()`/`stat()`; Transaction with `get`/`stat`/`cursor`.
"""

from __future__ import annotations

import builtins
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

_builtin_open = builtins.open  # module defines `open` (py-lmdb API)

MAGIC = 0xBEEFC0DE
DATA_VERSION = 1

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08

F_BIGDATA = 0x01

PAGEHDRSZ = 16
NODESZ = 8
P_INVALID = 0xFFFFFFFFFFFFFFFF

_META = struct.Struct("<IIQQ")           # magic, version, address, mapsize
_DB = struct.Struct("<IHHQQQQQ")         # pad, flags, depth, branch, leaf,
                                         # overflow, entries, root
_PAGEHDR = struct.Struct("<QHHHH")       # pgno, pad, flags, lower, upper
_NODEHDR = struct.Struct("<HHHH")        # lo, hi, flags, ksize


def _cmp_key(a: bytes, b: bytes) -> int:
    """LMDB default compare: memcmp, shorter key first on shared prefix."""
    if a == b:
        return 0
    return -1 if a < b else 1  # python bytes compare == memcmp+len rule


class _DBStat:
    __slots__ = ("psize", "flags", "depth", "branch_pages", "leaf_pages",
                 "overflow_pages", "entries", "root")

    def __init__(self, raw: bytes):
        (self.psize, self.flags, self.depth, self.branch_pages,
         self.leaf_pages, self.overflow_pages, self.entries,
         self.root) = _DB.unpack(raw)


class Environment:
    """Read-only LMDB environment over a single data file (or an env
    directory containing data.mdb)."""

    def __init__(self, path: str, readonly: bool = True, lock: bool = False,
                 subdir: Optional[bool] = None, **_ignored):
        if not readonly:
            raise NotImplementedError(
                "pure-Python lmdb_reader is read-only; use write_lmdb() to "
                "create fixtures")
        if os.path.isdir(path) if subdir is None else subdir:
            path = os.path.join(path, "data.mdb")
        self.path = path
        # map, don't slurp: real Objaverse buckets are multi-GB each and a
        # dataset opens every bucket eagerly — the OS pages on demand, like
        # py-lmdb's own mmap
        import mmap

        with _builtin_open(path, "rb") as f:
            self._data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self._main = self._pick_meta()

    # -- format --------------------------------------------------------

    def _pick_meta(self) -> _DBStat:
        best: Optional[Tuple[int, _DBStat]] = None
        # meta page size isn't known before reading meta; probe common sizes
        for psize_guess in (4096, 8192, 16384, 32768, 65536, 2048, 1024, 512):
            for pg in (0, 1):
                off = pg * psize_guess
                if off + PAGEHDRSZ + 136 > len(self._data):
                    continue
                _, _, flags, _, _ = _PAGEHDR.unpack_from(self._data, off)
                if not flags & P_META:
                    continue
                base = off + PAGEHDRSZ
                magic, version, _, _ = _META.unpack_from(self._data, base)
                if magic != MAGIC or version != DATA_VERSION:
                    continue
                db0 = _DBStat(self._data[base + 24: base + 72])
                if db0.psize != psize_guess:
                    continue  # wrong probe: meta at pg 1 must align to psize
                main = _DBStat(self._data[base + 72: base + 120])
                main.psize = db0.psize
                txnid = struct.unpack_from("<Q", self._data, base + 128)[0]
                if best is None or txnid > best[0]:
                    best = (txnid, main)
            if best is not None:
                break
        if best is None:
            raise ValueError(f"{self.path}: not an LMDB data file "
                             "(no valid meta page)")
        return best[1]

    def _page(self, pgno: int) -> Tuple[int, memoryview]:
        ps = self._main.psize
        off = pgno * ps
        _, _, flags, lower, upper = _PAGEHDR.unpack_from(self._data, off)
        return flags, memoryview(self._data)[off: off + ps]

    def _node(self, page: memoryview, i: int):
        lower = struct.unpack_from("<H", page, 12)[0]
        nkeys = (lower - PAGEHDRSZ) >> 1
        assert 0 <= i < nkeys, (i, nkeys)
        noff = struct.unpack_from("<H", page, PAGEHDRSZ + 2 * i)[0]
        lo, hi, flags, ksize = _NODEHDR.unpack_from(page, noff)
        key = bytes(page[noff + NODESZ: noff + NODESZ + ksize])
        return lo, hi, flags, key, noff + NODESZ + ksize

    def _nkeys(self, page: memoryview) -> int:
        lower = struct.unpack_from("<H", page, 12)[0]
        return (lower - PAGEHDRSZ) >> 1

    def _leaf_value(self, page: memoryview, lo: int,
                    hi: int, flags: int, data_off: int) -> bytes:
        size = lo | (hi << 16)
        if flags & F_BIGDATA:
            ovf_pgno = struct.unpack_from("<Q", page, data_off)[0]
            return self._overflow(ovf_pgno, size)
        return bytes(page[data_off: data_off + size])

    def _overflow(self, pgno: int, size: int) -> bytes:
        ps = self._main.psize
        off = pgno * ps
        _, _, flags, _, _ = _PAGEHDR.unpack_from(self._data, off)
        assert flags & P_OVERFLOW, hex(flags)
        start = off + PAGEHDRSZ
        return self._data[start: start + size]

    # -- lookup --------------------------------------------------------

    def _descend(self, key: bytes) -> Tuple[memoryview, int]:
        """Walk branch pages to the leaf that may hold `key`."""
        if self._main.root == P_INVALID:
            return None, 0
        pgno = self._main.root
        for _ in range(self._main.depth + 1):
            flags, page = self._page(pgno)
            if flags & P_LEAF:
                return page, pgno
            assert flags & P_BRANCH, hex(flags)
            n = self._nkeys(page)
            child = None
            for i in range(n):  # node 0 key is empty = -inf
                lo, hi, nflags, nkey, _ = self._node(page, i)
                if i > 0 and _cmp_key(nkey, key) > 0:
                    break
                child = lo | (hi << 16) | (nflags << 32)
            pgno = child
        raise ValueError("B-tree deeper than recorded depth; corrupt file")

    def get(self, key: bytes, default=None):
        page, _ = self._descend(key)
        if page is None:
            return default
        for i in range(self._nkeys(page)):
            lo, hi, flags, nkey, data_off = self._node(page, i)
            if nkey == key:
                return self._leaf_value(page, lo, hi, flags, data_off)
        return default

    def _iter_leaves(self, pgno: int) -> Iterator[memoryview]:
        flags, page = self._page(pgno)
        if flags & P_LEAF:
            yield page
            return
        assert flags & P_BRANCH
        for i in range(self._nkeys(page)):
            lo, hi, nflags, _, _ = self._node(page, i)
            yield from self._iter_leaves(lo | (hi << 16) | (nflags << 32))

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        if self._main.root == P_INVALID:
            return
        for page in self._iter_leaves(self._main.root):
            for i in range(self._nkeys(page)):
                lo, hi, flags, key, data_off = self._node(page, i)
                yield key, self._leaf_value(page, lo, hi, flags, data_off)

    # -- py-lmdb API subset -------------------------------------------

    def begin(self, write: bool = False, **_ignored) -> "Transaction":
        assert not write
        return Transaction(self)

    def stat(self) -> Dict[str, int]:
        m = self._main
        return {"psize": m.psize, "depth": m.depth,
                "branch_pages": m.branch_pages, "leaf_pages": m.leaf_pages,
                "overflow_pages": m.overflow_pages, "entries": m.entries}

    def close(self):
        data, self._data = self._data, b""
        if hasattr(data, "close"):
            try:  # mmap: release the mapping now, not at GC
                data.close()
            except BufferError:  # exported memoryviews still alive
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Transaction:
    def __init__(self, env: Environment):
        self.env = env

    def get(self, key: bytes, default=None):
        return self.env.get(key, default)

    def stat(self, db=None) -> Dict[str, int]:
        return self.env.stat()

    def cursor(self) -> Iterator[Tuple[bytes, bytes]]:
        return self.env.items()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


def open(path: str, **kwargs) -> Environment:  # noqa: A001 - py-lmdb API
    return Environment(path, **kwargs)


# ---------------------------------------------------------------------------
# fixture writer
# ---------------------------------------------------------------------------


def write_lmdb(path: str, items: Dict[bytes, bytes],
               psize: int = 4096) -> None:
    """Write a read-only LMDB data file: sorted leaf pages, as many branch
    levels as the fan-out requires, overflow chains for values that don't
    fit a node. Node capacity rule matches mdb.c (a node may use at most
    ~half a page; bigger data goes to overflow pages)."""
    entries = sorted(items.items(), key=lambda kv: kv[0])
    max_node_data = psize // 2 - 100  # conservative vs MDB_MAXKEYSIZE rules

    def page_bytes(pgno: int, flags: int, nodes: List[bytes],
                   overflow_count: int = 0, raw: bytes = b"") -> bytes:
        if flags & P_OVERFLOW:
            hdr = struct.pack("<QHHI", pgno, 0, flags, overflow_count)
            return (hdr + raw).ljust(psize * overflow_count, b"\x00")
        ptrs, body_off = [], psize
        body = bytearray(psize)
        for node in nodes:
            body_off -= len(node) + (len(node) & 1)  # 2-byte align
            ptrs.append(body_off)
            body[body_off: body_off + len(node)] = node
        lower = PAGEHDRSZ + 2 * len(nodes)
        hdr = struct.pack("<QHHHH", pgno, 0, flags, lower, body_off)
        for i, p in enumerate(ptrs):
            struct.pack_into("<H", body, PAGEHDRSZ + 2 * i, p)
        return bytes(hdr) + bytes(body[PAGEHDRSZ:])

    def leaf_node(key: bytes, val: bytes) -> Tuple[bytes, Optional[bytes]]:
        if len(val) > max_node_data:
            # 8-byte pgno placeholder keeps the packing size honest; it is
            # patched once overflow pages have page numbers
            return (_NODEHDR.pack(len(val) & 0xFFFF, len(val) >> 16,
                                  F_BIGDATA, len(key)) + key + b"\x00" * 8,
                    val)
        return (_NODEHDR.pack(len(val) & 0xFFFF, len(val) >> 16, 0,
                              len(key)) + key + val, None)

    # pack leaves
    leaf_specs: List[Tuple[bytes, List[bytes]]] = []  # (first_key, nodes)
    cur_nodes: List[bytes] = []
    cur_first: Optional[bytes] = None
    cur_used = PAGEHDRSZ
    flat_nodes: List[Tuple[bytes, Optional[bytes]]] = [
        leaf_node(k, v) for k, v in entries]
    n_overflow_pages = 0
    for (node, ovf), (k, _v) in zip(flat_nodes, entries):
        need = 2 + len(node) + (len(node) & 1)
        if cur_nodes and cur_used + need > psize:
            leaf_specs.append((cur_first, cur_nodes))
            cur_nodes, cur_first, cur_used = [], None, PAGEHDRSZ
        if cur_first is None:
            cur_first = k
        cur_nodes.append(node)
        cur_used += need
    if cur_nodes:
        leaf_specs.append((cur_first, cur_nodes))

    # allocate pages: leaves first (patching overflow pgnos as we go)
    next_pgno = 2
    leaf_pgnos: List[int] = []
    ovf_pages: List[Tuple[int, bytes, int]] = []  # pgno, payload, npages
    # first pass: assign page numbers (leaves then overflows, in key order)
    for first, nodes in leaf_specs:
        leaf_pgnos.append(next_pgno)
        next_pgno += 1
    for node, ovf in flat_nodes:
        if ovf is not None:
            npg = -(-(PAGEHDRSZ + len(ovf)) // psize)
            ovf_pages.append((next_pgno, ovf, npg))
            next_pgno += npg
    # second pass: patch F_BIGDATA nodes' pgno placeholder
    ovf_i = 0
    fixed: List[Tuple[bytes, Optional[bytes]]] = []
    for node, ovf in flat_nodes:
        if ovf is None:
            fixed.append((node, None))
        else:
            pgno = ovf_pages[ovf_i][0]
            fixed.append((node[:-8] + struct.pack("<Q", pgno), ovf))
            ovf_i += 1
    # regroup into the same leaf page spec
    fi = 0
    final_leaves: List[List[bytes]] = []
    for _first, nodes in leaf_specs:
        final_leaves.append([fixed[fi + j][0] for j in range(len(nodes))])
        fi += len(nodes)

    # build branch levels bottom-up until a single root page remains —
    # supports arbitrarily deep B-trees (depth >= 3 with small page sizes)
    depth = 1 if leaf_pgnos else 0
    branch_level_pages: List[Tuple[int, List[bytes]]] = []  # (pgno, nodes)
    n_branch_pages = 0
    level: List[Tuple[bytes, int]] = [  # (subtree first key, child pgno)
        (first, pg) for (first, _n), pg in zip(leaf_specs, leaf_pgnos)]
    while len(level) > 1:
        pages: List[Tuple[bytes, List[bytes]]] = []  # (first key, nodes)
        cur_bn: List[bytes] = []
        cur_bfirst: Optional[bytes] = None
        cur_bused = PAGEHDRSZ
        for j, (first, child_pg) in enumerate(level):
            key = b"" if j == 0 else first  # node 0 key = -inf
            node = _NODEHDR.pack(child_pg & 0xFFFF, (child_pg >> 16) & 0xFFFF,
                                 (child_pg >> 32) & 0xFFFF, len(key)) + key
            need = 2 + len(node) + (len(node) & 1)
            if cur_bn and cur_bused + need > psize:
                pages.append((cur_bfirst, cur_bn))
                cur_bn, cur_bfirst, cur_bused = [], None, PAGEHDRSZ
            if cur_bfirst is None:
                cur_bfirst = first
            cur_bn.append(node)
            cur_bused += need
        if cur_bn:
            pages.append((cur_bfirst, cur_bn))
        level = []
        for first, nodes in pages:
            branch_level_pages.append((next_pgno, nodes))
            level.append((first, next_pgno))
            next_pgno += 1
        n_branch_pages += len(pages)
        depth += 1

    # serialize
    blob = bytearray()
    for pgno, nodes in zip(leaf_pgnos, final_leaves):
        blob += page_bytes(pgno, P_LEAF, nodes)
    for pgno, payload, npg in ovf_pages:
        blob += page_bytes(pgno, P_OVERFLOW, [], overflow_count=npg,
                           raw=payload)
        n_overflow_pages += npg
    for pgno, nodes in branch_level_pages:
        blob += page_bytes(pgno, P_BRANCH, nodes)

    root = (level[0][1] if level else P_INVALID)
    last_pg = next_pgno - 1 if next_pgno > 2 else 1
    mapsize = max(psize * (last_pg + 1), 1 << 20)

    def meta_page(pgno: int, txnid: int) -> bytes:
        hdr = struct.pack("<QHHHH", pgno, 0, P_META, 0, 0)
        meta = _META.pack(MAGIC, DATA_VERSION, 0, mapsize)
        db_free = _DB.pack(psize, 0, 0, 0, 0, 0, 0, P_INVALID)
        db_main = _DB.pack(0, 0, depth, n_branch_pages,
                           len(leaf_pgnos), n_overflow_pages,
                           len(entries), root)
        tail = struct.pack("<QQ", last_pg, txnid)
        return (hdr + meta + db_free + db_main + tail).ljust(psize, b"\x00")

    with _builtin_open(path, "wb") as f:
        f.write(meta_page(0, 0))
        f.write(meta_page(1, 1))
        f.write(bytes(blob))
