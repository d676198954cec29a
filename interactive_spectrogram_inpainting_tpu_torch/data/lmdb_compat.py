"""LMDB file-format compatibility: read (and bulk-write) the reference's
code databases WITHOUT the ``lmdb`` C library.

The reference stores extracted codemaps in an LMDB environment — sub-db
``codes`` maps ``note_str`` (utf-8) to ``pickle(CodeRow)`` and the main
db holds ``label_encoders`` (``extract_code.py:42-83``,
``.../utils/datasets/lmdb_dataset.py:30-89``). This module implements
the on-disk LMDB 0.9 format directly (meta pages, B+tree branch/leaf
pages, overflow chains, named sub-databases), so reference-produced
databases can be consumed here and databases produced here are designed
to be consumed by the reference's py-lmdb stack — byte-level pipeline
interop without a native dependency. Interop verification status:
self-round-trip + the ``validate_environment`` structural page audit
run in CI; the two-directional py-lmdb cross-validation test
(``tests/test_lmdb_compat.py``) is gated on ``importorskip('lmdb')``
and must be run wherever the C binding exists (it is not installable
in this image).

Format reference: the public liblmdb ``mdb.c``/``lmdb.h`` struct layout
(MDB_page / MDB_node / MDB_db / MDB_meta), little-endian:

  page:   pgno u64 | pad u16 | flags u16 | lower u16 | upper u16 | ptrs…
          (overflow pages reuse bytes 12..16 as the u32 page count)
  node:   lo u16 | hi u16 | flags u16 | ksize u16 | key | data
          branch: pgno = lo | hi<<16 | flags<<32;  leaf: datasize = lo |
          hi<<16, F_BIGDATA -> data is a u64 overflow pgno
  meta:   magic 0xBEEFC0DE u32 | version u32 | address u64 | mapsize u64
          | dbs[2] (48B each; dbs[0].pad = page size) | last_pg u64 |
          txnid u64

Read path: ``LMDBReader`` (zero-copy mmap B+tree walker).
Write path: ``LMDBWriter`` (single-transaction bottom-up bulk build —
the extraction pipeline's write pattern, one sorted pass).
``LMDBCodesDataset`` layers the reference's CodeRow/pickle conventions
on top (``lmdb_dataset.py:59-89``).

The port's own copy of the JAX package's module (no array library beyond
numpy).
"""

from __future__ import annotations

import io
import mmap
import pathlib
import pickle
import struct
from collections import OrderedDict, namedtuple
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

MDB_MAGIC = 0xBEEFC0DE
MDB_VERSION = 1
PAGEHDRSZ = 16
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
P_LEAF2, P_SUBP = 0x20, 0x40
F_BIGDATA, F_SUBDATA, F_DUPDATA = 0x01, 0x02, 0x04
P_INVALID = 0xFFFFFFFFFFFFFFFF

_DB_STRUCT = struct.Struct("<IHHQQQQQ")  # pad, flags, depth, branch,
#                                          leaf, overflow, entries, root


class _Db:
    __slots__ = ("pad", "flags", "depth", "branch_pages", "leaf_pages",
                 "overflow_pages", "entries", "root")

    def __init__(self, data: bytes = b"\x00" * 40 + struct.pack(
            "<Q", P_INVALID)):
        (self.pad, self.flags, self.depth, self.branch_pages,
         self.leaf_pages, self.overflow_pages, self.entries,
         self.root) = _DB_STRUCT.unpack(data[:48])

    def pack(self) -> bytes:
        return _DB_STRUCT.pack(self.pad, self.flags, self.depth,
                               self.branch_pages, self.leaf_pages,
                               self.overflow_pages, self.entries,
                               self.root)


CodeRow = namedtuple("CodeRow", ["top", "bottom", "attributes",
                                 "filename"])


# --------------------------------------------------------------------------
# Reader
# --------------------------------------------------------------------------

class LMDBReader:
    """Read-only LMDB environment (``data.mdb`` inside ``path`` for
    directory environments, or ``path`` itself with ``subdir=False``)."""

    def __init__(self, path, subdir: bool = True):
        p = pathlib.Path(path)
        self._file = open(p / "data.mdb" if subdir else p, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0,
                             access=mmap.ACCESS_READ)
        meta = self._pick_meta()
        self.psize = meta["psize"]
        self.main_db = meta["main"]
        self.last_pg = meta["last_pg"]

    def close(self):
        self._mm.close()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- low-level page access ---------------------------------------------
    def _meta_at(self, off: int) -> Optional[dict]:
        m = self._mm
        magic, version = struct.unpack_from("<II", m, off + PAGEHDRSZ)
        if magic != MDB_MAGIC:
            return None
        base = off + PAGEHDRSZ + 8 + 8 + 8  # magic+version, address, mapsize
        free = _Db(m[base:base + 48])
        main = _Db(m[base + 48:base + 96])
        last_pg, txnid = struct.unpack_from("<QQ", m, base + 96)
        return {"psize": free.pad, "main": main, "last_pg": last_pg,
                "txnid": txnid}

    def _pick_meta(self) -> dict:
        m0 = self._meta_at(0)
        if m0 is None:
            raise ValueError("not an LMDB file (bad meta magic)")
        m1 = self._meta_at(m0["psize"])
        if m1 is not None and m1["txnid"] > m0["txnid"]:
            return m1
        return m0

    def _page(self, pgno: int) -> Tuple[int, int, int, int]:
        """-> (offset, flags, lower, upper)."""
        off = pgno * self.psize
        _pgno, _pad, flags, lower, upper = struct.unpack_from(
            "<QHHHH", self._mm, off)
        return off, flags, lower, upper

    def _numkeys(self, lower: int) -> int:
        return (lower - PAGEHDRSZ) >> 1

    def _node(self, page_off: int, idx: int) -> Tuple[int, int, int, bytes]:
        """-> (lo_hi (u32), flags, ksize, key)."""
        (ptr,) = struct.unpack_from("<H", self._mm,
                                    page_off + PAGEHDRSZ + 2 * idx)
        off = page_off + ptr
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", self._mm, off)
        key = bytes(self._mm[off + 8:off + 8 + ksize])
        return off, (lo | (hi << 16), flags, ksize, key)

    def _leaf_value(self, node_off: int, lo_hi: int, flags: int,
                    ksize: int) -> bytes:
        data_off = node_off + 8 + ksize
        if flags & F_BIGDATA:
            (ovpg,) = struct.unpack_from("<Q", self._mm, data_off)
            start = ovpg * self.psize + PAGEHDRSZ
            return bytes(self._mm[start:start + lo_hi])
        return bytes(self._mm[data_off:data_off + lo_hi])

    # -- B+tree operations ---------------------------------------------------
    def _descend(self, root: int, key: bytes) -> Optional[Tuple[int, int]]:
        """Find (page_off, node_idx) of `key`'s leaf node, or None."""
        pgno = root
        while True:
            off, flags, lower, upper = self._page(pgno)
            n = self._numkeys(lower)
            if flags & P_BRANCH:
                # child i covers keys >= key_i (key_0 is empty)
                lo_i, hi_i = 1, n - 1
                child = 0
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    _, (pg, nf, ks, k) = self._node(off, mid)
                    if key >= k:
                        child = mid
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                _, (lo_hi, nf, ks, _k) = self._node(off, child)
                pgno = lo_hi | (nf << 32)
            elif flags & P_LEAF:
                lo_i, hi_i = 0, n - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    _, (_lh, _nf, _ks, k) = self._node(off, mid)
                    if k == key:
                        return off, mid
                    if key > k:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return None
            else:
                raise ValueError(f"unsupported page flags 0x{flags:x}")

    def get(self, key: bytes, db: Optional[_Db] = None) -> Optional[bytes]:
        db = db or self.main_db
        if db.root == P_INVALID:
            return None
        hit = self._descend(db.root, key)
        if hit is None:
            return None
        page_off, idx = hit
        node_off, (lo_hi, flags, ksize, _k) = self._node(page_off, idx)
        if flags & F_SUBDATA:
            raise ValueError("key holds a sub-database; use open_db")
        return self._leaf_value(node_off, lo_hi, flags, ksize)

    def open_db(self, name: bytes) -> _Db:
        raw = None
        hit = (self._descend(self.main_db.root, name)
               if self.main_db.root != P_INVALID else None)
        if hit is not None:
            page_off, idx = hit
            node_off, (lo_hi, flags, ksize, _k) = self._node(page_off, idx)
            if flags & F_SUBDATA:
                raw = self._leaf_value(node_off, lo_hi, 0, ksize)
        if raw is None or len(raw) < 48:
            raise KeyError(f"no sub-database {name!r}")
        return _Db(raw)

    def items(self, db: Optional[_Db] = None
              ) -> Iterator[Tuple[bytes, bytes]]:
        """Sorted (key, value) iteration (cursor-order parity with the
        reference's ``__init_indexes``, ``lmdb_dataset.py:59-66``)."""
        db = db or self.main_db
        if db.root == P_INVALID:
            return
        stack: List[Tuple[int, int]] = [(db.root, 0)]
        while stack:
            pgno, idx = stack.pop()
            off, flags, lower, upper = self._page(pgno)
            n = self._numkeys(lower)
            if idx >= n:
                continue
            if flags & P_BRANCH:
                stack.append((pgno, idx + 1))
                _, (lo_hi, nf, _ks, _k) = self._node(off, idx)
                stack.append((lo_hi | (nf << 32), 0))
            elif flags & P_LEAF:
                for i in range(idx, n):
                    node_off, (lo_hi, nf, ks, k) = self._node(off, i)
                    if nf & F_SUBDATA:
                        continue
                    yield k, self._leaf_value(node_off, lo_hi, nf, ks)
            else:
                raise ValueError(f"unsupported page flags 0x{flags:x}")

    def keys(self, db: Optional[_Db] = None) -> List[bytes]:
        return [k for k, _ in self.items(db)]

    def stat(self, db: Optional[_Db] = None) -> Dict[str, int]:
        db = db or self.main_db
        return {"psize": self.psize, "depth": db.depth,
                "branch_pages": db.branch_pages,
                "leaf_pages": db.leaf_pages,
                "overflow_pages": db.overflow_pages,
                "entries": db.entries}


def validate_environment(path, subdir: bool = True,
                         strict_size: bool = False) -> Dict[str, int]:
    """Structural-invariant audit of an LMDB environment, independent of
    the reader's normal lookup path: checks what real liblmdb would trip
    over when opening/walking the file. Raises ``ValueError`` on the
    first violation; returns aggregate stats.

    Checked per the published ``lmdb.h``/``mdb.c`` layout:

    - both meta pages: magic, version, P_META flag, page-size sanity,
      file size >= (last_pg + 1) * psize (real liblmdb routinely
      pre-allocates ``data.mdb`` past the last used page, so trailing
      unused pages are legal; ``strict_size=True`` additionally demands
      exact equality — only valid for THIS writer's own output, which
      never over-allocates);
    - every tree page: stored pgno equals its physical page number,
      flags are exactly branch or leaf, ``lower``/``upper`` bounds sane,
      node pointers inside (lower, upper], node key+data inside the
      page;
    - keys strictly ascending within every page AND across the full
      iteration; branch separator keys <= the first key of their
      subtree;
    - per-db bookkeeping: ``entries`` / ``depth`` / ``branch_pages`` /
      ``leaf_pages`` match the walked tree; all leaves at equal depth;
    - overflow chains: P_OVERFLOW flag, page count covers the data size,
      chains inside the file.

    This is the offline half of the interop story (the py-lmdb
    cross-validation test in ``tests/test_lmdb_compat.py`` is gated on
    ``importorskip('lmdb')`` and runs wherever the C binding exists —
    it is NOT runnable in this image, so treat byte-level interop with
    real liblmdb as design-for + structurally-audited, not CI-proven).
    """
    r = LMDBReader(path, subdir=subdir)
    try:
        m = r._mm
        psize = r.psize
        if psize < 512 or psize & (psize - 1):
            raise ValueError(f"implausible page size {psize}")
        n_pages = len(m) // psize
        if len(m) % psize:
            raise ValueError("file size not a multiple of the page size")
        metas = []
        for pgno in (0, 1):
            off = pgno * psize
            _p, _pad, flags = struct.unpack_from("<QHH", m, off)[0:3]
            if not flags & P_META:
                raise ValueError(f"meta page {pgno} lacks P_META")
            meta = r._meta_at(off)
            if meta is None:
                raise ValueError(f"meta page {pgno}: bad magic")
            version = struct.unpack_from("<I", m, off + PAGEHDRSZ + 4)[0]
            if version != MDB_VERSION:
                raise ValueError(f"meta version {version}")
            metas.append(meta)
        live = max(metas, key=lambda mm: mm["txnid"])
        if live["last_pg"] > n_pages - 1:
            raise ValueError(
                f"last_pg {live['last_pg']} vs file pages {n_pages}")
        if strict_size and live["last_pg"] != n_pages - 1:
            raise ValueError(
                f"strict_size: trailing unused pages (last_pg "
                f"{live['last_pg']}, file pages {n_pages})")

        stats = {"psize": psize, "pages": n_pages, "entries": 0,
                 "dbs_checked": 0}

        def check_tree(db: _Db, what: str):
            if db.root == P_INVALID:
                if db.entries:
                    raise ValueError(f"{what}: entries but no root")
                return
            prev_key: Optional[bytes] = None
            counts = {"leaf": 0, "branch": 0, "entries": 0,
                      "overflow": 0}
            leaf_depths = set()

            def walk(pgno: int, depth: int, lo_bound: Optional[bytes]):
                nonlocal prev_key
                if pgno >= n_pages:
                    raise ValueError(f"{what}: page {pgno} out of file")
                off, flags, lower, upper = r._page(pgno)
                stored_pgno = struct.unpack_from("<Q", m, off)[0]
                if stored_pgno != pgno:
                    raise ValueError(
                        f"{what}: page {pgno} header says {stored_pgno}")
                if flags not in (P_BRANCH, P_LEAF):
                    raise ValueError(
                        f"{what}: page {pgno} flags 0x{flags:x}")
                if not (PAGEHDRSZ <= lower <= upper <= psize):
                    raise ValueError(
                        f"{what}: page {pgno} bounds {lower}/{upper}")
                n = r._numkeys(lower)
                if n == 0:
                    raise ValueError(f"{what}: empty tree page {pgno}")
                page_prev = None
                for i in range(n):
                    (ptr,) = struct.unpack_from(
                        "<H", m, off + PAGEHDRSZ + 2 * i)
                    # nodes grow downward from the page end: every node
                    # offset sits in [upper, psize)
                    if not (upper <= ptr < psize):
                        raise ValueError(
                            f"{what}: page {pgno} node ptr {ptr} "
                            f"outside [{upper}, {psize})")
                    node_off, (lo_hi, nflags, ksize, key) = r._node(off, i)
                    if node_off + 8 + ksize > off + psize:
                        raise ValueError(
                            f"{what}: page {pgno} node {i} overruns")
                    if i > 0 or flags == P_LEAF:
                        if page_prev is not None and key <= page_prev:
                            raise ValueError(
                                f"{what}: page {pgno} keys unsorted")
                        page_prev = key
                    if flags == P_BRANCH:
                        child = lo_hi | (nflags << 32)
                        walk(child, depth + 1,
                             key if i > 0 else lo_bound)
                    else:
                        counts["entries"] += 1
                        if prev_key is not None and key <= prev_key:
                            raise ValueError(
                                f"{what}: global key order broken at "
                                f"{key!r}")
                        prev_key = key
                        if i == 0 and lo_bound is not None \
                                and key < lo_bound:
                            raise ValueError(
                                f"{what}: separator > subtree first key")
                        datasize = lo_hi
                        if nflags & F_BIGDATA:
                            (ovpg,) = struct.unpack_from(
                                "<Q", m, node_off + 8 + ksize)
                            ooff, oflags, _l, _u = r._page(ovpg)
                            if not oflags & P_OVERFLOW:
                                raise ValueError(
                                    f"{what}: overflow page {ovpg} "
                                    f"flags 0x{oflags:x}")
                            (npg,) = struct.unpack_from(
                                "<I", m, ooff + 12)
                            if npg * psize < PAGEHDRSZ + datasize:
                                raise ValueError(
                                    f"{what}: overflow chain too short")
                            if ovpg + npg > n_pages:
                                raise ValueError(
                                    f"{what}: overflow chain past EOF")
                            counts["overflow"] += npg
                        elif node_off + 8 + ksize + datasize \
                                > off + psize:
                            raise ValueError(
                                f"{what}: page {pgno} value overruns")
                if flags == P_LEAF:
                    counts["leaf"] += 1
                    leaf_depths.add(depth)
                else:
                    counts["branch"] += 1

            walk(db.root, 1, None)
            if len(leaf_depths) > 1:
                raise ValueError(f"{what}: unbalanced tree {leaf_depths}")
            if counts["entries"] != db.entries:
                raise ValueError(
                    f"{what}: entries {counts['entries']} vs header "
                    f"{db.entries}")
            if leaf_depths and db.depth != max(leaf_depths):
                raise ValueError(
                    f"{what}: depth {max(leaf_depths)} vs header "
                    f"{db.depth}")
            if counts["leaf"] != db.leaf_pages \
                    or counts["branch"] != db.branch_pages:
                raise ValueError(
                    f"{what}: page counts {counts} vs header "
                    f"{db.leaf_pages}/{db.branch_pages}")
            stats["entries"] += counts["entries"]
            stats["dbs_checked"] += 1

        check_tree(r.main_db, "main")
        # named sub-databases (F_SUBDATA leaf values are MDB_db structs)
        if r.main_db.root != P_INVALID:
            stack = [(r.main_db.root, 0)]
            while stack:
                pgno, idx = stack.pop()
                off, flags, lower, upper = r._page(pgno)
                n = r._numkeys(lower)
                if idx >= n:
                    continue
                if flags & P_BRANCH:
                    stack.append((pgno, idx + 1))
                    _, (lo_hi, nf, _ks, _k) = r._node(off, idx)
                    stack.append((lo_hi | (nf << 32), 0))
                else:
                    for i in range(n):
                        _, (lo_hi, nf, ks, k) = r._node(off, i)
                        if nf & F_SUBDATA:
                            check_tree(r.open_db(k), f"subdb {k!r}")
        return stats
    finally:
        r.close()


# --------------------------------------------------------------------------
# Writer (single-transaction bottom-up bulk build)
# --------------------------------------------------------------------------

class _PageBuilder:
    """Accumulates pages; pgno 0/1 reserved for the meta pages."""

    def __init__(self, psize: int):
        self.psize = psize
        self.pages: List[bytes] = [b"", b""]  # metas patched at the end

    def alloc(self, data: bytes) -> int:
        assert len(data) == self.psize
        self.pages.append(data)
        return len(self.pages) - 1

    def alloc_many(self, blob: bytes) -> int:
        """Overflow chain: one header page + continuation pages."""
        npages = (PAGEHDRSZ + len(blob) + self.psize - 1) // self.psize
        first = len(self.pages)
        hdr = struct.pack("<QHHI", first, 0, P_OVERFLOW, npages)
        raw = hdr + blob
        raw += b"\x00" * (npages * self.psize - len(raw))
        for i in range(npages):
            self.pages.append(raw[i * self.psize:(i + 1) * self.psize])
        return first


def _node_bytes(key: bytes, lo_hi: int, flags: int, data: bytes) -> bytes:
    raw = struct.pack("<HHHH", lo_hi & 0xFFFF, (lo_hi >> 16) & 0xFFFF,
                      flags, len(key)) + key + data
    if len(raw) & 1:
        raw += b"\x00"
    return raw


def _build_page(psize: int, pgno: int, flags: int,
                nodes: Sequence[bytes]) -> bytes:
    ptrs, body = [], b""
    upper = psize
    for node in nodes:
        upper -= len(node)
        ptrs.append(upper)
    lower = PAGEHDRSZ + 2 * len(nodes)
    assert lower <= min(ptrs or [psize]), "page overflow"
    out = bytearray(psize)
    struct.pack_into("<QHHHH", out, 0, pgno, 0, flags, lower, upper)
    struct.pack_into(f"<{len(nodes)}H", out, PAGEHDRSZ, *ptrs)
    pos = psize
    for node in nodes:
        pos -= len(node)
        out[pos:pos + len(node)] = node
    return bytes(out)


def _build_tree(pb: _PageBuilder,
                items: Sequence[Tuple[bytes, int, bytes, int]]) -> _Db:
    """items: (key, datasize, inline_data, node_flags) SORTED by key.
    Values too large for a half page must already be converted to
    F_BIGDATA (datasize = true value length, inline_data = chain pgno)."""
    psize = pb.psize
    db = _Db()
    db.entries = len(items)
    if not items:
        return db
    space = psize - PAGEHDRSZ

    # -- leaves
    leaves: List[Tuple[bytes, int]] = []  # (first_key, pgno)
    cur: List[bytes] = []
    cur_first: Optional[bytes] = None
    used = 0

    def flush_leaf():
        nonlocal cur, used, cur_first
        pgno = len(pb.pages)
        pb.pages.append(_build_page(psize, pgno, P_LEAF, cur))
        leaves.append((cur_first, pgno))
        db.leaf_pages += 1
        cur, used, cur_first = [], 0, None

    for key, datasize, data, nflags in items:
        node = _node_bytes(key, datasize, nflags, data)
        cost = len(node) + 2
        if cur and used + cost > space:
            flush_leaf()
        if cur_first is None:
            cur_first = key
        cur.append(node)
        used += cost
    if cur:
        flush_leaf()

    # -- branches, bottom-up
    level = leaves
    db.depth = 1
    while len(level) > 1:
        db.depth += 1
        next_level: List[Tuple[bytes, int]] = []
        cur, used, cur_first = [], 0, None
        first_in_page = True

        def flush_branch():
            nonlocal cur, used, cur_first, first_in_page
            pgno = len(pb.pages)
            pb.pages.append(_build_page(psize, pgno, P_BRANCH, cur))
            next_level.append((cur_first, pgno))
            db.branch_pages += 1
            cur, used, cur_first, first_in_page = [], 0, None, True

        for key, child_pg in level:
            bkey = b"" if first_in_page else key
            node = _node_bytes(bkey, child_pg & 0xFFFFFFFF,
                               (child_pg >> 32) & 0xFFFF, b"")
            cost = len(node) + 2
            if cur and used + cost > space:
                flush_branch()
                bkey = b""
                node = _node_bytes(bkey, child_pg & 0xFFFFFFFF,
                                   (child_pg >> 32) & 0xFFFF, b"")
                cost = len(node) + 2
            if cur_first is None:
                cur_first = key
            cur.append(node)
            used += cost
            first_in_page = False
        if cur:
            flush_branch()
        level = next_level

    db.root = level[0][1]
    return db


class LMDBWriter:
    """Bulk-build an LMDB environment in one pass.

    ``put(key, value, db=name)`` stages entries; ``finish()`` sorts,
    builds the trees and writes ``data.mdb`` (+ an empty ``lock.mdb``
    so py-lmdb's default open succeeds)."""

    def __init__(self, path, psize: int = 4096, subdir: bool = True):
        self.path = pathlib.Path(path)
        self.psize = psize
        self.subdir = subdir
        self._dbs: Dict[Optional[bytes], Dict[bytes, bytes]] = {None: {}}

    def put(self, key: bytes, value: bytes,
            db: Optional[bytes] = None) -> None:
        self._dbs.setdefault(db, {})[key] = value

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.finish()

    def finish(self) -> None:
        pb = _PageBuilder(self.psize)
        # named sub-dbs first (their MDB_db structs land in main)
        sub_entries: Dict[bytes, bytes] = {}
        for name, entries in self._dbs.items():
            if name is None:
                continue
            before = len(pb.pages)
            staged = self._stage_entries(pb, entries)
            ov_pages = len(pb.pages) - before
            db = _build_tree(pb, staged)
            db.overflow_pages = ov_pages
            sub_entries[name] = db.pack()
        main_items = dict(self._dbs[None])
        before = len(pb.pages)
        staged = self._stage_entries(pb, main_items)
        main_ov = len(pb.pages) - before
        staged += [(name, len(raw), raw, F_SUBDATA) for name, raw in
                   sorted(sub_entries.items())]
        staged.sort(key=lambda t: t[0])
        main = _build_tree(pb, staged)
        main.overflow_pages = main_ov

        # meta pages: page 0 txnid 0 (genesis), page 1 txnid 1 (our txn)
        free = _Db()
        free.pad = self.psize
        free.flags = 0x08  # MDB_INTEGERKEY, as liblmdb sets for FREE_DBI
        last_pg = len(pb.pages) - 1
        mapsize = max((last_pg + 1) * self.psize, 1 << 20)

        def meta(pgno: int, txnid: int) -> bytes:
            out = bytearray(self.psize)
            struct.pack_into("<QHHHH", out, 0, pgno, 0, P_META, 0, 0)
            body = struct.pack("<II", MDB_MAGIC, MDB_VERSION)
            body += struct.pack("<QQ", 0, mapsize)
            body += free.pack() + (main.pack() if txnid else _Db().pack())
            body += struct.pack("<QQ", last_pg, txnid)
            out[PAGEHDRSZ:PAGEHDRSZ + len(body)] = body
            return bytes(out)

        pb.pages[0] = meta(0, 0)
        pb.pages[1] = meta(1, 1)

        if self.subdir:
            self.path.mkdir(parents=True, exist_ok=True)
            target = self.path / "data.mdb"
            (self.path / "lock.mdb").write_bytes(b"")
        else:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            target = self.path
        with open(target, "wb") as f:
            for page in pb.pages:
                f.write(page)

    def _stage_entries(self, pb, entries):
        # mdb.c: a leaf node must fit in half a page (me_nodemax);
        # larger values go to overflow chains (F_BIGDATA, whose node
        # carries the true datasize in lo/hi and the chain pgno as data)
        nodemax = ((self.psize - PAGEHDRSZ) // 2) & ~1
        staged = []
        for key, value in sorted(entries.items()):
            if not key or len(key) > 511:
                raise ValueError(f"bad key length {len(key)}")
            if 8 + len(key) + len(value) + 2 > nodemax:
                ovpg = pb.alloc_many(value)
                staged.append((key, len(value),
                               struct.pack("<Q", ovpg), F_BIGDATA))
            else:
                staged.append((key, len(value), value, 0))
        return staged


# --------------------------------------------------------------------------
# Reference CodeRow conventions
# --------------------------------------------------------------------------

class _CodeRowUnpickler(pickle.Unpickler):
    """Map the reference's pickle module paths to local equivalents, so
    reference-produced rows load without the reference on sys.path (and
    without sklearn for label encoders)."""

    def find_class(self, module, name):
        if name == "CodeRow":
            return CodeRow
        if module.startswith("sklearn") and name == "LabelEncoder":
            from .label_encoders import LabelEncoder
            return LabelEncoder
        return super().find_class(module, name)


def _loads(blob: bytes):
    return _CodeRowUnpickler(io.BytesIO(blob)).load()


class LMDBCodesDataset:
    """Reference-parity dataset over an LMDB codes environment
    (``lmdb_dataset.py:18-89``): index -> (top, bottom, attributes).
    Drop-in for ``CodemapDataset`` (read_batch / shapes / encoders), so
    trainers and the server consume reference-produced databases
    directly."""

    def __init__(self, path, classes_for_conditioning: Sequence[str] = (),
                 dataset_db_name: str = "codes"):
        import numpy as np
        from .label_encoders import load_label_encoders
        self.directory = pathlib.Path(path)
        self.reader = LMDBReader(path)
        self.codes_db = self.reader.open_db(
            dataset_db_name.encode("utf-8"))
        self._keys = self.reader.keys(self.codes_db)
        enc_path = self.directory / "label_encoders.json"
        self.label_encoders = (load_label_encoders(enc_path)
                               if enc_path.exists() else {})
        self.classes_for_conditioning = (
            list(classes_for_conditioning) if classes_for_conditioning
            else list(self.label_encoders))
        self.attribute_fields = self.classes_for_conditioning
        self.filenames = [k.decode("utf-8") for k in self._keys]
        first = self._row(0) if self._keys else None
        self.top_shape = (tuple(np.asarray(first.top).shape)
                          if first is not None else ())
        self.bottom_shape = (tuple(np.asarray(first.bottom).shape)
                             if first is not None else ())
        self.num_records = len(self._keys)

    def _row(self, index: int) -> CodeRow:
        return _loads(self.reader.get(self._keys[index], self.codes_db))

    _N_CLASS_SCAN_ROWS = 512

    def _scan_n_class(self):
        """Reference LMDB environments carry no codebook-size metadata
        (``lmdb_dataset.py`` stores only code rows), so infer the
        vocabulary from the data: max code value + 1 over a row sample,
        rounded up to the next power of two (codebooks are specified as
        powers of two; the reference hardcodes 512,
        ``train_autoregressive_model.py:532``). Rows are sampled
        UNIFORMLY at random (seeded) rather than from the head, so an
        unlucky leading block can't bias the estimate; a sampled max can
        still under-estimate a sparsely-used codebook, so ``read_batch``
        fails loudly if a later row carries a code >= the inferred
        vocabulary — pass ``--n_class`` explicitly when in doubt."""
        import numpy as np
        n = min(len(self._keys), self._N_CLASS_SCAN_ROWS)
        indexes = (np.random.default_rng(0).choice(
            len(self._keys), size=n, replace=False)
            if n < len(self._keys) else np.arange(n))
        max_t, max_b = 0, 0
        for i in indexes:
            row = self._row(int(i))
            max_t = max(max_t, int(np.asarray(row.top).max()))
            max_b = max(max_b, int(np.asarray(row.bottom).max()))

        def round_pow2(v: int) -> int:
            return 1 << (v - 1).bit_length()

        self._n_class_top = round_pow2(max_t + 1)
        self._n_class_bottom = round_pow2(max_b + 1)
        print(f"LMDB store carries no codebook metadata: inferred "
              f"n_class top={self._n_class_top} (max code {max_t}), "
              f"bottom={self._n_class_bottom} (max code {max_b}) from "
              f"{n} rows; pass --n_class to override")

    @property
    def n_class_top(self):
        if not hasattr(self, "_n_class_top"):
            self._scan_n_class()
        return self._n_class_top

    @property
    def n_class_bottom(self):
        if not hasattr(self, "_n_class_bottom"):
            self._scan_n_class()
        return self._n_class_bottom

    def __len__(self):
        return self.codes_db.entries

    def __getitem__(self, index):
        import numpy as np
        row = self._row(index)
        attributes = OrderedDict()
        for name in self.classes_for_conditioning:
            value = row.attributes[name]
            attributes[name] = np.asarray(value).reshape(1)
        return (np.asarray(row.top), np.asarray(row.bottom), attributes)

    def read_batch(self, indexes: Sequence[int]):
        """CodemapDataset.read_batch parity: stacked int64 arrays +
        per-field attribute vectors."""
        import numpy as np
        tops, bottoms, attrs = [], [], {
            name: [] for name in self.classes_for_conditioning}
        for i in indexes:
            top, bottom, a = self[i]
            tops.append(np.asarray(top, np.int64))
            bottoms.append(np.asarray(bottom, np.int64))
            for name in attrs:
                attrs[name].append(int(np.asarray(a[name]).reshape(())))
        tops_arr, bottoms_arr = np.stack(tops), np.stack(bottoms)
        # fail loudly if the sampled n_class estimate was too small: a
        # code >= the inferred vocabulary would index out of the
        # embedding table
        if hasattr(self, "_n_class_top"):
            mt, mb = int(tops_arr.max()), int(bottoms_arr.max())
            if mt >= self._n_class_top or mb >= self._n_class_bottom:
                raise ValueError(
                    f"batch carries code (top max {mt}, bottom max {mb}) "
                    f">= the n_class inferred from a row sample (top "
                    f"{self._n_class_top}, bottom {self._n_class_bottom});"
                    f" pass --n_class explicitly")
        return (tops_arr, bottoms_arr,
                {k: np.asarray(v, np.int64) for k, v in attrs.items()})


def open_codes_dataset(path, classes_for_conditioning=None, **kwargs):
    """Open a codemap database by format: the native mmap store
    (``store.json``) or a reference-produced LMDB environment
    (``data.mdb``)."""
    p = pathlib.Path(path)
    if (p / "store.json").exists():
        from .codemap_store import CodemapDataset
        return CodemapDataset(
            p, classes_for_conditioning=classes_for_conditioning, **kwargs)
    if (p / "data.mdb").exists() or p.suffix == ".mdb":
        return LMDBCodesDataset(
            p, classes_for_conditioning=classes_for_conditioning or ())
    raise FileNotFoundError(
        f"no codemap store (store.json) or LMDB environment (data.mdb) "
        f"at {p}")


def write_codes_lmdb(path, rows: Sequence[CodeRow],
                     label_encoders: Optional[Mapping] = None) -> None:
    """Produce a reference-consumable codes environment
    (``extract_code.py:42-83``'s txn.put pattern, bulk)."""
    with LMDBWriter(path) as w:
        if label_encoders is not None:
            w.put(b"label_encoders", pickle.dumps(dict(label_encoders)))
        for row in rows:
            w.put(row.filename.encode("utf-8"), pickle.dumps(row),
                  db=b"codes")


def store_to_lmdb(store_directory, lmdb_directory) -> int:
    """Convert a native CodemapStore into a reference-consumable LMDB
    environment (attributes as 1-element torch tensors when torch is
    available — the reference's ``__getitem__`` calls ``.view(1)`` on
    them, ``lmdb_dataset.py:86``). Copies ``label_encoders.json`` beside
    the environment (``extract_code.py:252-254``). Returns row count."""
    import shutil
    import numpy as np
    from .codemap_store import CodemapDataset
    try:
        import torch

        def attr(v):
            return torch.tensor([int(v)])
    except ImportError:  # pragma: no cover
        def attr(v):
            import numpy as _np
            return _np.asarray([int(v)], _np.int64)

    ds = CodemapDataset(store_directory)
    rows = []
    for i in range(len(ds)):
        top, bottom, attributes = ds[i]
        rows.append(CodeRow(
            top=np.asarray(top), bottom=np.asarray(bottom),
            attributes={k: attr(np.asarray(v).reshape(())) for k, v
                        in attributes.items()},
            filename=ds.filenames[i]))
    write_codes_lmdb(lmdb_directory, rows)
    enc = pathlib.Path(store_directory) / "label_encoders.json"
    if enc.exists():
        shutil.copy(enc, pathlib.Path(lmdb_directory)
                    / "label_encoders.json")
    return len(rows)
