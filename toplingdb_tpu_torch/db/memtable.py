"""MemTable: the in-memory sorted run, with pluggable representations
(copied from toplingdb_tpu/db/memtable.py, with per-entry protection).

Role matches RocksDB's MemTable (db/memtable.cc `Get`, `Add`; rep factories
at include/rocksdb/memtablerep.h). Entries are ordered by (user_key asc,
packed(seqno,type) desc) — internal key order. Range tombstones are kept in
a side list (like RocksDB's separate range_del memtable) and fragmented at
read time.

Reps:
  NativeSkipListRep — the arena skiplist in the port's native library
                      (lock-free inserts, one GIL-free call per batch).
  NativeTrieRep     — the CSPP-role adaptive radix trie in the same
                      library (per-first-byte stripes, lockless readers).
  PyVectorRep       — bisect-maintained sorted list.
  HashPrefixRep     — prefix buckets of PyVectorReps (RocksDB's hash
                      skiplist / hash linklist role).
`create_memtable_rep("skiplist" | "cspp")` raises when the native library
cannot be built or loaded; it never drops to another rep unasked.
"""

from __future__ import annotations

import bisect

from toplingdb_tpu_torch.db import dbformat
from toplingdb_tpu_torch.db.dbformat import ValueType
from toplingdb_tpu_torch.utils.status import (
    Corruption,
    InvalidArgument,
    NotSupported,
)
from toplingdb_tpu_torch.utils import concurrency as ccy

_MAX_PACKED = (1 << 64) - 1


def _sort_key(user_key: bytes, packed: int) -> tuple[bytes, int]:
    # Ascending tuple order == internal key order (seqno/type descending).
    return (user_key, _MAX_PACKED - packed)


class MemTableRep:
    """Pluggable sorted container of ((user_key, inv_packed) -> value) —
    RocksDB's MemTableRep factory seam."""

    def insert(self, skey, value: bytes) -> None:
        raise NotImplementedError

    def iter_from(self, skey):
        raise NotImplementedError

    def iter_all(self):
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    # Positional cursor protocol for MemTableIterator: each method returns
    # an opaque position or None; entry_at(pos) -> (skey, value).
    def pos_first(self):
        raise NotImplementedError

    def pos_last(self):
        raise NotImplementedError

    def pos_seek_ge(self, skey):
        raise NotImplementedError

    def pos_seek_lt(self, skey):
        raise NotImplementedError

    def pos_next(self, pos):
        raise NotImplementedError

    def entry_at(self, pos):
        raise NotImplementedError

    def memory_usage(self) -> int:
        return 0


class NativeSkipListRep(MemTableRep):
    """Arena skiplist in C++ (native/tpulsm_native.cc) — the native
    memtable (RocksDB's InlineSkipList role). Requires the native library:
    short calls go through its GIL-holding handle, batch inserts and the
    columnar export through the GIL-releasing one.

    The whole ctypes surface is symbol-parameterized (`_sym`): the trie rep
    below shares every method body, differing only in its native prefix
    and the next() call shape."""

    # Both native reps charge handed-out arena bytes (content + node
    # overhead) to the flush / WriteBufferManager budgets — RocksDB's
    # physical ApproximateMemoryUsage.
    charge_physical_memory = True
    # tpulsm_db_get and tpulsm_wb_group_commit walk this rep's handle
    # directly; the kind names its layout (0 = skiplist, 1 = trie). Reps
    # without the attribute are not native-probeable.
    _nget_mem_kind = 0
    _sym = "tpulsm_skiplist"
    _entry_sym = "node"  # {sym}_{entry_sym}(pos, ...) decodes a position
    _rep_name = "skiplist"

    def __init__(self):
        from toplingdb_tpu_torch import native

        self._l = native.pylib()
        self._cl = native.lib()
        if self._l is None or self._cl is None:
            raise NotSupported(
                f"memtable_rep={self._rep_name!r} needs the port's native "
                "library, which could not be built or loaded (g++ "
                "missing?); memtable_rep='vector' runs without it")
        self._h = getattr(self._l, self._sym + "_new")()

    def __del__(self):
        if getattr(self, "_h", None):
            getattr(self._l, self._sym + "_free")(self._h)
            self._h = None

    def _next(self, pos):
        return self._l.tpulsm_skiplist_next(pos)

    def insert(self, skey, value: bytes) -> None:
        uk, inv = skey
        getattr(self._l, self._sym + "_insert")(
            self._h, uk, len(uk), inv, value, len(value))

    def insert_wb(self, rep: bytes, first_seq: int):
        """Wire-image batch insert: ONE GIL-releasing native call parses
        the WriteBatch bytes and inserts every point record. Returns
        (count, mem_delta, deletes) or None when the native side can't
        take the batch (CF-prefixed or range records, corruption → the
        caller takes the parsed path)."""
        import ctypes

        out = (ctypes.c_int64 * 2)()
        rc = getattr(self._cl, self._sym + "_insert_wb")(
            self._h, rep, len(rep), first_seq, out)
        if rc < 0:
            return None
        return int(rc), int(out[0]), int(out[1])

    def insert_wb_prot(self, rep: bytes, first_seq: int, prots, pb: int):
        """Fused verify+insert: ONE native call re-hashes every counted
        record against the batch's carried protection vector `prots`
        (validation pass — on mismatch NOTHING is inserted and Corruption
        is raised naming the record) then inserts. Returns (count,
        mem_delta, deletes) or None when the native side can't take the
        batch (caller falls back to verify-then-insert as two steps)."""
        import ctypes

        import numpy as np

        out = (ctypes.c_int64 * 2)()
        base = getattr(prots, "base", None)
        if isinstance(base, ctypes.Array) and len(base) == len(prots):
            ptr = base  # _native_protect's buffer: no data_as() crossing
        else:
            pv = np.ascontiguousarray(prots, dtype=np.uint64)
            ptr = pv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
        rc = getattr(self._cl, self._sym + "_insert_wb_prot")(
            self._h, rep, len(rep), first_seq, ptr, len(prots), pb, out)
        if rc <= -5:
            raise Corruption(
                f"write batch protection mismatch at record {-(rc + 5)} "
                f"during memtable insert"
            )
        if rc < 0:
            return None
        return int(rc), int(out[0]), int(out[1])

    def insert_batch(self, keybuf, key_offs, key_lens, invs,
                     valbuf, val_offs, val_lens, n: int) -> None:
        """Bulk insert from flat numpy buffers — ONE ctypes call with the
        GIL released for the whole loop, so concurrent writer threads run
        truly in parallel."""
        import ctypes

        from toplingdb_tpu_torch import native

        getattr(self._cl, self._sym + "_insert_batch")(
            self._h, native.np_u8p(keybuf), native.np_i64p(key_offs),
            native.np_i32p(key_lens),
            invs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            native.np_u8p(valbuf), native.np_i64p(val_offs),
            native.np_i32p(val_lens), n,
        )

    def __len__(self) -> int:
        return getattr(self._l, self._sym + "_count")(self._h)

    def memory_usage(self) -> int:
        return getattr(self._l, self._sym + "_memory")(self._h)

    def export_columnar(self):
        """Whole-rep ordered export in ONE GIL-releasing native call:
        returns (kv: ColumnarKV with INTERNAL keys, seqs u64, vtypes i32)
        or None when it does not fit the int32 ColumnarKV offsets. Caller
        must guarantee no concurrent inserts (flush runs on an immutable
        memtable)."""
        import ctypes

        import numpy as np

        from toplingdb_tpu_torch import native
        from toplingdb_tpu_torch.ops.columnar_io import ColumnarKV

        fn = getattr(self._cl, self._sym + "_export")
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        sizes = np.zeros(3, dtype=np.int64)
        rows = fn(
            self._h, ctypes.cast(None, u8p), None, None,
            ctypes.cast(None, u64p), None, ctypes.cast(None, u8p), None,
            None, 0, native.np_i64p(sizes),
        )
        if rows < 0 or sizes[0] > 2 ** 31 - 8 or sizes[1] > 2 ** 31 - 8:
            return None  # int32 ColumnarKV offset budget
        key_buf = np.empty(int(sizes[0]), dtype=np.uint8)
        val_buf = np.empty(int(sizes[1]), dtype=np.uint8)
        # The export fills int64 offsets (matching its C signature); the
        # ColumnarKV convention is int32 — converted after the call.
        key_offs = np.empty(rows, dtype=np.int64)
        key_lens = np.empty(rows, dtype=np.int32)
        val_offs = np.empty(rows, dtype=np.int64)
        val_lens = np.empty(rows, dtype=np.int32)
        seqs = np.empty(rows, dtype=np.uint64)
        vtypes = np.empty(rows, dtype=np.int32)
        got = fn(
            self._h, native.np_u8p(key_buf), native.np_i64p(key_offs),
            native.np_i32p(key_lens), seqs.ctypes.data_as(u64p),
            native.np_i32p(vtypes), native.np_u8p(val_buf),
            native.np_i64p(val_offs), native.np_i32p(val_lens), rows,
            native.np_i64p(sizes),
        )
        if got != rows:
            return None  # concurrent mutation — caller uses the slow path
        kv = ColumnarKV(key_buf, key_offs.astype(np.int32),
                        key_lens, val_buf, val_offs.astype(np.int32),
                        val_lens)
        return kv, seqs, vtypes

    def _node_entry(self, node):
        import ctypes

        kptr = ctypes.c_void_p()
        klen = ctypes.c_uint32()
        inv = ctypes.c_uint64()
        vptr = ctypes.c_void_p()
        vlen = ctypes.c_uint32()
        getattr(self._l, f"{self._sym}_{self._entry_sym}")(
            node, ctypes.byref(kptr), ctypes.byref(klen), ctypes.byref(inv),
            ctypes.byref(vptr), ctypes.byref(vlen),
        )
        uk = ctypes.string_at(kptr, klen.value)
        val = ctypes.string_at(vptr, vlen.value)
        return (uk, inv.value), val

    def iter_from(self, skey):
        uk, inv = skey
        node = getattr(self._l, self._sym + "_seek_ge")(
            self._h, uk, len(uk), inv)
        while node:
            yield self._node_entry(node)
            node = self._next(node)

    def iter_all(self):
        node = getattr(self._l, self._sym + "_first")(self._h)
        while node:
            yield self._node_entry(node)
            node = self._next(node)

    def pos_first(self):
        return getattr(self._l, self._sym + "_first")(self._h) or None

    def pos_last(self):
        return getattr(self._l, self._sym + "_last")(self._h) or None

    def pos_seek_ge(self, skey):
        uk, inv = skey
        return getattr(self._l, self._sym + "_seek_ge")(
            self._h, uk, len(uk), inv) or None

    def pos_seek_lt(self, skey):
        uk, inv = skey
        return getattr(self._l, self._sym + "_seek_lt")(
            self._h, uk, len(uk), inv) or None

    def pos_next(self, pos):
        return self._next(pos) or None

    def entry_at(self, pos):
        return self._node_entry(pos)


class NativeTrieRep(NativeSkipListRep):
    """Adaptive-radix-trie memtable in C++ — the CSPP role (Topling's
    Crash-Safe Parallel Patricia trie, the 45M ops/s write-path headline;
    factory seam memtablerep.h:309): 257 first-byte-striped ART roots
    (4/16/48/256-way nodes, path compression), per-stripe mutexes so
    concurrent writers on different key regions never contend; versions
    hang off one leaf per user key as release-published atomic lists
    (lockless readers). Like the skiplist it raises NotSupported without
    the native library."""

    _nget_mem_kind = 1  # TrieRep* layout
    _sym = "tpulsm_trie"
    _entry_sym = "ver"
    _rep_name = "cspp"

    def _next(self, pos):
        # The trie successor re-descends from the root: needs the handle.
        return self._l.tpulsm_trie_next(self._h, pos)


class PyVectorRep(MemTableRep):
    """Entries are stored as single (sort_key, value) tuples in ONE list so
    every insert is a single list mutation — atomic under the GIL — and
    lockless readers can never observe a key paired with the wrong value."""

    def __init__(self):
        self._items: list[tuple[tuple[bytes, int], bytes]] = []

    def insert(self, skey, value: bytes) -> None:
        i = bisect.bisect_left(self._items, skey, key=lambda it: it[0])
        if i < len(self._items) and self._items[i][0] == skey:
            # Same (user_key, seqno, type) re-inserted (WAL replay): last wins.
            self._items[i] = (skey, value)
            return
        self._items.insert(i, (skey, value))

    def iter_from(self, skey):
        i = bisect.bisect_left(self._items, skey, key=lambda it: it[0])
        while i < len(self._items):
            yield self._items[i]
            i += 1

    def iter_all(self):
        yield from self._items

    def __len__(self) -> int:
        return len(self._items)

    # Positions are sort keys (re-bisected per step): list shifts from
    # concurrent inserts cannot skip or repeat entries.
    def _at(self, i: int):
        return self._items[i][0] if 0 <= i < len(self._items) else None

    def pos_first(self):
        return self._at(0)

    def pos_last(self):
        return self._at(len(self._items) - 1)

    def pos_seek_ge(self, skey):
        return self._at(bisect.bisect_left(self._items, skey, key=lambda e: e[0]))

    def pos_seek_lt(self, skey):
        return self._at(bisect.bisect_left(self._items, skey, key=lambda e: e[0]) - 1)

    def pos_next(self, pos):
        return self._at(bisect.bisect_right(self._items, pos, key=lambda e: e[0]))

    def entry_at(self, pos):
        # bisect + index are two steps; a concurrent insert between them can
        # shift the list. Entries are never removed, so re-checking the key
        # and re-bisecting converges.
        while True:
            i = bisect.bisect_left(self._items, pos, key=lambda e: e[0])
            entry = self._items[i]
            if entry[0] == pos:
                return entry


class HashPrefixRep(MemTableRep):
    """Prefix-bucketed rep (RocksDB's HashSkipListRep / HashLinkListRep,
    memtable/hash_skiplist_rep.cc:22, hash_linklist_rep.cc:160): entries
    bucket by the user key's leading `prefix_len` bytes, so point lookups
    touch one small bucket. Because the bucket key is a LEADING slice of the
    sort key, buckets are contiguous spans of the global order — full
    iteration is sorted-bucket concatenation, not an N-way merge."""

    def __init__(self, prefix_len: int = 8):
        self._plen = prefix_len
        self._buckets: dict[bytes, PyVectorRep] = {}
        # Only WRITERS (serialized by the memtable write lock) replace this
        # list, and they swap in a fully-built one — lockless readers always
        # see a consistent snapshot and never mutate shared state.
        self._sorted: list[bytes] = []
        self._n = 0

    def _pfx(self, skey) -> bytes:
        return skey[0][: self._plen]

    def _prefixes(self) -> list[bytes]:
        return self._sorted

    def insert(self, skey, value: bytes) -> None:
        p = self._pfx(skey)
        b = self._buckets.get(p)
        if b is None:
            b = self._buckets[p] = PyVectorRep()
            self._sorted = sorted(self._buckets)  # atomic swap for readers
        before = len(b)
        b.insert(skey, value)
        self._n += len(b) - before

    def iter_from(self, skey):
        sp = self._prefixes()
        p = self._pfx(skey)
        i = bisect.bisect_left(sp, p)
        if i < len(sp) and sp[i] == p:
            yield from self._buckets[p].iter_from(skey)
            i += 1
        for j in range(i, len(sp)):
            yield from self._buckets[sp[j]].iter_all()

    def iter_all(self):
        for p in self._prefixes():
            yield from self._buckets[p].iter_all()

    def __len__(self) -> int:
        return self._n

    def pos_first(self):
        for p in self._prefixes():
            pos = self._buckets[p].pos_first()
            if pos is not None:
                return pos
        return None

    def pos_last(self):
        for p in reversed(self._prefixes()):
            pos = self._buckets[p].pos_last()
            if pos is not None:
                return pos
        return None

    def pos_seek_ge(self, skey):
        sp = self._prefixes()
        p = self._pfx(skey)
        i = bisect.bisect_left(sp, p)
        while i < len(sp):
            b = self._buckets[sp[i]]
            pos = b.pos_seek_ge(skey) if sp[i] == p else b.pos_first()
            if pos is not None:
                return pos
            i += 1
        return None

    def pos_seek_lt(self, skey):
        sp = self._prefixes()
        p = self._pfx(skey)
        i = bisect.bisect_left(sp, p)
        if i < len(sp) and sp[i] == p:
            pos = self._buckets[p].pos_seek_lt(skey)
            if pos is not None:
                return pos
        i -= 1
        while i >= 0:
            pos = self._buckets[sp[i]].pos_last()
            if pos is not None:
                return pos
            i -= 1
        return None

    def pos_next(self, pos):
        p = self._pfx(pos)
        nxt = self._buckets[p].pos_next(pos)
        if nxt is not None:
            return nxt
        sp = self._prefixes()
        i = bisect.bisect_right(sp, p)
        while i < len(sp):
            q = self._buckets[sp[i]].pos_first()
            if q is not None:
                return q
            i += 1
        return None

    def entry_at(self, pos):
        return self._buckets[self._pfx(pos)].entry_at(pos)

    def memory_usage(self) -> int:
        return sum(b.memory_usage() for b in self._buckets.values())


def create_memtable_rep(name: str) -> MemTableRep:
    """Factory seam (RocksDB's memtablerep.h:309): 'vector' | 'skiplist' |
    'cspp' ('trie', 'patricia') | 'hash_skiplist' ('hash_linklist',
    'prefix_hash', each with an optional ':N' prefix length). The native
    reps raise NotSupported when the native library is unavailable; none
    drops to another rep unasked."""
    if name == "vector":
        return PyVectorRep()
    if name == "skiplist":
        return NativeSkipListRep()
    if name in ("cspp", "trie", "patricia"):
        return NativeTrieRep()
    if name in ("hash_skiplist", "hash_linklist", "prefix_hash"):
        return HashPrefixRep()
    if name.startswith(("hash_skiplist:", "hash_linklist:", "prefix_hash:")):
        # 'hash_skiplist:N' buckets by an N-byte prefix (matches a
        # FixedPrefixTransform(N) CF extractor).
        try:
            plen = int(name.split(":", 1)[1])
        except ValueError as e:
            raise InvalidArgument(
                f"bad memtable rep prefix len in {name!r}") from e
        if plen <= 0:
            raise InvalidArgument(
                f"memtable rep prefix len must be positive: {name!r}")
        return HashPrefixRep(prefix_len=plen)
    raise InvalidArgument(f"unknown memtable rep {name!r}")


class MemTable:
    def __init__(self, icmp: dbformat.InternalKeyComparator,
                 rep: MemTableRep | None = None,
                 protection_bytes: int = 0):
        self._icmp = icmp
        self._rep = rep if rep is not None else PyVectorRep()
        self._range_dels: list[tuple[int, bytes, bytes]] = []  # (seq, begin, end)
        self._mem_usage = 0
        self._num_entries = 0
        self._num_deletes = 0
        self._lock = ccy.Lock("memtable.MemTable._lock")
        # Per-entry protection carry (RocksDB's memtable KV checksums,
        # db/kv_checksum.h): CF-stripped truncated checksums keyed by the
        # rep's sort key, verified when flush re-reads the entry out of
        # the (native) rep — the memtable->flush handoff check.
        self.protection_bytes = protection_bytes
        self._prot: dict | None = {} if protection_bytes else None
        self._rd_prot: dict | None = {} if protection_bytes else None
        # Wire-image inserts defer per-record bookkeeping: (first_seq,
        # rep, prots) tuples drain into _prot lazily at the first flush
        # lookup (_drain_prot_pending) — the write path stays native.
        self._prot_pending: list = []

    # ------------------------------------------------------------------

    def add(self, seq: int, t: int, user_key: bytes, value: bytes,
            prot: int | None = None) -> None:
        with self._lock:
            if t == ValueType.RANGE_DELETION:
                if self._icmp.user_comparator.compare(user_key, value) >= 0:
                    # Empty range [begin >= end): deletes nothing, and a
                    # memtable holding ONLY degenerate tombstones would
                    # otherwise flush a boundless empty table.
                    return
                self._range_dels.append((seq, user_key, value))
                if self._rd_prot is not None:
                    self._rd_prot[(seq, user_key, value)] = \
                        self._entry_prot(t, user_key, value, prot)
            else:
                packed = dbformat.pack_seq_type(seq, t)
                skey = _sort_key(user_key, packed)
                self._rep.insert(skey, value)
                if self._prot is not None:
                    self._prot[skey] = self._entry_prot(
                        t, user_key, value, prot)
            self._num_entries += 1
            if t in (ValueType.DELETION, ValueType.SINGLE_DELETION):
                self._num_deletes += 1
            self._mem_usage += len(user_key) + len(value) + 24

    def _entry_prot(self, t: int, user_key: bytes, value: bytes,
                    prot: int | None) -> int:
        """The CF-stripped truncated checksum to carry: the one handed
        down by WriteBatch.insert_into (already verified there), or a
        fresh one for direct add() callers."""
        if prot is not None:
            return prot
        from toplingdb_tpu_torch.utils import protection as _p

        return _p.truncate(_p.protect_entry(int(t), user_key, value),
                           self.protection_bytes)

    def add_encoded(self, first_seq: int, rep: bytes,
                    prots=None, pb: int = 0) -> int | None:
        """Apply a whole WriteBatch wire image in one native call (the
        WriteBatchInternal::InsertInto hot loop with zero per-record
        Python). Returns the count applied, or None when the native fast
        path can't take it (caller uses the parsed path). Thread-safe
        against concurrent add/add_batch/add_encoded callers.

        Protected memtables take this path too when the caller hands the
        batch's CF-stripped checksums: the (rep, prots) pair parks in
        _prot_pending and drains into the per-entry map lazily at flush,
        keeping the write path native. With pb > 0 the checksums are NOT
        yet verified — the fused native call (insert_wb_prot) re-hashes
        every record against them in its validation pass and raises
        Corruption (nothing inserted) on the first mismatch; pb == 0
        means the caller already verified them."""
        if self._prot is not None and prots is None:
            return None  # nothing to carry: the parsed path computes them
        if prots is not None and pb:
            wbp = getattr(self._rep, "insert_wb_prot", None)
            if wbp is None:
                return None
            res = wbp(rep, first_seq, prots, pb)  # raises on mismatch
        else:
            wb = getattr(self._rep, "insert_wb", None)
            if wb is None:
                return None
            res = wb(rep, first_seq)
        if res is None:
            return None
        count, delta, deletes = res
        with self._lock:
            if self._prot is not None:
                self._prot_pending.append((first_seq, rep, prots))
            self._num_entries += count
            self._num_deletes += deletes
            self._mem_usage += delta
        return count

    def group_handle(self):
        """(native_rep_handle, kind) for the fused group-commit plane
        (db.py _native_group_commit; kind 0 = skiplist, 1 = trie), or None
        when this rep has no native handle (pure-Python reps)."""
        rep = self._rep
        kind = getattr(rep, "_nget_mem_kind", None)
        h = getattr(rep, "_h", None)
        if kind is None or not h:
            return None
        return h, kind

    def note_group_applied(self, entries_meta, mem_delta: int,
                           deletes: int, total: int) -> None:
        """Bookkeeping for a whole write group the native plane already
        applied straight into the rep (tpulsm_wb_group_commit):
        entries_meta is [(first_seq, rep_bytes, prots_or_None)] per member
        batch — protected members park in _prot_pending exactly like
        add_encoded's wire-image deferral, so flush verification sees the
        same carried checksums either way."""
        with self._lock:
            if self._prot is not None:
                for fs, rep, prots in entries_meta:
                    self._prot_pending.append((fs, rep, prots))
            self._num_entries += total
            self._num_deletes += deletes
            self._mem_usage += mem_delta

    def add_batch(self, first_seq: int, ops, prots=None) -> int:
        """Apply a run of parsed ops [(type, key, value_or_None)] with
        consecutive seqnos starting at first_seq (RocksDB's
        WriteBatchInternal::InsertInto driving InsertConcurrently). With a
        native rep (skiplist or trie) the point inserts happen in ONE
        GIL-releasing native call; thread-safe against concurrent add/add_batch callers.
        `prots`, when given, carries one CF-stripped protection checksum
        per op (WriteBatch.insert_into already verified them).
        Returns the number of sequence numbers consumed (== len(ops))."""
        n = len(ops)
        rep_batch = getattr(self._rep, "insert_batch", None)
        if rep_batch is None or n < 4:
            for i, (t, k, v) in enumerate(ops):
                self.add(first_seq + i, t, k, v if v is not None else b"",
                         prot=prots[i] if prots is not None else None)
            return n
        import numpy as np

        points = []   # (seq, t, k, v) point ops, in order
        mem_delta = 0
        deletes = 0
        with self._lock:
            for i, (t, k, v) in enumerate(ops):
                seq = first_seq + i
                v = v if v is not None else b""
                if t == ValueType.RANGE_DELETION:
                    if self._icmp.user_comparator.compare(k, v) >= 0:
                        continue
                    self._range_dels.append((seq, k, v))
                    if self._rd_prot is not None:
                        self._rd_prot[(seq, k, v)] = self._entry_prot(
                            t, k, v,
                            prots[i] if prots is not None else None)
                else:
                    points.append((seq, t, k, v))
                    if self._prot is not None:
                        self._prot[_sort_key(
                            k, dbformat.pack_seq_type(seq, t))] = \
                            self._entry_prot(
                                t, k, v,
                                prots[i] if prots is not None else None)
                if t in (ValueType.DELETION, ValueType.SINGLE_DELETION):
                    deletes += 1
                mem_delta += len(k) + len(v) + 24
            self._num_entries += n
            self._num_deletes += deletes
            self._mem_usage += mem_delta
        if not points:
            return n
        m = len(points)
        key_lens = np.fromiter((len(p[2]) for p in points), np.int32, m)
        val_lens = np.fromiter((len(p[3]) for p in points), np.int32, m)
        key_offs = np.zeros(m, np.int64)
        val_offs = np.zeros(m, np.int64)
        np.cumsum(key_lens[:-1], out=key_offs[1:])
        np.cumsum(val_lens[:-1], out=val_offs[1:])
        keybuf = np.frombuffer(
            b"".join(p[2] for p in points), np.uint8).copy()
        valbuf = np.frombuffer(
            b"".join(p[3] for p in points), np.uint8).copy()
        invs = np.fromiter(
            (_MAX_PACKED - dbformat.pack_seq_type(p[0], p[1])
             for p in points), np.uint64, m)
        # Outside self._lock: the native rep is internally thread-safe, so
        # concurrent groups' inserts overlap GIL-free.
        rep_batch(keybuf, key_offs, key_lens, invs,
                  valbuf, val_offs, val_lens, m)
        return n

    def export_columnar(self):
        """Columnar flush fast path: ordered (kv, seqs, vtypes) of every
        POINT entry in one native call (range tombstones are stored aside —
        read them via range_del_entries). None when the rep can't bulk
        export; callers fall back to the per-entry iterator."""
        exp = getattr(self._rep, "export_columnar", None)
        return exp() if exp is not None else None

    def _drain_prot_pending(self) -> None:
        """Materialize checksums parked by wire-image inserts into the
        per-entry map (flush-time only: the cold side of the deferral)."""
        with self._lock:
            pending, self._prot_pending = self._prot_pending, []
        if not pending:
            return
        from toplingdb_tpu_torch.db.write_batch import WriteBatch

        for first_seq, rep, prots in pending:
            seq = first_seq
            for i, (t, k, _v) in enumerate(WriteBatch(rep).entries()):
                self._prot[_sort_key(
                    k, dbformat.pack_seq_type(seq + i, t))] = prots[i]

    def protection_map(self) -> dict | None:
        """The fully materialized per-entry checksum map (None when this
        memtable is unprotected) — the flush handoff's reference side."""
        if self._prot is None:
            return None
        self._drain_prot_pending()
        return self._prot

    def protection_aggregate(self) -> tuple[int, int] | None:
        """(count, xor) over every carried point-entry checksum WITHOUT
        parsing the pending wire images — the O(entries) integer fold the
        columnar flush compares against tpulsm_columnar_protect's export
        aggregate. Duplicate replayed entries (WAL recovery) make the
        pending count overshoot the deduplicated rep; callers treat any
        mismatch as "fall back to the per-entry map", never as proof of
        corruption on its own."""
        if self._prot is None:
            return None
        import numpy as np

        with self._lock:
            pending = list(self._prot_pending)
            acc = 0
            cnt = len(self._prot)
            for v in self._prot.values():
                acc ^= int(v)
        for _seq, _rep, prots in pending:
            cnt += len(prots)
            if isinstance(prots, np.ndarray):
                if len(prots):
                    acc ^= int(np.bitwise_xor.reduce(prots))
            else:
                for p in prots:
                    acc ^= int(p)
        return cnt, acc

    def stored_protection(self, user_key: bytes, seq: int, t: int):
        """The carried protection checksum for one point entry, or None
        (unprotected memtable / unknown entry — flush treats 'unknown'
        as corruption when protection is on)."""
        if self._prot is None:
            return None
        if self._prot_pending:
            self._drain_prot_pending()
        return self._prot.get(
            _sort_key(user_key, dbformat.pack_seq_type(seq, t)))

    def stored_rd_protection(self, seq: int, begin: bytes, end: bytes):
        if self._rd_prot is None:
            return None
        return self._rd_prot.get((seq, begin, end))

    def entries_for_key(self, user_key: bytes, snapshot_seq: int):
        """Yield (seq, type, value) for user_key with seq <= snapshot,
        newest first — the feed for GetContext."""
        start = _sort_key(user_key, dbformat.pack_seq_type(snapshot_seq, 0xFF))
        for (uk, inv), val in self._rep.iter_from(start):
            if uk != user_key:
                break
            seq, t = dbformat.unpack_seq_type(_MAX_PACKED - inv)
            if seq > snapshot_seq:
                continue
            yield seq, t, val

    def covering_tombstone_seq(self, user_key: bytes, snapshot_seq: int) -> int:
        """Max seqno of a range tombstone covering user_key at the snapshot
        (0 = none)."""
        best = 0
        ucmp = self._icmp.user_comparator
        for seq, begin, end in self._range_dels:
            if seq <= snapshot_seq and ucmp.compare(begin, user_key) <= 0 \
                    and ucmp.compare(user_key, end) < 0:
                best = max(best, seq)
        return best

    # ------------------------------------------------------------------

    def iter_entries(self):
        """Yields (internal_key, value) in internal key order (point entries
        only; range tombstones via range_del_entries)."""
        for (uk, inv), val in self._rep.iter_all():
            seq, t = dbformat.unpack_seq_type(_MAX_PACKED - inv)
            yield dbformat.make_internal_key(uk, seq, t), val

    def range_del_entries(self):
        """Yields (seq, begin_user_key, end_user_key)."""
        yield from self._range_dels

    # ------------------------------------------------------------------

    def new_iterator(self) -> "MemTableIterator":
        return MemTableIterator(self)

    def approximate_memory_usage(self) -> int:
        # Native reps (skiplist and trie) charge PHYSICAL handed-out arena
        # bytes (RocksDB's ApproximateMemoryUsage semantics), so
        # write_buffer_size and the WriteBufferManager see the real
        # footprint; the Python reps keep the logical len+24 estimate.
        if getattr(self._rep, "charge_physical_memory", False):
            rep_mem = self._rep.memory_usage()
            if rep_mem > self._mem_usage:
                return rep_mem
        return self._mem_usage

    @property
    def num_entries(self) -> int:
        return self._num_entries

    @property
    def num_deletes(self) -> int:
        return self._num_deletes

    def empty(self) -> bool:
        return self._num_entries == 0


class MemTableIterator:
    """Standard iterator protocol over a memtable's point entries, built on
    the rep's positional cursor protocol — works over both the Python vector
    rep and the native skiplist.

    Tolerates concurrent inserts: vector-rep positions are sort keys
    (re-bisected per step, the Python analogue of iterating a lock-free
    skiplist); native skiplist nodes are stable arena pointers."""

    def __init__(self, mem: MemTable):
        self._rep = mem._rep
        self._pos = None
        self._entry = None

    def _set(self, pos) -> None:
        self._pos = pos
        self._entry = self._rep.entry_at(pos) if pos is not None else None

    def valid(self) -> bool:
        return self._entry is not None

    def key(self) -> bytes:
        uk, inv = self._entry[0]
        seq, t = dbformat.unpack_seq_type(_MAX_PACKED - inv)
        return dbformat.make_internal_key(uk, seq, t)

    def value(self) -> bytes:
        return self._entry[1]

    def seek_to_first(self) -> None:
        self._set(self._rep.pos_first())

    def seek_to_last(self) -> None:
        self._set(self._rep.pos_last())

    def seek(self, ikey: bytes) -> None:
        uk, seq, t = dbformat.split_internal_key(ikey)
        self._set(self._rep.pos_seek_ge(
            _sort_key(uk, dbformat.pack_seq_type(seq, t))
        ))

    def seek_for_prev(self, ikey: bytes) -> None:
        uk, seq, t = dbformat.split_internal_key(ikey)
        skey = _sort_key(uk, dbformat.pack_seq_type(seq, t))
        pos = self._rep.pos_seek_ge(skey)
        if pos is not None and self._rep.entry_at(pos)[0] == skey:
            self._set(pos)
        else:
            self._set(self._rep.pos_seek_lt(skey))

    def next(self) -> None:
        assert self.valid()
        self._set(self._rep.pos_next(self._pos))

    def prev(self) -> None:
        assert self.valid()
        self._set(self._rep.pos_seek_lt(self._entry[0]))
