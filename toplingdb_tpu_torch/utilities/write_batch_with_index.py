"""WriteBatchWithIndex: an indexed, uncommitted write buffer (copied from
toplingdb_tpu/utilities/write_batch_with_index.py).

The role of RocksDB's utilities/write_batch_with_index/, the structure
under transactions: every update is both appended to a WriteBatch (for an
atomic commit) and indexed in a sorted in-memory view, so the transaction
reads its own writes (`get_from_batch_and_db`) and iterates batch and DB
merged (`iterator_with_base`). The index rep is pluggable, as RocksDB's
WBWIFactory hook is (where ToplingDB's CSPP_WBWI plugs in): "list" is a
sorted list, "skiplist" the native arena skiplist the memtable runs on
(NotSupported without the native library), and "auto" the skiplist where
the native library loads and the list otherwise (both give the same
answers).
"""

from __future__ import annotations

import bisect

from toplingdb_tpu_torch.db.dbformat import ValueType
from toplingdb_tpu_torch.db.write_batch import WriteBatch
from toplingdb_tpu_torch.options import ReadOptions
from toplingdb_tpu_torch.utils.status import MergeInProgress


class _ListIndex:
    """Sorted-list index (the baseline WBWI rep)."""

    def __init__(self):
        self._items: list[tuple[bytes, int, int, bytes | None]] = []
        self._order = 0

    def insert(self, t: int, key: bytes, value: bytes | None) -> None:
        self._order += 1
        entry = (key, self._order, t, value)
        bisect.insort(self._items, entry, key=lambda e: (e[0], e[1]))

    def newest_first(self, key: bytes) -> list[tuple[int, bytes | None]]:
        i = bisect.bisect_left(self._items, (key, 0),
                               key=lambda e: (e[0], e[1]))
        out = []
        while i < len(self._items) and self._items[i][0] == key:
            out.append((self._items[i][2], self._items[i][3]))
            i += 1
        out.reverse()
        return out

    def keys(self) -> list[bytes]:
        out = []
        for k, _, _, _ in self._items:
            if not out or out[-1] != k:
                out.append(k)
        return out

    def clear(self) -> None:
        self._items.clear()
        self._order = 0


class _SkipIndex:
    """Native arena-skiplist index, the CSPP_WBWI analogue: the same
    native rep the memtable runs on. Entries order newest first per key
    by an inverted insertion counter."""

    _DELETES = (int(ValueType.DELETION), int(ValueType.SINGLE_DELETION))

    def __init__(self):
        from toplingdb_tpu_torch.db.memtable import NativeSkipListRep

        self._rep = NativeSkipListRep()
        self._order = 0

    def insert(self, t: int, key: bytes, value: bytes | None) -> None:
        self._order += 1
        inv = (1 << 64) - 1 - self._order  # newest sorts first
        self._rep.insert((key, inv),
                         bytes([t]) + (value if value is not None else b""))

    def newest_first(self, key: bytes) -> list[tuple[int, bytes | None]]:
        out = []
        for (uk, _inv), v in self._rep.iter_from((key, 0)):
            if uk != key:
                break
            t = v[0]
            # value-absence is derivable from the type — no marker byte.
            out.append((t, None if t in self._DELETES else bytes(v[1:])))
        return out

    def keys(self) -> list[bytes]:
        out = []
        for (uk, _inv), _v in self._rep.iter_all():
            if not out or out[-1] != uk:
                out.append(uk)
        return out

    def clear(self) -> None:
        from toplingdb_tpu_torch.db.memtable import NativeSkipListRep

        self._rep = NativeSkipListRep()
        self._order = 0


def _make_index(rep: str):
    from toplingdb_tpu_torch.utils.status import InvalidArgument, NotSupported

    if rep == "list":
        return _ListIndex()
    if rep not in ("skiplist", "auto"):
        raise InvalidArgument(f"unknown WBWI rep {rep!r}")
    from toplingdb_tpu_torch import native

    if native.lib() is None:
        if rep == "skiplist":
            raise NotSupported(
                "WBWI rep 'skiplist' needs the native library")
        return _ListIndex()  # "auto" names this choice
    return _SkipIndex()


class WriteBatchWithIndex:
    def __init__(self, merge_operator=None, rep: str = "auto"):
        self.batch = WriteBatch()
        self._merge_op = merge_operator
        self._idx = _make_index(rep)

    # -- writes ---------------------------------------------------------

    def _index(self, t: ValueType, key: bytes, value: bytes | None) -> None:
        self._idx.insert(int(t), key, value)

    def put(self, key: bytes, value: bytes) -> None:
        self.batch.put(key, value)
        self._index(ValueType.VALUE, key, value)

    def delete(self, key: bytes) -> None:
        self.batch.delete(key)
        self._index(ValueType.DELETION, key, None)

    def single_delete(self, key: bytes) -> None:
        self.batch.single_delete(key)
        self._index(ValueType.SINGLE_DELETION, key, None)

    def merge(self, key: bytes, value: bytes) -> None:
        self.batch.merge(key, value)
        self._index(ValueType.MERGE, key, value)

    def clear(self) -> None:
        self.batch.clear()
        self._idx.clear()

    def key_set(self) -> list[bytes]:
        """Distinct keys written through this batch, sorted."""
        return self._idx.keys()

    def count(self) -> int:
        return self.batch.count()

    # -- reads ----------------------------------------------------------

    def _batch_view(self, key: bytes):
        """Newest-first updates for key in this batch: [(type, value)]."""
        return self._idx.newest_first(key)

    def get_from_batch(self, key: bytes):
        """(found, value_or_None) from the batch alone; found=False means the
        batch says nothing conclusive (no entry, or an open merge chain)."""
        operands = []
        for t, v in self._batch_view(key):
            if t == int(ValueType.VALUE):
                if operands:
                    v = self._fold(key, v, operands)
                return True, v
            if t in (int(ValueType.DELETION), int(ValueType.SINGLE_DELETION)):
                if operands:
                    return True, self._fold(key, None, operands)
                return True, None
            if t == int(ValueType.MERGE):
                operands.append(v)
        if operands:
            return False, operands  # open chain: caller folds with DB value
        return False, None

    def _fold(self, key, base, operands):
        if self._merge_op is None:
            raise MergeInProgress("merge in batch but no merge_operator")
        return self._merge_op.full_merge(key, base, list(reversed(operands)))

    def get_from_batch_and_db(self, db, key: bytes,
                              opts: ReadOptions = ReadOptions()):
        found, v = self.get_from_batch(key)
        if found:
            return v
        if isinstance(v, list):  # open merge chain
            base = db.get(key, opts)
            return self._fold(key, base, v)
        return db.get(key, opts)

    def iterator_with_base(self, db, opts: ReadOptions = ReadOptions()):
        """Merged forward iteration over batch + DB (newest batch state wins;
        RocksDB's BaseDeltaIterator)."""
        db_it = db.new_iterator(opts)
        db_it.seek_to_first()
        db_pairs = list(db_it.entries())
        # Batch resolved view per key.
        batch_keys = self._idx.keys()
        merged = []
        bi = di = 0
        while bi < len(batch_keys) or di < len(db_pairs):
            if di >= len(db_pairs) or (
                bi < len(batch_keys) and batch_keys[bi] <= db_pairs[di][0]
            ):
                k = batch_keys[bi]
                skip_db = di < len(db_pairs) and db_pairs[di][0] == k
                found, v = self.get_from_batch(k)
                if found:
                    if v is not None:
                        merged.append((k, v))
                elif isinstance(v, list):
                    base = db_pairs[di][1] if skip_db else None
                    merged.append((k, self._fold(k, base, v)))
                if skip_db:
                    di += 1
                bi += 1
            else:
                merged.append(db_pairs[di])
                di += 1
        return merged
