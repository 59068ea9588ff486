"""WriteBatch: the serialized update record and WAL payload (copied from
toplingdb_tpu/db/write_batch.py, without per-entry protection).

Same wire shape as RocksDB's db/write_batch.cc:
    fixed64 sequence | fixed32 count | records*
where each record is a type byte followed by length-prefixed slices:
    VALUE            key value
    DELETION         key
    SINGLE_DELETION  key
    MERGE            key value
    RANGE_DELETION   begin_key end_key
    LOG_DATA         blob                (not counted, not applied)
A batch is the atomic unit of the write path: it is appended to the WAL as one
record and then applied to the memtable entry by entry with consecutive
sequence numbers.

Column families: non-default-CF records use the CF-prefixed record types
(0x80 | base_type) followed by a varint32 column family id, the same
scheme as RocksDB's kTypeColumnFamily* records.
"""

from __future__ import annotations

from toplingdb_tpu_torch.db.dbformat import ValueType
from toplingdb_tpu_torch.utils import coding
from toplingdb_tpu_torch.utils.status import Corruption

HEADER_SIZE = 12
_CF_FLAG = 0x80


class WriteBatch:
    def __init__(self, data: bytes | None = None):
        # _simple: only default-CF point records so far — eligible for the
        # one-call native wire-image insert (wire-loaded batches decode
        # through the parsed path, so they start non-simple). _has_wide and
        # _n_merge feed the write plane's fallback matrix (db.py
        # _native_group_commit: wide-column entities and merge-heavy
        # batches take the Python interiors).
        self._has_wide = False
        self._n_merge = 0
        if data is not None:
            if len(data) < HEADER_SIZE:
                raise Corruption("write batch header too small")
            self._rep = bytearray(data)
            self._simple = False
            self._count = coding.decode_fixed32(self._rep, 8)
        else:
            self._rep = bytearray(HEADER_SIZE)
            self._simple = True
            self._count = 0  # header count patched lazily (see data())

    # -- mutation -------------------------------------------------------

    def put(self, key: bytes, value: bytes, cf: int = 0) -> None:
        self._add_record(ValueType.VALUE, cf, key, value)

    def delete(self, key: bytes, cf: int = 0) -> None:
        self._add_record(ValueType.DELETION, cf, key)

    def single_delete(self, key: bytes, cf: int = 0) -> None:
        self._add_record(ValueType.SINGLE_DELETION, cf, key)

    def merge(self, key: bytes, value: bytes, cf: int = 0) -> None:
        self._add_record(ValueType.MERGE, cf, key, value)

    def delete_range(self, begin: bytes, end: bytes, cf: int = 0) -> None:
        self._add_record(ValueType.RANGE_DELETION, cf, begin, end)

    def put_log_data(self, blob: bytes) -> None:
        self._rep.append(ValueType.LOG_DATA)
        coding.put_length_prefixed_slice(self._rep, blob)

    def _add_record(self, t: ValueType, cf: int, *slices: bytes) -> None:
        rep = self._rep
        if t == ValueType.MERGE:
            self._n_merge += 1
        elif t == ValueType.WIDE_COLUMN_ENTITY:
            self._has_wide = True
        if cf == 0:
            rep.append(t)
            if t == ValueType.RANGE_DELETION:
                self._simple = False
        else:
            self._simple = False
            rep.append(_CF_FLAG | t)
            rep += coding.encode_varint32(cf)
        for s in slices:
            n = len(s)
            if n < 128:  # single-byte varint: the overwhelmingly common case
                rep.append(n)
                rep += s
            else:
                coding.put_length_prefixed_slice(rep, s)
        self._count += 1

    def append_from(self, other: "WriteBatch") -> None:
        """Group-commit helper: append other's records to self."""
        self._rep += other._rep[HEADER_SIZE:]
        self._count += other.count()
        self._simple = self._simple and other._simple
        self._has_wide = self._has_wide or other._has_wide
        self._n_merge += other._n_merge

    # -- header ---------------------------------------------------------

    def sequence(self) -> int:
        return coding.decode_fixed64(self._rep, 0)

    def set_sequence(self, seq: int) -> None:
        self._rep[0:8] = coding.encode_fixed64(seq)

    def count(self) -> int:
        return self._count

    def data(self) -> bytes:
        # The header count is maintained lazily; patch it on export.
        self._rep[8:12] = coding.encode_fixed32(self._count)
        return bytes(self._rep)

    def data_size(self) -> int:
        return len(self._rep)

    def is_empty(self) -> bool:
        return self.count() == 0

    # -- iteration ------------------------------------------------------

    def entries(self):
        """Yields (value_type, key, value_or_none) for the DEFAULT column
        family only. RANGE_DELETION yields (type, begin, end); LOG_DATA is
        skipped."""
        for cf, t, k, v in self.entries_cf():
            if cf == 0:
                yield t, k, v

    def entries_cf(self):
        """Yields (cf_id, value_type, key, value_or_none)."""
        rep = self._rep
        off = HEADER_SIZE
        n = 0
        while off < len(rep):
            t = rep[off]
            off += 1
            cf = 0
            if t & _CF_FLAG and t != ValueType.LOG_DATA:
                t &= ~_CF_FLAG
                cf, off = coding.decode_varint32(rep, off)
            if t in (ValueType.VALUE, ValueType.MERGE,
                     ValueType.RANGE_DELETION,
                     ValueType.WIDE_COLUMN_ENTITY):
                k, off = coding.get_length_prefixed_slice(rep, off)
                v, off = coding.get_length_prefixed_slice(rep, off)
                yield cf, t, k, v
                n += 1
            elif t in (ValueType.DELETION, ValueType.SINGLE_DELETION):
                k, off = coding.get_length_prefixed_slice(rep, off)
                yield cf, t, k, None
                n += 1
            elif t == ValueType.LOG_DATA:
                _, off = coding.get_length_prefixed_slice(rep, off)
            else:
                raise Corruption(f"unknown write batch record type {t}")
        if n != self.count():
            raise Corruption(
                f"write batch count mismatch: header {self.count()}, actual {n}"
            )

    def insert_into(self, memtable, sequence: int | None = None) -> int:
        """Apply to one memtable (single-CF) or a {cf_id: memtable} dict;
        returns the number of sequence numbers consumed (== count).
        Records for CFs absent from the dict are skipped (a dropped CF).
        Simple batches (default-CF point records only) apply through ONE
        native wire-image call (MemTable.add_encoded — no per-record
        Python); the rest run the parsed path with one native call per
        same-memtable run."""
        seq = self.sequence() if sequence is None else sequence
        is_map = isinstance(memtable, dict)
        if self._simple and self.count():
            mem0 = memtable.get(0) if is_map else memtable
            if mem0 is None:
                return self.count()  # default CF dropped: all skipped
            if mem0.add_encoded(seq, self.data()) is not None:
                return self.count()
        run_mem = None
        run_seq = seq
        run: list = []
        for cf, t, k, v in self.entries_cf():
            mem = memtable.get(cf) if is_map else memtable
            if mem is not run_mem:
                if run:
                    run_mem.add_batch(run_seq, run)
                    run = []
                run_mem = mem
                run_seq = seq
            if mem is not None:
                run.append((t, k, v))
            seq += 1
        if run and run_mem is not None:
            run_mem.add_batch(run_seq, run)
        return self.count()
