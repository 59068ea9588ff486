"""WriteBatch: the serialized update record and WAL payload (copied from
toplingdb_tpu/db/write_batch.py, with its per-entry protection).

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
from toplingdb_tpu_torch.utils import protection as _prot
from toplingdb_tpu_torch.utils.status import Corruption

HEADER_SIZE = 12
_CF_FLAG = 0x80


_NP_UNRESOLVED = object()
_np_fn = _NP_UNRESOLVED   # None once resolved-absent
_np_arr_types: dict = {}  # cap -> cached ctypes array type (hot path)


def _native_protect(rep: bytes, pb: int, strip_cf: bool):
    """Whole-batch protection vector in ONE native call (tpulsm_wb_protect;
    bit-identical to utils/protection.py), or None → Python fallback."""
    global _np_fn
    fn = _np_fn
    if fn is _NP_UNRESOLVED:
        from toplingdb_tpu_torch import native

        l = native.lib()
        fn = _np_fn = (getattr(l, "tpulsm_wb_protect", None)
                       if l is not None else None)
    if fn is None:
        return None
    cap = coding.decode_fixed32(rep, 8)
    at = _np_arr_types.get(cap)
    if at is None:
        import ctypes

        if len(_np_arr_types) > 1024:
            _np_arr_types.clear()
        at = _np_arr_types[cap] = ctypes.c_uint64 * cap
    out = at()
    rc = fn(rep, len(rep), pb, 1 if strip_cf else 0, out, cap)
    if rc < 0:
        return None  # unparseable here: the Python walk raises the error
    import numpy as np

    # Zero-copy ndarray VIEW over the ctypes buffer (rc == cap on
    # success, so the view spans it exactly and .base keeps it alive):
    # vector compares and XOR folds run at C speed, and the fused
    # memtable insert (insert_wb_prot) passes .base straight back to
    # ctypes without a data_as() crossing.
    return np.frombuffer(out, dtype=np.uint64)


def _prot_eq(a, b) -> bool:
    """Value equality of two protection vectors (list or uint64 ndarray)."""
    if type(a) is list and type(b) is list:
        return a == b
    import numpy as np

    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    return a.shape == b.shape and bool(np.array_equal(a, b))


class WriteBatch:
    def __init__(self, data: bytes | None = None,
                 protection_bytes_per_key: int = 0):
        # _simple: only default-CF point records so far — eligible for the
        # one-call native wire-image insert (wire-loaded batches decode
        # through the parsed path, so they start non-simple).
        # With protection_bytes_per_key > 0, every counted record gets a
        # per-entry checksum (utils/protection.py) computed at add time and
        # verified at the memtable-insert handoff (RocksDB's
        # protection_bytes_per_key / ProtectionInfo, db/kv_checksum.h).
        self._pb = protection_bytes_per_key
        self._prot: list[int] | None = None
        # _prot_n: record count when _prot was materialized. Staleness is
        # _prot_n != _count, so add() pays ZERO protection cost per record;
        # the vector is computed in ONE native pass at the first handoff
        # (ensure_protection at DB.write / insert) — per-record Python
        # hashing would double the write cost.
        self._prot_n = 0
        # Group-plane eligibility hints (db.py _native_group_commit):
        # wide-column entities and merge-heavy batches keep the Python
        # interiors as the oracle (the write plane's fallback matrix).
        self._has_wide = False
        self._n_merge = 0
        if data is not None:
            if len(data) < HEADER_SIZE:
                raise Corruption("write batch header too small")
            self._rep = bytearray(data)
            self._simple = False
            self._count = coding.decode_fixed32(self._rep, 8)
            if protection_bytes_per_key:
                self.attach_protection(protection_bytes_per_key)
        else:
            self._rep = bytearray(HEADER_SIZE)
            self._simple = True
            self._count = 0  # header count patched lazily (see data())
            if protection_bytes_per_key:
                self._prot = []

    # -- mutation -------------------------------------------------------

    def put(self, key: bytes, value: bytes, cf: int = 0) -> None:
        self._add_record(ValueType.VALUE, cf, key, value)

    def delete(self, key: bytes, cf: int = 0) -> None:
        self._add_record(ValueType.DELETION, cf, key)

    def single_delete(self, key: bytes, cf: int = 0) -> None:
        self._add_record(ValueType.SINGLE_DELETION, cf, key)

    def merge(self, key: bytes, value: bytes, cf: int = 0) -> None:
        self._add_record(ValueType.MERGE, cf, key, value)

    def put_entity(self, key: bytes, encoded_entity: bytes,
                   cf: int = 0) -> None:
        """Wide-column entity record (RocksDB's kTypeWideColumnEntity,
        db/write_batch.cc WriteBatch::PutEntity): the dedicated value type
        keeps plain binary values unambiguous (no magic sniffing).
        `encoded_entity` is db.wide_columns.encode_entity's encoding."""
        self._add_record(ValueType.WIDE_COLUMN_ENTITY, cf, key,
                         encoded_entity)

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
        if self._prot is not None:
            if (other._prot is not None and other._pb == self._pb
                    and self._prot_n == self._count - other.count()
                    and other._prot_n == other.count()):
                if type(self._prot) is list and type(other._prot) is list:
                    self._prot = self._prot + other._prot
                else:
                    import numpy as np

                    self._prot = np.concatenate([
                        np.asarray(self._prot, dtype=np.uint64),
                        np.asarray(other._prot, dtype=np.uint64)])
                self._prot_n = self._count
            else:
                # Mixed-protection merge (only the transient WAL image in
                # group commit): the merged copy drops protection; the
                # member batches keep theirs and are what insert verifies.
                self._prot = None

    # -- protection info (RocksDB's protection_bytes_per_key) ------------

    def attach_protection(self, protection_bytes_per_key: int) -> None:
        """Compute per-entry protection for an existing batch (wire-loaded
        batches, batches built before the DB attached them). Protection
        covers the entry from THIS point on."""
        self._pb = protection_bytes_per_key
        prots = _native_protect(self.data(), protection_bytes_per_key,
                                strip_cf=False)
        if prots is None:
            prots = []
            for cf, t, k, v in self.entries_cf():
                prots.append(_prot.truncate(
                    _prot.protect_entry(int(t), k, v, cf),
                    protection_bytes_per_key,
                ))
        self._prot = prots
        self._prot_n = self._count

    def ensure_protection(self, protection_bytes_per_key: int) -> None:
        """Materialize the protection vector if records were added since
        it was last computed (DB.write calls this BEFORE the WAL append
        and group merge, so the insert-time re-verification spans the
        whole commit path)."""
        if (self._prot is not None and self._prot_n == self._count
                and self._pb == protection_bytes_per_key):
            return
        self.attach_protection(protection_bytes_per_key or self._pb)

    def verify_protection(self) -> None:
        """Recompute every record's protection from the wire rep and
        compare with the carried values; raises Corruption on the first
        mismatch. No-op for unprotected batches (a dirty vector is
        materialized first — new records have nothing to verify against)."""
        if self._prot is None:
            return
        if self._prot_n != self._count:
            self.attach_protection(self._pb)
            return
        vec = _native_protect(self.data(), self._pb, strip_cf=False)
        if vec is not None and _prot_eq(vec, self._prot):
            return
        idx = 0
        for cf, t, k, v in self.entries_cf():
            got = _prot.truncate(_prot.protect_entry(int(t), k, v, cf),
                                 self._pb)
            if got != self._prot[idx]:
                raise Corruption(
                    f"write batch protection mismatch at record {idx} "
                    f"(cf={cf}, type={t}): entry bytes changed after add"
                )
            idx += 1
        if idx != len(self._prot):
            raise Corruption(
                f"write batch protection count mismatch: {len(self._prot)} "
                f"protected, {idx} present"
            )

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
        Records for CFs absent from the dict are skipped (dropped CF).
        Simple batches (default-CF point records only) apply through ONE
        native wire-image call (MemTable.add_encoded — no per-record
        Python); the rest run the parsed path with one GIL-releasing
        native call per same-memtable run.

        Protected batches (protection_bytes_per_key > 0) are re-hashed and
        checked against their carried protection HERE — the
        batch->memtable handoff is RocksDB's KV-checksum
        verification point — and the CF-stripped form is handed to the
        memtable to carry until flush. The re-hash is ONE native pass
        (tpulsm_wb_protect) when available, so verified simple batches
        still take the wire-image insert; without the native library the
        parsed path verifies record by record."""
        seq = self.sequence() if sequence is None else sequence
        is_map = isinstance(memtable, dict)
        mem0 = memtable.get(0) if is_map else memtable
        prots = self._prot
        verified = False
        if prots is not None and self._prot_n != self._count:
            # Records never materialized (direct insert_into callers):
            # compute now — they are covered from THIS point on.
            self.attach_protection(self._pb)
            prots = self._prot
            verified = True
        if (prots is not None and not verified and self._simple
                and self.count() and mem0 is not None):
            # Fused verify+insert: the memtable's native rep re-hashes
            # every record against `prots` in its validation pass and
            # inserts only if ALL match (raising Corruption otherwise) —
            # one native crossing instead of verify + insert as two.
            enc = getattr(mem0, "add_encoded", None)
            if enc is not None and enc(seq, self.data(), prots=prots,
                                       pb=self._pb) is not None:
                return self.count()
        if prots is not None and not verified and self.count():
            vec = _native_protect(self.data(), self._pb, strip_cf=False)
            if vec is not None:
                if not _prot_eq(vec, prots):
                    bad = next((i for i, (a, b) in enumerate(zip(vec, prots))
                                if a != b), min(len(vec), len(prots)))
                    raise Corruption(
                        f"write batch protection mismatch at record {bad} "
                        f"during memtable insert"
                    )
                verified = True
        if self._simple and self.count() and (prots is None or verified):
            if mem0 is None:
                return self.count()  # default CF dropped: all skipped
            enc = getattr(mem0, "add_encoded", None)
            if enc is not None and enc(seq, self.data(),
                                       prots=prots) is not None:
                return self.count()
        run_mem = None
        run_seq = seq
        run: list = []
        run_prots: list | None = [] if prots is not None else None
        idx = 0
        for cf, t, k, v in self.entries_cf():
            mem = memtable.get(cf) if is_map else memtable
            if mem is not run_mem:
                if run:
                    run_mem.add_batch(run_seq, run, prots=run_prots)
                    run = []
                    run_prots = [] if prots is not None else None
                run_mem = mem
                run_seq = seq
            if mem is not None:
                run.append((t, k, v))
                if prots is not None:
                    if verified and cf == 0:
                        # Native pass proved prots[idx] matches the rep;
                        # cf=0 needs no strip — carry it as-is.
                        run_prots.append(prots[idx])
                    else:
                        full = _prot.protect_entry(
                            int(t), k, v if v is not None else b"", cf)
                        if (not verified and _prot.truncate(full, self._pb)
                                != prots[idx]):
                            raise Corruption(
                                f"write batch protection mismatch at "
                                f"record {idx} (cf={cf}, type={t}) during "
                                f"memtable insert"
                            )
                        run_prots.append(_prot.truncate(
                            _prot.strip_cf(full, cf), self._pb))
            seq += 1
            idx += 1
        if run and run_mem is not None:
            run_mem.add_batch(run_seq, run, prots=run_prots)
        return self.count()
