"""DBIter: the user-facing MVCC iterator (copied from
toplingdb_tpu/db/db_iter.py, without user-defined timestamps,
prefix-mode iteration and the WritePrepared exclusion ranges). An entity
presents its default column through value() and all of them through
columns().

The role of RocksDB's DBIter (db/db_iter.cc): wraps a MergingIterator over
{memtable, immutables, SST levels} and collapses the internal-key stream
into the user view at a snapshot — newest visible version per user key;
tombstones (point + range) hide keys; merge chains are folded. With a
Statistics sink (`stats`, set by DB.new_iterator) it ticks the reference's
NUMBER_DB_SEEK/NEXT/PREV, NUMBER_DB_SEEK_FOUND, ITER_BYTES_READ and the
PREFETCH_HITS/MISSES of its tables' prefetch buffers. With a chunked scan
plane attached (ops/scan_plane.py, `attach_scan_plane`), forward seeks and
next() serve from its chunks; a backward step, a seek-dominated pattern or
a chunk the plane cannot take drops the plane for the per-entry path
(ITER_CHUNK_FALLBACKS).
"""

from __future__ import annotations

from toplingdb_tpu_torch.db import dbformat
from toplingdb_tpu_torch.db.dbformat import ValueType
from toplingdb_tpu_torch.utils import statistics as st
from toplingdb_tpu_torch.utils.status import Corruption, MergeInProgress


class DBIter:
    def __init__(self, internal_iter, icmp, snapshot_seq: int,
                 range_del_agg=None, merge_operator=None,
                 lower_bound: bytes | None = None,
                 upper_bound: bytes | None = None,
                 pinned=None, blob_resolver=None,
                 legacy_wce: bool = False):
        self._blob_resolver = blob_resolver
        self._legacy_wce = legacy_wce  # magic-sniff gate (pre-type DBs)
        # `pinned` keeps the source Version (and anything else) alive for the
        # iterator's lifetime so obsolete-file GC cannot delete SSTs that
        # LevelIterator children will open lazily.
        self._pinned = pinned
        self._iter = internal_iter
        self._icmp = icmp
        self._ucmp = icmp.user_comparator
        self._seq = snapshot_seq
        self._rd = range_del_agg
        self._merge_op = merge_operator
        self._lower = lower_bound
        self._upper = upper_bound
        self._valid = False
        self._key: bytes | None = None
        self._value: bytes | None = None
        self._entry_type: int | None = None  # ValueType of current entry
        self._pf_banked = (0, 0)  # prefetch (hits, misses) already ticked
        # Chunked scan plane (ops/scan_plane.py): when attached, forward
        # ops serve from its chunk cursor; backward ops and mid-stream
        # ineligible shapes degrade to the per-entry path below.
        self._plane = None
        # Access-pattern tracking for the plane: chunked decode wins for
        # scans but re-decodes blocks per seek; a seek-dominated pattern
        # (many seeks, few next() steps between them) runs faster on the
        # per-entry path, so the plane is dropped once that is established.
        self._plane_seeks = 0
        self._plane_steps = 0
        self._refresh_fn = None  # set by DB.new_iterator

    def refresh(self) -> None:
        """Rebind to the DB's current state (RocksDB's Iterator::Refresh):
        the new memtable and SST sources and the latest sequence. The
        position is invalidated: seek again, as in RocksDB."""
        if self._refresh_fn is None:
            from toplingdb_tpu_torch.utils.status import NotSupported

            raise NotSupported("iterator was not created by DB.new_iterator")
        fn = self._refresh_fn
        self.__dict__.update(fn().__dict__)
        self._refresh_fn = fn

    def attach_scan_plane(self, plane) -> None:
        self._plane = plane

    def _plane_sync(self) -> None:
        p = self._plane
        if p.is_valid:
            self._valid = True
            self._key = p.cur_key
            self._value = p.cur_value
            self._entry_type = p.cur_type
        else:
            self._valid = False

    def _plane_drop(self) -> None:
        """Deactivate the plane (direction switch / ineligible shape)."""
        self._plane = None
        self._tick(st.ITER_CHUNK_FALLBACKS)

    def _plane_position(self, user_key: bytes | None) -> bool:
        """Position the plane (None = start of keyspace); False = the plane
        bailed and the caller must run the per-entry path for this
        operation."""
        from toplingdb_tpu_torch.ops.scan_plane import PlaneIneligible

        try:
            if user_key is None:
                self._plane.seek_first()
            else:
                self._plane.seek(user_key)
        except PlaneIneligible:
            self._plane_drop()
            return False
        self._plane_sync()
        return True

    def _resume_per_entry_after(self, cur: bytes) -> None:
        """Position the per-entry path just past `cur` (the plane's last
        emitted key) after a mid-stream degrade."""
        self._seek_impl(cur)
        if self._valid and self._ucmp.compare(self._key, cur) <= 0:
            self._find_next_user_entry(skip_key=cur)

    # -- public protocol ------------------------------------------------

    def valid(self) -> bool:
        return self._valid

    def key(self) -> bytes:
        assert self._valid
        return self._key

    def raw_value(self) -> bytes:
        """The stored value WITHOUT the wide-column default-column
        unwrap."""
        assert self._valid
        return self._value

    def value(self) -> bytes:
        assert self._valid
        if self._entry_is_entity():
            # A wide-column entity presents its anonymous default column;
            # columns() gives them all.
            from toplingdb_tpu_torch.db.wide_columns import default_column_of

            return default_column_of(self._value)
        return self._value

    def _entry_is_entity(self) -> bool:
        """Typed detection (kTypeWideColumnEntity); the magic sniff only
        behind the legacy gate, for databases written before the type."""
        if self._entry_type == ValueType.WIDE_COLUMN_ENTITY:
            return True
        return self._legacy_wce and self._value[:1] == b"\x00"

    def columns(self) -> dict[bytes, bytes]:
        """All columns of the current entry (RocksDB's
        Iterator::columns(): a plain value presents as the anonymous
        default column)."""
        assert self._valid
        from toplingdb_tpu_torch.db.wide_columns import (
            DEFAULT_COLUMN,
            decode_entity,
        )

        if self._entry_is_entity():
            return decode_entity(self._value)
        return {DEFAULT_COLUMN: self._value}

    def seek_to_first(self) -> None:
        if self._plane is not None and self._plane_position(self._lower):
            self._tick_seek()
            return
        self._bank_prefetch()
        if self._lower is not None:
            self._seek_impl(self._lower)
            self._tick_seek()
            return
        self._iter.seek_to_first()
        self._find_next_user_entry(skip_key=None)
        self._tick_seek()

    def seek(self, user_key: bytes) -> None:
        if self._plane is not None:
            self._plane_seeks += 1
            if self._plane_seeks >= 16 and \
                    self._plane_steps < 64 * self._plane_seeks:
                self._plane_drop()  # seek-dominated: per-entry path wins
            else:
                uk = user_key
                if self._lower is not None \
                        and self._ucmp.compare(uk, self._lower) < 0:
                    uk = self._lower
                if self._plane_position(uk):
                    self._tick_seek()
                    return
        self._bank_prefetch()
        self._seek_impl(user_key)
        self._tick_seek()

    # -- statistics ------------------------------------------------------

    # Optional Statistics sink (set by DB.new_iterator).
    stats = None

    def _tick(self, name: str, n: int = 1) -> None:
        if self.stats is not None:
            self.stats.record_tick(name, n)

    def _tick_seek(self) -> None:
        if self.stats is not None:
            self._tick_entry_read(st.NUMBER_DB_SEEK, st.NUMBER_DB_SEEK_FOUND)

    def _tick_entry_read(self, op_name: str, found_name: str | None) -> None:
        """One iterator step's tickers: the op count + (when positioned)
        bytes read and the optional found counter."""
        self._tick(op_name)
        if self._valid:
            if found_name is not None:
                self._tick(found_name)
            self._tick(st.ITER_BYTES_READ,
                       len(self._key) + len(self._value))

    def _bank_prefetch(self) -> None:
        """Flush the internal iterator's FilePrefetchBuffer deltas into
        the PREFETCH_* tickers."""
        if self.stats is None:
            return
        pc = getattr(self._iter, "prefetch_counts", None)
        if pc is None:
            return
        h, m = pc()
        dh, dm = h - self._pf_banked[0], m - self._pf_banked[1]
        if dh or dm:
            if dh:
                self._tick(st.PREFETCH_HITS, dh)
            if dm:
                self._tick(st.PREFETCH_MISSES, dm)
            self._pf_banked = (h, m)

    def _seek_impl(self, user_key: bytes) -> None:
        if self._lower is not None and self._ucmp.compare(
                user_key, self._lower) < 0:
            user_key = self._lower
        target = dbformat.make_internal_key(
            user_key, self._seq, dbformat.VALUE_TYPE_FOR_SEEK
        )
        self._iter.seek(target)
        self._find_next_user_entry(skip_key=None)

    def seek_to_last(self) -> None:
        if self._plane is not None:
            self._plane_drop()  # backward iteration: per-entry path only
        if self._upper is not None:
            # Upper bound is exclusive: (upper, MAX_SEQ, FOR_SEEK) sorts before
            # every entry of user key `upper`, so seek_for_prev lands strictly
            # below the bound under any comparator.
            target = dbformat.make_internal_key(
                self._upper, dbformat.MAX_SEQUENCE_NUMBER,
                dbformat.VALUE_TYPE_FOR_SEEK,
            )
            self._iter.seek_for_prev(target)
            self._find_prev_user_entry()
            return
        self._iter.seek_to_last()
        self._find_prev_user_entry()

    def seek_for_prev(self, user_key: bytes) -> None:
        if self._plane is not None:
            self._plane_drop()  # backward iteration: per-entry path only
        target = dbformat.make_internal_key(user_key, 0, 0)
        # All entries for user_key sort before target's successor; position at
        # the last entry <= (user_key, seq 0): that's the oldest entry of
        # user_key or an earlier key.
        self._iter.seek_for_prev(target)
        self._find_prev_user_entry()

    def next(self) -> None:
        assert self._valid
        if self._plane is not None:
            from toplingdb_tpu_torch.ops.scan_plane import PlaneIneligible

            self._plane_steps += 1
            cur = self._key
            try:
                self._plane.advance()
            except PlaneIneligible:
                self._plane_drop()
                self._resume_per_entry_after(cur)
            else:
                self._plane_sync()
            if self.stats is not None:
                self._tick_entry_read(st.NUMBER_DB_NEXT, None)
            return
        # _iter may sit anywhere within the current user key's versions.
        self._find_next_user_entry(skip_key=self._key)
        if self.stats is not None:
            self._tick_entry_read(st.NUMBER_DB_NEXT, None)

    def prev(self) -> None:
        assert self._valid
        if self._plane is not None:
            # Direction switch: degrade to the per-entry path, positioned
            # at the plane's current key (still visible — the snapshot is
            # fixed), then run the normal backward step below.
            cur0 = self._key
            self._plane_drop()
            self._seek_impl(cur0)
        # Move internal iterator to strictly before the current user key.
        cur = self._key
        if not self._iter.valid():
            # Forward resolution (e.g. a merge chain) exhausted the internal
            # iterator; re-position at the last entry before cur's versions.
            self._iter.seek_for_prev(dbformat.make_internal_key(
                cur, dbformat.MAX_SEQUENCE_NUMBER,
                dbformat.VALUE_TYPE_FOR_SEEK
            ))
        else:
            while self._iter.valid() and self._ucmp.compare(
                dbformat.extract_user_key(self._iter.key()), cur
            ) >= 0:
                self._iter.prev()
        self._find_prev_user_entry()
        if self.stats is not None:
            self._tick_entry_read(st.NUMBER_DB_PREV, None)

    def entries(self):
        while self.valid():
            yield self.key(), self.value()
            self.next()

    # -- internals ------------------------------------------------------

    def _out_of_upper(self, uk: bytes) -> bool:
        return self._upper is not None and self._ucmp.compare(
            uk, self._upper) >= 0

    def _out_of_lower(self, uk: bytes) -> bool:
        return self._lower is not None and self._ucmp.compare(
            uk, self._lower) < 0

    def _tomb_covers(self, uk: bytes, seq: int) -> bool:
        return (
            self._rd is not None
            and self._rd.max_covering_seq(uk, self._seq) > seq
        )

    def _find_next_user_entry(self, skip_key: bytes | None) -> None:
        """Advance to the newest visible, live entry of the next user key
        (> skip_key if given)."""
        operands: list[bytes] = []
        merge_key: bytes | None = None
        while self._iter.valid():
            ikey = self._iter.key()
            uk, seq, t = dbformat.split_internal_key(ikey)
            if self._out_of_upper(uk):
                break
            if skip_key is not None and self._ucmp.compare(uk, skip_key) <= 0:
                self._iter.next()
                continue
            if seq > self._seq:
                self._iter.next()
                continue
            if merge_key is not None and self._ucmp.compare(uk, merge_key) != 0:
                # Merge chain ran to the end of this key with no base.
                self._emit_merge(merge_key, None, operands)
                return
            if self._tomb_covers(uk, seq) or t in (
                ValueType.DELETION, ValueType.SINGLE_DELETION
            ):
                if merge_key is not None:
                    self._emit_merge(merge_key, None, operands)
                    return
                skip_key = uk  # key is dead; skip all its older versions
                self._iter.next()
                continue
            if t in (ValueType.VALUE, ValueType.BLOB_INDEX,
                     ValueType.WIDE_COLUMN_ENTITY):
                v = self._iter.value()
                if t == ValueType.BLOB_INDEX:
                    v = self._resolve_blob(v)
                    t = ValueType.VALUE
                if merge_key is not None:
                    self._emit_merge(merge_key, v, operands,
                                     base_is_entity=(
                                         t == ValueType.WIDE_COLUMN_ENTITY))
                    return
                self._valid = True
                self._key = uk
                self._value = v
                self._entry_type = t
                return
            if t == ValueType.MERGE:
                if self._merge_op is None:
                    raise MergeInProgress("merge entry but no merge_operator")
                if merge_key is None:
                    merge_key = uk
                operands.append(self._iter.value())
                self._iter.next()
                continue
            raise Corruption(f"unexpected value type {t} in iterator")
        if merge_key is not None:
            self._emit_merge(merge_key, None, operands)
            return
        self._valid = False
        self._bank_prefetch()

    def _resolve_blob(self, idx: bytes) -> bytes:
        if self._blob_resolver is None:
            raise Corruption("blob index found but no blob resolver")
        return self._blob_resolver(idx)

    def _emit_merge(self, uk: bytes, base: bytes | None,
                    operands: list[bytes],
                    base_is_entity: bool = False) -> None:
        # operands collected newest→oldest.
        self._valid = True
        self._key = uk
        ops = list(reversed(operands))
        if base_is_entity:
            # Merge folds against the entity's default column; the entry
            # stays an entity.
            from toplingdb_tpu_torch.db.wide_columns import merge_into_entity

            self._value = merge_into_entity(
                base, lambda b: self._merge_op.full_merge(uk, b, ops))
            self._entry_type = ValueType.WIDE_COLUMN_ENTITY
        else:
            self._value = self._merge_op.full_merge(uk, base, ops)
            self._entry_type = ValueType.VALUE

    def _find_prev_user_entry(self) -> None:
        """Position at the newest visible, live entry of the user key at or
        before the internal iterator's position, scanning backward."""
        while self._iter.valid():
            uk = dbformat.extract_user_key(self._iter.key())
            if self._out_of_lower(uk):
                break
            if self._out_of_upper(uk):
                self._iter.prev()
                continue
            # Collect all entries of this user key; the backward walk
            # yields them lowest seq first (internal order is seq desc).
            entries: list[tuple[int, int, bytes]] = []
            while self._iter.valid():
                uk2, seq2, t2 = dbformat.split_internal_key(self._iter.key())
                if self._ucmp.compare(uk2, uk) != 0:
                    break
                if seq2 <= self._seq:
                    entries.append((seq2, t2, self._iter.value()))
                self._iter.prev()
            if self._resolve_backward(uk, entries):
                return
            # Key dead/invisible: continue scanning previous keys.
        self._valid = False
        self._bank_prefetch()

    def _resolve_backward(self, uk: bytes,
                          entries: list[tuple[int, int, bytes]]) -> bool:
        operands: list[bytes] = []
        for seq, t, val in reversed(entries):  # newest first
            if self._tomb_covers(uk, seq) or t in (
                ValueType.DELETION, ValueType.SINGLE_DELETION
            ):
                if operands:
                    self._emit_merge(uk, None, operands)
                    return True
                return False
            if t in (ValueType.VALUE, ValueType.BLOB_INDEX,
                     ValueType.WIDE_COLUMN_ENTITY):
                if t == ValueType.BLOB_INDEX:
                    val = self._resolve_blob(val)
                    t = ValueType.VALUE
                if operands:
                    self._emit_merge(uk, val, operands,
                                     base_is_entity=(
                                         t == ValueType.WIDE_COLUMN_ENTITY))
                else:
                    self._valid = True
                    self._key = uk
                    self._value = val
                    self._entry_type = t
                return True
            if t == ValueType.MERGE:
                if self._merge_op is None:
                    raise MergeInProgress("merge entry but no merge_operator")
                operands.append(val)
                continue
        if operands:
            self._emit_merge(uk, None, operands)
            return True
        return False
