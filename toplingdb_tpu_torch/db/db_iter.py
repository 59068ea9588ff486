"""DBIter: the user-facing MVCC iterator (copied from
toplingdb_tpu/db/db_iter.py, without the WritePrepared exclusion ranges).
An entity presents its default column through value() and all of them
through columns(). With a timestamp comparator it reads as of `read_ts`:
key() is the user key, timestamp() the version's. With
`prefix_same_as_start`, a seek stops at the end of its target's prefix.

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
                 prefix_extractor=None, prefix_same_as_start: bool = False,
                 read_ts: int | None = None,
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
        # Prefix-mode iteration (RocksDB's ReadOptions.prefix_same_as_start):
        # after a seek the iterator ends with its target's prefix group.
        # Armed per seek; the total-order entry points clear it.
        self._pe = prefix_extractor if prefix_same_as_start else None
        self._prefix: bytes | None = None
        # User-defined timestamps: with a timestamp comparator the iterator
        # groups versions by the STRIPPED key, hides versions newer than
        # read_ts, and key() is the stripped key (timestamp() the
        # version's). The u64ts comparator is bytewise underneath, so
        # stripped keys compare as raw bytes.
        self._ts_sz = self._ucmp.timestamp_size
        self._read_ts_b = (dbformat.encode_ts(read_ts)
                           if self._ts_sz and read_ts is not None else None)
        self._key_full: bytes | None = None  # the stored key of the entry

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
        self._seek_impl(cur, arm_prefix=False)
        if self._valid and self._vcmp(self._key, cur) <= 0:
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

    def timestamp(self) -> int | None:
        """The current version's timestamp (timestamp DBs; else None)."""
        assert self._valid
        if not self._ts_sz:
            return None
        return dbformat.decode_ts(self._key_full[-self._ts_sz:])

    def _vkey(self, uk: bytes) -> bytes:
        """The key the user sees: the stored key with its escape and
        timestamp suffix stripped on a timestamp DB."""
        return dbformat.strip_ts(uk) if self._ts_sz else uk

    def _vcmp(self, a: bytes, b: bytes) -> int:
        """Compare two visible (stripped) keys."""
        if self._ts_sz:
            return (a > b) - (a < b)
        return self._ucmp.compare(a, b)

    def _ts_invisible(self, uk: bytes) -> bool:
        # Suffixes store ~ts, so a version newer than read_ts (invisible)
        # has a suffix that sorts BEFORE the read timestamp's.
        return (self._read_ts_b is not None
                and uk[-self._ts_sz:] < self._read_ts_b)

    def seek_to_first(self) -> None:
        # A total-order entry point: it never arms prefix mode, even when
        # a lower bound redirects it through a seek.
        self._prefix = None
        if self._plane is not None and self._plane_position(self._lower):
            self._tick_seek()
            return
        self._bank_prefetch()
        if self._lower is not None:
            self._seek_impl(self._lower, arm_prefix=False)
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
                        and self._vcmp(uk, self._lower) < 0:
                    uk = self._lower
                if self._plane_position(uk):
                    self._tick_seek()
                    return
        self._bank_prefetch()
        self._seek_impl(user_key, arm_prefix=True)
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

    def _seek_impl(self, user_key: bytes, arm_prefix: bool) -> None:
        if self._lower is not None and self._vcmp(user_key, self._lower) < 0:
            user_key = self._lower
        if arm_prefix:
            self._arm_prefix(user_key)
        if self._ts_sz:
            # Land on the newest VISIBLE version: (key, read_ts) sorts after
            # every newer version (timestamps order descending). No read_ts:
            # the newest of all (ts MAX sorts first among the versions).
            user_key = dbformat.encode_ts_key(
                user_key,
                dbformat.decode_ts(self._read_ts_b)
                if self._read_ts_b is not None else dbformat.MAX_TIMESTAMP)
        target = dbformat.make_internal_key(
            user_key, self._seq, dbformat.VALUE_TYPE_FOR_SEEK
        )
        self._iter.seek(target)
        self._find_next_user_entry(skip_key=None)

    def seek_to_last(self) -> None:
        if self._plane is not None:
            self._plane_drop()  # backward iteration: per-entry path only
        self._prefix = None
        if self._upper is not None:
            # Upper bound is exclusive: (upper, MAX_SEQ, FOR_SEEK) sorts before
            # every entry of user key `upper`, so seek_for_prev lands strictly
            # below the bound under any comparator.
            upper = self._upper
            if self._ts_sz:
                # ts MAX sorts first: the first version of `upper`.
                upper = dbformat.encode_ts_key(upper, dbformat.MAX_TIMESTAMP)
            target = dbformat.make_internal_key(
                upper, dbformat.MAX_SEQUENCE_NUMBER,
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
        self._arm_prefix(user_key)
        if self._ts_sz:
            # (key, ts=0) is the LAST version of the key.
            user_key = dbformat.encode_ts_key(user_key, 0)
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
            self._seek_impl(cur0, arm_prefix=False)
        # Move internal iterator to strictly before the current user key.
        cur = self._key  # the visible (stripped) key
        if not self._iter.valid():
            # Forward resolution (e.g. a merge chain) exhausted the internal
            # iterator; re-position at the last entry before cur's versions.
            first = (dbformat.encode_ts_key(cur, dbformat.MAX_TIMESTAMP)
                     if self._ts_sz else cur)
            self._iter.seek_for_prev(dbformat.make_internal_key(
                first, dbformat.MAX_SEQUENCE_NUMBER,
                dbformat.VALUE_TYPE_FOR_SEEK
            ))
        else:
            while self._iter.valid() and self._vcmp(
                self._vkey(dbformat.extract_user_key(self._iter.key())), cur
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

    def _arm_prefix(self, seek_key: bytes) -> None:
        self._prefix = (
            self._pe.transform(seek_key)
            if self._pe is not None and self._pe.in_domain(seek_key)
            else None
        )

    def _out_of_prefix(self, vk: bytes) -> bool:
        return self._prefix is not None and (
            not self._pe.in_domain(vk)
            or self._pe.transform(vk) != self._prefix
        )

    def _out_of_upper(self, vk: bytes) -> bool:
        return self._upper is not None and self._vcmp(vk, self._upper) >= 0

    def _out_of_lower(self, vk: bytes) -> bool:
        return self._lower is not None and self._vcmp(vk, self._lower) < 0

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
            vkey = self._vkey(uk)
            if self._out_of_upper(vkey) or self._out_of_prefix(vkey):
                break
            if skip_key is not None and self._vcmp(vkey, skip_key) <= 0:
                self._iter.next()
                continue
            if seq > self._seq or (self._ts_sz and self._ts_invisible(uk)):
                # Newer than the snapshot, or than the read timestamp.
                self._iter.next()
                continue
            if merge_key is not None and self._vcmp(vkey, merge_key) != 0:
                # Merge chain ran to the end of this key with no base.
                self._emit_merge(merge_key, None, operands)
                return
            if self._tomb_covers(uk, seq) or t in (
                ValueType.DELETION, ValueType.SINGLE_DELETION
            ):
                if merge_key is not None:
                    self._emit_merge(merge_key, None, operands)
                    return
                skip_key = vkey  # key is dead; skip all its older versions
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
                self._key = vkey
                self._key_full = uk
                self._value = v
                self._entry_type = t
                return
            if t == ValueType.MERGE:
                if self._ts_sz:
                    raise MergeInProgress(
                        "Merge is not supported with user-defined timestamps")
                if self._merge_op is None:
                    raise MergeInProgress("merge entry but no merge_operator")
                if merge_key is None:
                    merge_key = vkey
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
        # operands collected newest→oldest (never on a timestamp DB).
        self._valid = True
        self._key = uk
        self._key_full = uk
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
            vkey = self._vkey(uk)
            if self._out_of_lower(vkey) or self._out_of_prefix(vkey):
                break
            if self._out_of_upper(vkey):
                self._iter.prev()
                continue
            if self._ts_sz:
                if self._resolve_backward_ts(vkey):
                    return
                continue  # dead or invisible: keep scanning backward
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

    def _resolve_backward_ts(self, vkey: bytes) -> bool:
        """The backward step of a timestamp DB: walk every (ts, seq)
        version of the stripped key, take the newest visible one, surface
        it if it is live. The internal iterator ends strictly before the
        key's versions."""
        best = None  # (ts suffix, seq, type, value, stored key)
        while self._iter.valid():
            uk2, seq2, t2 = dbformat.split_internal_key(self._iter.key())
            if self._vkey(uk2) != vkey:
                break
            if seq2 <= self._seq and not self._ts_invisible(uk2):
                if t2 == ValueType.MERGE:
                    raise MergeInProgress(
                        "Merge is not supported with user-defined timestamps")
                # Suffixes store ~ts: the NEWEST version has the SMALLEST
                # suffix; among equal timestamps the largest seq wins.
                cand = (uk2[-self._ts_sz:], seq2, t2, self._iter.value(), uk2)
                if best is None or (cand[0], -cand[1]) < (best[0], -best[1]):
                    best = cand
            self._iter.prev()
        if best is None:
            return False
        _tsb, seq_, t_, val, full = best
        if self._tomb_covers(full, seq_) or t_ in (
                ValueType.DELETION, ValueType.SINGLE_DELETION):
            return False
        if t_ == ValueType.BLOB_INDEX:
            val = self._resolve_blob(val)
            t_ = ValueType.VALUE
        self._valid = True
        self._key = vkey
        self._key_full = full
        self._value = val
        self._entry_type = t_
        return True

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
                    self._key_full = uk
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
