"""CompactionIterator: the streaming MVCC garbage-collection state machine
(copied from toplingdb_tpu/compaction/compaction_iterator.py).

Re-expresses the semantics of RocksDB's CompactionIterator
(db/compaction/compaction_iterator.cc:475 `NextFromInput`)
in a per-user-key group form: the merged input stream (internal-key order) is
grouped by user key; within a group (versions newest→oldest) the survivors are
decided by snapshot "stripes".

Rules (with S = sorted live snapshot seqnos, stripe(seq) = index of the first
snapshot >= seq, i.e. entries in the same stripe are indistinguishable to every
snapshot):
  * Only the NEWEST entry of each stripe can survive; older same-stripe
    entries are obsolete.
  * DELETION surviving to the bottommost level is dropped entirely when no
    older version remains visible (its job is done).
  * SINGLE_DELETION annihilates together with the single older VALUE it meets
    in the same stripe; an unmatched one is kept (unless bottommost).
  * MERGE operands fold: chain ending at VALUE → full_merge(value_base);
    chain ending at DELETION in-stripe or at group end on the bottommost
    level → full_merge(None); otherwise operands partial-merge into one
    MERGE record (keeping the newest seqno) when the operator allows, else
    pass through unchanged.
  * A point entry covered by a range tombstone with tomb_seq > seq in the
    same stripe is dropped (reference CompactionRangeDelAggregator).
  * Surviving VALUEs at the bottommost level with seq below the earliest
    snapshot get their seqno zeroed (reference's seqno zeroing).
  * The compaction filter is consulted for surviving VALUEs whose seqno is
    not protected by any snapshot.

This grouped formulation is exactly what the TPU kernel implements with
vectorized segment ops (ops/compaction_kernels.py); this class is the
correctness reference for it, and the device data plane folds the complex
(MERGE / SINGLE_DELETION) groups through `_process_group`.
"""

from __future__ import annotations

import bisect

from toplingdb_tpu_torch.db import dbformat
from toplingdb_tpu_torch.db.dbformat import ValueType
from toplingdb_tpu_torch.utils.compaction_filter import Decision
from toplingdb_tpu_torch.utils.status import Corruption


class CompactionIterator:
    def __init__(self, input_iter, icmp, snapshots: list[int],
                 bottommost_level: bool = False, merge_operator=None,
                 compaction_filter=None, compaction_filter_level: int = 0,
                 range_del_agg=None, preserve_deletes: bool = False,
                 blob_resolver=None, full_history_ts_low: int = 0):
        self._blob_resolver = blob_resolver  # BLOB_INDEX payload → value
        self._input = input_iter
        self._icmp = icmp
        self._ucmp = icmp.user_comparator
        self._snapshots = sorted(snapshots)
        self._earliest_snapshot = (
            self._snapshots[0] if self._snapshots else dbformat.MAX_SEQUENCE_NUMBER
        )
        self._bottommost = bottommost_level
        self._merge_op = merge_operator
        self._filter = compaction_filter
        self._filter_level = compaction_filter_level
        self._rd = range_del_agg
        self._full_history_ts_low = full_history_ts_low
        # User-defined timestamps: groups are per ENCODED key (key+ts), so a
        # "group" is one VERSION of a logical key — bottommost tombstone
        # dropping must be disabled (the tombstone still shadows older-ts
        # versions living in other groups, and history below it must remain
        # readable). History reclamation happens only via the
        # full_history_ts_low trim in entries().
        self._ts_sz = getattr(self._ucmp, "timestamp_size", 0)
        # Counters (feed compaction stats; reference compaction_job stats).
        self.num_input_records = 0
        self.num_dropped_obsolete = 0
        self.num_dropped_tombstone = 0
        self.num_dropped_filtered = 0
        self.num_merged = 0
        self.num_single_del_pairs = 0

    # ------------------------------------------------------------------

    def _stripe(self, seq: int) -> int:
        """Snapshot stripe index; entries with equal stripe are invisible to
        every snapshot boundary between them."""
        return bisect.bisect_left(self._snapshots, seq)

    def _tomb_covers(self, user_key: bytes, seq: int) -> bool:
        """Covered by a newer range tombstone in the same stripe.

        The search must be BOUNDED BY THE ENTRY'S STRIPE: a covering
        tombstone above the next snapshot must not mask an in-stripe one
        (tombstones at seqs t1 < snap < t2 both covering the key: the entry
        at seq < t1 dies by t1 even though the global max is t2)."""
        if self._rd is None:
            return False
        stripe = self._stripe(seq)
        upper = (self._snapshots[stripe] if stripe < len(self._snapshots)
                 else dbformat.MAX_SEQUENCE_NUMBER)
        return self._rd.max_covering_seq(user_key, upper) > seq

    # ------------------------------------------------------------------

    def entries(self):
        """Yields surviving (internal_key, value) in internal-key order.
        With a ts comparator and full_history_ts_low set, versions below the
        trim point collapse to their newest (trim_history)."""
        stream = self._entries_impl()
        if self._ts_sz and self._full_history_ts_low:
            stream = trim_history(
                stream, self._full_history_ts_low, self._earliest_snapshot,
                self._bottommost, self._ts_sz, counts=self)
        yield from stream

    def _entries_impl(self):
        it = self._input
        if not it.valid():
            return
        group_key: bytes | None = None
        group: list[tuple[int, int, bytes]] = []
        while it.valid():
            ikey = it.key()
            uk, seq, t = dbformat.split_internal_key(ikey)
            self.num_input_records += 1
            if group_key is None or self._ucmp.compare(uk, group_key) != 0:
                if group_key is not None:
                    yield from self._process_group(group_key, group)
                group_key = uk
                group = []
            group.append((seq, t, it.value()))
            it.next()
        if group_key is not None:
            yield from self._process_group(group_key, group)

    # ------------------------------------------------------------------

    def _process_group(self, uk: bytes, entries: list[tuple[int, int, bytes]]):
        """entries: newest→oldest versions of one user key."""
        survivors: list[tuple[int, int, bytes]] = []
        i = 0
        n = len(entries)
        last_stripe = None
        pending_single_del: tuple[int, int, bytes] | None = None
        while i < n:
            seq, t, val = entries[i]
            stripe = self._stripe(seq)
            # Single-delete annihilation must precede the obsolete check: the
            # matching VALUE is in the same stripe by construction.
            if pending_single_del is not None:
                sd_seq, _, _ = pending_single_del
                if self._stripe(sd_seq) == stripe and t in (
                        ValueType.VALUE, ValueType.WIDE_COLUMN_ENTITY):
                    # Annihilate the pair (reference single-delete semantics).
                    self.num_single_del_pairs += 1
                    pending_single_del = None
                    last_stripe = stripe
                    i += 1
                    continue
                survivors.append(pending_single_del)
                pending_single_del = None
            # Obsolete: an entry in a stripe already served by a newer entry.
            if last_stripe is not None and stripe == last_stripe:
                self.num_dropped_obsolete += 1
                i += 1
                continue
            # Range tombstone coverage.
            if self._tomb_covers(uk, seq):
                self.num_dropped_tombstone += 1
                i += 1
                # The covered entry is deleted; the tombstone now represents
                # this stripe, so older same-stripe entries are obsolete.
                last_stripe = stripe
                continue
            if t == ValueType.MERGE:
                emitted, consumed, newest_stripe = self._fold_merge(uk, entries, i)
                survivors.extend(emitted)
                i += consumed
                last_stripe = newest_stripe
                continue
            if t == ValueType.SINGLE_DELETION:
                pending_single_del = (seq, t, val)
                last_stripe = stripe
                i += 1
                continue
            if t == ValueType.DELETION:
                if self._ts_sz or not (self._bottommost and stripe == 0):
                    survivors.append((seq, t, val))
                else:
                    self.num_dropped_tombstone += 1
                last_stripe = stripe
                i += 1
                continue
            if t in (ValueType.VALUE, ValueType.BLOB_INDEX,
                     ValueType.WIDE_COLUMN_ENTITY):
                survivors.append((seq, t, val))
                last_stripe = stripe
                i += 1
                continue
            raise Corruption(f"unexpected type {t} in compaction input")
        if pending_single_del is not None:
            sd_seq, sd_t, sd_v = pending_single_del
            if self._ts_sz or not (self._bottommost
                                   and self._stripe(sd_seq) == 0):
                survivors.append(pending_single_del)
            else:
                self.num_dropped_tombstone += 1

        # Compaction filter + seqno zeroing on the final survivors.
        out: list[tuple[int, int, bytes]] = []
        for seq, t, val in survivors:
            if (self._filter is not None and t == ValueType.VALUE
                    and seq <= self._earliest_snapshot):
                d, newv = self._filter.filter(self._filter_level, uk, val)
                if d == Decision.REMOVE:
                    self.num_dropped_filtered += 1
                    continue
                if d == Decision.CHANGE_VALUE:
                    val = newv if newv is not None else b""
            if (self._bottommost and t == ValueType.VALUE
                    and seq <= self._earliest_snapshot):
                seq = 0
            out.append((seq, t, val))
        for seq, t, val in out:
            yield dbformat.make_internal_key(uk, seq, t), val

    def _fold_merge(self, uk: bytes, entries, i: int):
        """Fold a run of MERGE operands starting at entries[i].
        Returns (emitted_entries, consumed_count, newest_stripe)."""
        newest_seq, _, _ = entries[i]
        newest_stripe = self._stripe(newest_seq)
        operands: list[bytes] = []  # newest→oldest
        j = i
        n = len(entries)
        # Collect operands in the same stripe chain. Operands in OLDER stripes
        # must stay separate (a snapshot could observe the partial chain).
        while j < n:
            seq, t, val = entries[j]
            if t != ValueType.MERGE or self._stripe(seq) != newest_stripe:
                break
            if self._tomb_covers(uk, seq):
                # Tombstone cuts the chain: operands below it are dead.
                j += 1
                while j < n and self._stripe(entries[j][0]) == newest_stripe:
                    self.num_dropped_obsolete += 1
                    j += 1
                if self._merge_op is None:
                    raise Corruption("merge entries but no merge_operator")
                v = self._merge_op.full_merge(uk, None, list(reversed(operands)))
                self.num_merged += 1
                return [(newest_seq, ValueType.VALUE, v)], j - i, newest_stripe
            operands.append(val)
            j += 1
        if self._merge_op is None:
            raise Corruption("merge entries but no merge_operator")
        # What terminated the chain?
        if j < n and self._stripe(entries[j][0]) == newest_stripe:
            seq, t, val = entries[j]
            if t in (ValueType.VALUE, ValueType.BLOB_INDEX,
                     ValueType.WIDE_COLUMN_ENTITY):
                if t == ValueType.BLOB_INDEX:
                    # The merge base lives in a blob file: fold the REAL
                    # value, never the raw index bytes.
                    if self._blob_resolver is None:
                        raise Corruption(
                            "merge over a blob value but no blob resolver"
                        )
                    val = self._blob_resolver(val)
                ops = list(reversed(operands))
                if t == ValueType.WIDE_COLUMN_ENTITY:
                    # Entity base: fold against the DEFAULT column, emit
                    # the entity back (reference MergeHelper over
                    # kTypeWideColumnEntity / wide_columns_helper).
                    from toplingdb_tpu_torch.db.wide_columns import (
                        merge_into_entity,
                    )

                    v = merge_into_entity(
                        val,
                        lambda b: self._merge_op.full_merge(uk, b, ops))
                    out_t = ValueType.WIDE_COLUMN_ENTITY
                else:
                    v = self._merge_op.full_merge(uk, val, ops)
                    out_t = ValueType.VALUE
                self.num_merged += 1
                # Consume the base too; skip the rest of the stripe.
                j += 1
                while j < n and self._stripe(entries[j][0]) == newest_stripe:
                    self.num_dropped_obsolete += 1
                    j += 1
                return [(newest_seq, out_t, v)], j - i, newest_stripe
            if t in (ValueType.DELETION, ValueType.SINGLE_DELETION):
                v = self._merge_op.full_merge(uk, None, list(reversed(operands)))
                self.num_merged += 1
                j += 1
                while j < n and self._stripe(entries[j][0]) == newest_stripe:
                    self.num_dropped_obsolete += 1
                    j += 1
                return [(newest_seq, ValueType.VALUE, v)], j - i, newest_stripe
        # Chain ran to the end of the visible group (or into an older stripe).
        if j >= n and self._bottommost:
            # Nothing older can exist anywhere: safe to finalize.
            v = self._merge_op.full_merge(uk, None, list(reversed(operands)))
            self.num_merged += 1
            return [(newest_seq, ValueType.VALUE, v)], j - i, newest_stripe
        # Cannot finalize: combine with partial_merge when possible.
        if len(operands) > 1:
            combined = operands[-1]
            ok = True
            for op in reversed(operands[:-1]):  # fold oldest→newest
                r = self._merge_op.partial_merge(uk, combined, op)
                if r is None:
                    ok = False
                    break
                combined = r
            if ok:
                self.num_merged += 1
                return [(newest_seq, ValueType.MERGE, combined)], j - i, newest_stripe
        return (
            [(s, t, v) for s, t, v in entries[i:j]],
            j - i,
            newest_stripe,
        )


def trim_history(stream, full_history_ts_low: int, earliest_snapshot: int,
                 bottommost: bool, ts_sz: int, counts=None):
    """The user-defined-timestamp history trim over a survivor stream in
    internal-key order (the host path's CompactionIterator.entries and the
    device route's stream share it): the versions of a key below
    `full_history_ts_low` collapse to the newest of them, the one visible
    at the trim point. `counts` (a CompactionIterator) takes the dropped
    rows in num_dropped_obsolete / num_dropped_tombstone."""
    low_b = dbformat.encode_ts(full_history_ts_low)
    prev_stripped: bytes | None = None
    # Seqno of the newest RETAINED below-low version of the current
    # logical key, or None. A below-low version behind it may only drop
    # when the retained one is visible to EVERY live seqno snapshot
    # (seq < earliest_snapshot) — otherwise a snapshot older than the
    # retained version still reads the one behind it.
    kept_seq: int | None = None
    for ikey, val in stream:
        uk = dbformat.extract_user_key(ikey)
        stripped, tsb = uk[:-ts_sz], uk[-ts_sz:]
        if stripped != prev_stripped:
            prev_stripped = stripped
            kept_seq = None
        # Suffixes store ~ts: suffix AFTER low_b ⇔ ts < ts_low.
        if tsb > low_b:
            # Versions come newest-ts first: the first below-low one is
            # the value visible at ts_low; later ones are unreachable
            # (reads below ts_low are outside the contract) unless a live
            # snapshot cannot yet see the retained one.
            if kept_seq is not None and kept_seq < earliest_snapshot:
                if counts is not None:
                    counts.num_dropped_obsolete += 1
                continue
            seq_e = dbformat.extract_seqno(ikey)
            t_e = dbformat.extract_value_type(ikey)
            if (bottommost and kept_seq is None
                    and t_e in (ValueType.DELETION,
                                ValueType.SINGLE_DELETION)
                    and seq_e < earliest_snapshot):
                # The key's visible-at-ts_low state is "deleted" and
                # nothing lies beneath this level: the tombstone has done
                # its job — drop it, and the kept_seq guard drops the older
                # versions it shadowed.
                if counts is not None:
                    counts.num_dropped_tombstone += 1
                kept_seq = seq_e
                continue
            kept_seq = seq_e
        yield ikey, val
