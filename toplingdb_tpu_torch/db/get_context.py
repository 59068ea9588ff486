"""GetContext: the per-lookup state machine (copied from
toplingdb_tpu/db/get_context.py, without the WritePrepared exclusion
ranges, which come with transactions).

The role of RocksDB's GetContext (table/get_context.h): sources (memtable, immutable memtables, L0 files newest→
oldest, then deeper levels) feed visible entries for the target user key in
newest→oldest order; the context tracks kNotFound → kFound/kDeleted/
kMerge-in-progress transitions, accumulates merge operands, and respects the
max covering range-tombstone seqno seen so far.
"""

from __future__ import annotations

import enum

from toplingdb_tpu_torch.db.dbformat import ValueType
from toplingdb_tpu_torch.utils.status import Corruption, MergeInProgress


class GetState(enum.Enum):
    NOT_FOUND = 0
    FOUND = 1
    DELETED = 2
    MERGE = 3       # operand chain open; keep descending into older sources
    CORRUPT = 4


class GetContext:
    def __init__(self, user_key: bytes, snapshot_seq: int, merge_operator=None,
                 blob_resolver=None, collect_operands: bool = False):
        self.user_key = user_key
        self.snapshot_seq = snapshot_seq
        self.merge_operator = merge_operator
        self.blob_resolver = blob_resolver  # BLOB_INDEX payload → real value
        self.state = GetState.NOT_FOUND
        self.value: bytes | None = None
        self.result_is_entity = False  # value is a wide-column encoding
        self.operands: list[bytes] = []   # collected newest→oldest
        self.max_covering_tombstone_seq = 0
        self.found_final_value = False
        # collect_operands (RocksDB's DB::GetMergeOperands): keep the chain
        # unfolded — same visibility/tombstone state machine, no folding,
        # no merge_operator required.
        self.collect_operands = collect_operands

    # ------------------------------------------------------------------

    def add_tombstone_seq(self, seq: int) -> None:
        """Register a range tombstone covering the key (from the current or a
        newer source)."""
        if seq <= self.snapshot_seq and seq > self.max_covering_tombstone_seq:
            self.max_covering_tombstone_seq = seq

    def save_value(self, seq: int, t: int, value: bytes) -> bool:
        """Feed one visible point entry (seq <= snapshot already filtered by
        caller, newest first). Returns False when the lookup is complete and
        no older sources need to be consulted."""
        assert not self.found_final_value
        if seq < self.max_covering_tombstone_seq:
            # Shadowed by a strictly newer range tombstone. Strict: seqnos are
            # unique per write, and seqno-zeroed entries (bottommost
            # compaction) must not be swallowed by the 0 "no tombstone"
            # sentinel.
            t = ValueType.DELETION
        if t == ValueType.BLOB_INDEX:
            if self.blob_resolver is None:
                raise Corruption("blob index found but no blob resolver")
            value = self.blob_resolver(value)
            t = ValueType.VALUE
        if t == ValueType.VALUE:
            if self.state == GetState.MERGE and not self.collect_operands:
                self.state = GetState.FOUND
                self.value = self._fold(value)
            else:
                self.state = GetState.FOUND
                self.value = value
            self.found_final_value = True
            return False
        if t == ValueType.WIDE_COLUMN_ENTITY:
            # A put of a wide-column entity (RocksDB's
            # kTypeWideColumnEntity): merge chains
            # fold against the entity's DEFAULT column, and the result
            # stays an entity with the default column replaced.
            if self.state == GetState.MERGE and not self.collect_operands:
                from toplingdb_tpu_torch.db.wide_columns import merge_into_entity

                self.state = GetState.FOUND
                self.value = merge_into_entity(
                    value, lambda base: self._fold(base))
            else:
                self.state = GetState.FOUND
                self.value = value
            self.result_is_entity = True
            self.found_final_value = True
            return False
        if t in (ValueType.DELETION, ValueType.SINGLE_DELETION):
            if self.state == GetState.MERGE:
                if self.collect_operands:
                    pass  # chain ends with no base; keep the operands
                else:
                    self.state = GetState.FOUND
                    self.value = self._fold(None)
            else:
                self.state = GetState.DELETED
            self.found_final_value = True
            return False
        if t == ValueType.MERGE:
            if self.merge_operator is None and not self.collect_operands:
                self.state = GetState.CORRUPT
                self.found_final_value = True
                return False
            self.state = GetState.MERGE
            self.operands.append(value)
            return True
        raise Corruption(f"unexpected value type {t} in lookup")

    def finish(self) -> None:
        """No more sources. Resolve an open merge chain against no base."""
        if self.state == GetState.MERGE and not self.collect_operands:
            self.value = self._fold(None)
            self.state = GetState.FOUND
            self.found_final_value = True

    def _fold(self, base: bytes | None) -> bytes:
        # operands were collected newest→oldest; full_merge wants oldest→newest.
        return self.merge_operator.full_merge(
            self.user_key, base, list(reversed(self.operands))
        )

    # ------------------------------------------------------------------

    def result(self) -> bytes | None:
        """Returns the value, or None if not found / deleted. Raises on
        merge-without-operator."""
        if self.state == GetState.CORRUPT:
            raise MergeInProgress(
                "merge operands found but no merge_operator configured"
            )
        if self.state == GetState.FOUND:
            return self.value
        return None

    def merge_operand_list(self) -> list[bytes]:
        """collect_operands result: base value (if any) first, then merge
        operands oldest→newest; [] when missing/deleted."""
        out: list[bytes] = []
        if self.state in (GetState.FOUND, GetState.MERGE) and \
                self.value is not None:
            out.append(self.value)
        out.extend(reversed(self.operands))
        return out
