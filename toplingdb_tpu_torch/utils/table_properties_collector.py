"""User table-properties collectors (copied from
toplingdb_tpu/utils/table_properties_collector.py).

RocksDB's TablePropertiesCollector / Factory role: a per-table hook that
observes every added entry, emits user properties into the table's
properties block, and may flag the file as needing compaction — the
mechanism behind CompactOnDeletionCollector: trigger compaction when a
sliding window of entries is tombstone-dense.
"""

from __future__ import annotations

from collections import deque

from toplingdb_tpu_torch.db.dbformat import ValueType


class TablePropertiesCollector:
    """Per-table observer; a fresh instance is created for every SST."""

    def name(self) -> str:
        raise NotImplementedError

    def add_user_key(self, key: bytes, value: bytes, entry_type: int,
                     seq: int, file_size: int) -> None:
        """Called for every entry added to the table, in key order."""

    def finish(self) -> dict[str, bytes]:
        """Returns user properties to store in the properties block."""
        return {}

    def need_compact(self) -> bool:
        """True marks the output file for priority compaction."""
        return False


class TablePropertiesCollectorFactory:
    def name(self) -> str:
        raise NotImplementedError

    def create(self) -> TablePropertiesCollector:
        raise NotImplementedError


class CompactOnDeletionCollector(TablePropertiesCollector):
    """Sliding-window tombstone-density trigger (RocksDB's
    CompactOnDeletionCollector):
    need_compact once any window of `window_size` consecutive entries holds
    >= `deletion_trigger` deletes, or the whole file's deletion ratio
    reaches `deletion_ratio` (0 disables the ratio check)."""

    def __init__(self, window_size: int, deletion_trigger: int,
                 deletion_ratio: float = 0.0):
        self._window_size = max(1, window_size)
        self._trigger = deletion_trigger
        self._ratio = deletion_ratio
        self._window: deque[bool] = deque()
        self._in_window = 0
        self._deletions = 0
        self._entries = 0
        self._need = False

    def name(self) -> str:
        return "CompactOnDeletionCollector"

    def add_user_key(self, key, value, entry_type, seq, file_size):
        is_del = entry_type in (ValueType.DELETION, ValueType.SINGLE_DELETION)
        self._entries += 1
        if is_del:
            self._deletions += 1
        if self._need:
            return
        self._window.append(is_del)
        self._in_window += is_del
        if len(self._window) > self._window_size:
            self._in_window -= self._window.popleft()
        if self._in_window >= self._trigger:
            self._need = True

    def need_compact(self) -> bool:
        if self._need:
            return True
        if self._ratio > 0 and self._entries:
            return self._deletions / self._entries >= self._ratio
        return False


class CompactOnDeletionCollectorFactory(TablePropertiesCollectorFactory):
    def __init__(self, window_size: int = 128, deletion_trigger: int = 64,
                 deletion_ratio: float = 0.0):
        self.window_size = window_size
        self.deletion_trigger = deletion_trigger
        self.deletion_ratio = deletion_ratio

    def name(self) -> str:
        return "CompactOnDeletionCollectorFactory"

    def create(self) -> CompactOnDeletionCollector:
        return CompactOnDeletionCollector(
            self.window_size, self.deletion_trigger, self.deletion_ratio
        )

    def serialize(self) -> dict:
        return {"name": self.name(), "window_size": self.window_size,
                "deletion_trigger": self.deletion_trigger,
                "deletion_ratio": self.deletion_ratio}


def serialize_collector_factory(f: TablePropertiesCollectorFactory) -> dict:
    """For the dcompact boundary (ObjectRpcParam analogue): factories must
    be serializable or the executor raises and the scheduler falls back to
    a local compaction."""
    ser = getattr(f, "serialize", None)
    if ser is None:
        from toplingdb_tpu_torch.utils.status import NotSupported

        raise NotSupported(
            f"collector factory {f.name()!r} is not serializable for the "
            f"remote-compaction boundary"
        )
    return ser()


def create_collector_factory(d: dict) -> TablePropertiesCollectorFactory:
    if d.get("name") == "CompactOnDeletionCollectorFactory":
        return CompactOnDeletionCollectorFactory(
            d["window_size"], d["deletion_trigger"], d.get("deletion_ratio", 0.0)
        )
    from toplingdb_tpu_torch.utils.status import InvalidArgument

    raise InvalidArgument(f"unknown collector factory {d.get('name')!r}")
