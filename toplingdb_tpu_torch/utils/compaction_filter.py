"""CompactionFilter API + stock filters (copied from
toplingdb_tpu/utils/compaction_filter.py).

Same contract as RocksDB's (include/rocksdb/compaction_filter.h,
utilities/compaction_filters/): consulted for each
surviving VALUE entry during compaction; may drop or rewrite it.
"""

from __future__ import annotations

import enum


class Decision(enum.Enum):
    KEEP = 0
    REMOVE = 1
    CHANGE_VALUE = 2


class CompactionFilter:
    def name(self) -> str:
        raise NotImplementedError

    def filter(self, level: int, key: bytes, value: bytes) -> tuple[Decision, bytes | None]:
        """Returns (decision, new_value). new_value used for CHANGE_VALUE."""
        return Decision.KEEP, None


class RemoveEmptyValueCompactionFilter(CompactionFilter):
    """Drop entries whose value is empty (reference
    utilities/compaction_filters/remove_emptyvalue_compactionfilter.cc)."""

    def name(self) -> str:
        return "RemoveEmptyValueCompactionFilter"

    def filter(self, level, key, value):
        if value == b"":
            return Decision.REMOVE, None
        return Decision.KEEP, None


# Name → factory registry: how filters travel across the serialized
# compaction boundary (the ObjectRpcParam.clazz analogue, reference
# compaction_executor.h:9-14). Custom filters must register to be usable by
# remote/subprocess workers.
_REGISTRY: dict[str, type] = {
    "RemoveEmptyValueCompactionFilter": RemoveEmptyValueCompactionFilter,
}


def register_compaction_filter(cls: type) -> type:
    _REGISTRY[cls().name()] = cls
    return cls


def create_compaction_filter(name: str) -> CompactionFilter:
    try:
        return _REGISTRY[name]()
    except KeyError:
        from toplingdb_tpu_torch.utils.status import InvalidArgument

        raise InvalidArgument(f"unknown compaction filter {name!r}") from None
