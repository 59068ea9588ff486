"""SliceTransform: key→prefix extractors (copied from
toplingdb_tpu/utils/slice_transform.py).

RocksDB's SliceTransform role: maps a user key to a prefix used by prefix
bloom filters and the plain-table prefix hash index. `in_domain` marks keys
the transform applies to — out-of-domain keys are excluded from prefix
indexes/filters and lookups for them fall back to total-order search.
"""

from __future__ import annotations


class SliceTransform:
    def name(self) -> str:
        raise NotImplementedError

    def transform(self, key: bytes) -> bytes:
        raise NotImplementedError

    def in_domain(self, key: bytes) -> bool:
        return True


class FixedPrefixTransform(SliceTransform):
    """First `n` bytes; keys shorter than n are out of domain
    (RocksDB's FixedPrefixTransform)."""

    def __init__(self, n: int):
        if n <= 0:
            raise ValueError("fixed prefix length must be positive")
        self.n = n

    def name(self) -> str:
        return f"tpulsm.FixedPrefix.{self.n}"

    def transform(self, key: bytes) -> bytes:
        return key[: self.n]

    def in_domain(self, key: bytes) -> bool:
        return len(key) >= self.n


class CappedPrefixTransform(SliceTransform):
    """First min(len, n) bytes; every key is in domain
    (RocksDB's CappedPrefixTransform)."""

    def __init__(self, n: int):
        if n <= 0:
            raise ValueError("capped prefix length must be positive")
        self.n = n

    def name(self) -> str:
        return f"tpulsm.CappedPrefix.{self.n}"

    def transform(self, key: bytes) -> bytes:
        return key[: self.n]


class NoopTransform(SliceTransform):
    """Identity: the whole key is its own prefix."""

    def name(self) -> str:
        return "tpulsm.Noop"

    def transform(self, key: bytes) -> bytes:
        return key


def slice_transform_from_name(name: str) -> SliceTransform | None:
    """Reconstruct a stock transform from its serialized name (how the
    extractor travels through TableProperties and the dcompact boundary).
    Unknown/custom names return None, as RocksDB treats unknown
    customizables."""
    if name.startswith("tpulsm.FixedPrefix."):
        return FixedPrefixTransform(int(name.rsplit(".", 1)[1]))
    if name.startswith("tpulsm.CappedPrefix."):
        return CappedPrefixTransform(int(name.rsplit(".", 1)[1]))
    if name == "tpulsm.Noop":
        return NoopTransform()
    return None


def resolve_file_extractor(opts_extractor, recorded_name: str):
    """The extractor to use against a FILE's prefix structures (prefix hash
    index, prefix bloom). The live options extractor is only trusted when it
    matches the name the file was built with — an extractor change across
    reopen must not make probes of old files report false absence — else the
    recorded name is reconstructed (None for custom/unknown names: callers
    fail open / fall back to total-order search)."""
    if opts_extractor is not None and opts_extractor.name() == recorded_name:
        return opts_extractor
    return slice_transform_from_name(recorded_name) if recorded_name else None
