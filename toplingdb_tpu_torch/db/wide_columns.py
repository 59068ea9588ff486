"""Wide-column entities (copied from toplingdb_tpu/db/wide_columns.py,
trimmed to what a compaction's merge fold and a read of an entity need).

An entity is a set of named columns serialized into one value:
  magic | varint32 num_columns | per column: lp(name) lp(value)
sorted by name; the anonymous default column uses name b"". Entities are
stored under ValueType.WIDE_COLUMN_ENTITY, and a merge chain over an entity
folds against its default column (merge_into_entity).
"""

from __future__ import annotations

from toplingdb_tpu_torch.utils import coding
from toplingdb_tpu_torch.utils.status import Corruption

DEFAULT_COLUMN = b""
_MAGIC = b"\x00WCE1"  # prefix marking a wide-column entity value


def encode_entity(columns: dict[bytes, bytes]) -> bytes:
    out = bytearray(_MAGIC)
    out += coding.encode_varint32(len(columns))
    for name in sorted(columns):
        coding.put_length_prefixed_slice(out, name)
        coding.put_length_prefixed_slice(out, columns[name])
    return bytes(out)


def is_entity(value: bytes) -> bool:
    return value.startswith(_MAGIC)


def decode_entity(value: bytes) -> dict[bytes, bytes]:
    if not is_entity(value):
        # Plain value presents as the anonymous default column.
        return {DEFAULT_COLUMN: value}
    try:
        off = len(_MAGIC)
        n, off = coding.decode_varint32(value, off)
        out: dict[bytes, bytes] = {}
        for _ in range(n):
            name, off = coding.get_length_prefixed_slice(value, off)
            val, off = coding.get_length_prefixed_slice(value, off)
            out[name] = val
        if off != len(value):
            raise Corruption("trailing bytes in wide-column entity")
        return out
    except Corruption:
        # A plain binary value that merely starts with the magic bytes: the
        # default-column presentation.
        return {DEFAULT_COLUMN: value}


def merge_into_entity(encoded: bytes, fold_fn) -> bytes:
    """Apply a merge fold to an entity's DEFAULT column: fold_fn receives
    the current default column value (or None when the entity has none)
    and returns the merged bytes; the result is the entity re-encoded with
    the default column replaced."""
    cols = dict(decode_entity(encoded))
    cols[DEFAULT_COLUMN] = fold_fn(cols.get(DEFAULT_COLUMN))
    return encode_entity(cols)


def default_column_of(value: bytes) -> bytes:
    """A plain read of a wide-column entity returns its anonymous default
    column's value (empty when the entity has none); non-entity values
    pass through untouched."""
    if not is_entity(value):
        return value
    return decode_entity(value).get(DEFAULT_COLUMN, b"")
