"""MergeOperator API + stock operators (copied from
toplingdb_tpu/utils/merge_operator.py).

Same contract as RocksDB's (include/rocksdb/merge_operator.h,
utilities/merge_operators/): `full_merge` folds an operand
chain onto an optional base value (newest operand LAST in our convention —
operands are passed oldest→newest); `partial_merge` may combine adjacent
operands without a base. Stock operators mirror the reference's set.
"""

from __future__ import annotations

import struct


class MergeOperator:
    def name(self) -> str:
        raise NotImplementedError

    def full_merge(self, key: bytes, existing: bytes | None,
                   operands: list[bytes]) -> bytes:
        """Fold operands (oldest→newest) onto existing; must succeed."""
        raise NotImplementedError

    def partial_merge(self, key: bytes, left: bytes, right: bytes) -> bytes | None:
        """Combine two adjacent operands (left older); None = cannot."""
        return None

    def allow_single_operand(self) -> bool:
        return False


class PutOperator(MergeOperator):
    """Merge == overwrite: last operand wins (reference put.cc)."""

    def name(self) -> str:
        return "PutOperator"

    def full_merge(self, key, existing, operands):
        return operands[-1] if operands else (existing or b"")

    def partial_merge(self, key, left, right):
        return right


class UInt64AddOperator(MergeOperator):
    """uint64 little-endian addition (reference uint64add.cc)."""

    def name(self) -> str:
        return "UInt64AddOperator"

    @staticmethod
    def _dec(v: bytes | None) -> int:
        if not v:
            return 0
        if len(v) == 8:
            return struct.unpack("<Q", v)[0]
        return int.from_bytes(v[:8].ljust(8, b"\x00"), "little")

    def full_merge(self, key, existing, operands):
        total = self._dec(existing)
        for op in operands:
            total = (total + self._dec(op)) & 0xFFFFFFFFFFFFFFFF
        return struct.pack("<Q", total)

    def partial_merge(self, key, left, right):
        return struct.pack(
            "<Q", (self._dec(left) + self._dec(right)) & 0xFFFFFFFFFFFFFFFF
        )


class StringAppendOperator(MergeOperator):
    """Append with delimiter (reference string_append/stringappend.cc)."""

    def __init__(self, delim: bytes = b","):
        self.delim = delim

    def name(self) -> str:
        return "StringAppendOperator"

    def full_merge(self, key, existing, operands):
        parts = ([existing] if existing is not None else []) + list(operands)
        return self.delim.join(parts)

    def partial_merge(self, key, left, right):
        return left + self.delim + right


class MaxOperator(MergeOperator):
    """Bytewise max (reference max.cc)."""

    def name(self) -> str:
        return "MaxOperator"

    def full_merge(self, key, existing, operands):
        best = existing if existing is not None else b""
        for op in operands:
            if op > best:
                best = op
        return best

    def partial_merge(self, key, left, right):
        return max(left, right)


class BytesXOROperator(MergeOperator):
    """Bytewise XOR, shorter operand zero-extended (reference
    utilities/merge_operators/bytesxor.cc)."""

    def name(self) -> str:
        return "BytesXOROperator"

    @staticmethod
    def _xor(a: bytes, b: bytes) -> bytes:
        if len(a) < len(b):
            a, b = b, a
        out = bytearray(a)
        for i, c in enumerate(b):
            out[i] ^= c
        return bytes(out)

    def full_merge(self, key, existing, operands):
        acc = existing or b""
        for op in operands:
            acc = self._xor(acc, op)
        return acc

    def partial_merge(self, key, left, right):
        return self._xor(left, right)


class SortListOperator(MergeOperator):
    """Merge comma-separated sorted integer lists into one sorted list
    (reference utilities/merge_operators/sortlist.cc)."""

    def name(self) -> str:
        return "MergeSortOperator"

    @staticmethod
    def _nums(v: bytes | None) -> list[int]:
        if not v:
            return []
        return [int(x) for x in v.split(b",") if x]

    def full_merge(self, key, existing, operands):
        out = self._nums(existing)
        for op in operands:
            out.extend(self._nums(op))
        out.sort()
        return b",".join(b"%d" % n for n in out)

    def partial_merge(self, key, left, right):
        return self.full_merge(key, None, [left, right])


class AggMergeOperator(MergeOperator):
    """Pluggable per-record aggregation (reference utilities/agg_merge/):
    every value/operand is `varint-len aggregator-name | payload`; the
    newest record's aggregator folds the whole chain. Stock aggregators:
    sum/max/min (uint64 LE), last, first."""

    NAME_SEP = b"\x00"

    def name(self) -> str:
        return "AggMergeOperator.v1"

    @staticmethod
    def pack(agg: bytes, payload: bytes) -> bytes:
        """Encode one aggregatable value (reference EncodeAggFuncAndPayload)."""
        return bytes([len(agg)]) + agg + payload

    @staticmethod
    def _unpack(v: bytes) -> tuple[bytes | None, bytes]:
        """(aggregator, payload); aggregator None for values that were not
        written through pack() (reference agg_merge degrades gracefully on
        unpackaged input instead of crashing)."""
        if not v or 1 + v[0] > len(v):
            return None, v
        n = v[0]
        return v[1 : 1 + n], v[1 + n :]

    @staticmethod
    def _u64(p: bytes) -> int:
        return int.from_bytes(p[:8].ljust(8, b"\x00"), "little")

    def full_merge(self, key, existing, operands):
        chain = ([existing] if existing is not None else []) + list(operands)
        # Newest PACKED record picks the function; an all-unpackaged chain
        # degrades to last-value-wins.
        agg = None
        for v in reversed(chain):
            agg, _ = self._unpack(v)
            if agg is not None:
                break
        if agg is None:
            return chain[-1]
        payloads = [self._unpack(v)[1] for v in chain]
        if agg == b"sum":
            out = sum(self._u64(p) for p in payloads) & 0xFFFFFFFFFFFFFFFF
            return self.pack(agg, struct.pack("<Q", out))
        if agg == b"max":
            return self.pack(agg, struct.pack(
                "<Q", max(self._u64(p) for p in payloads)))
        if agg == b"min":
            return self.pack(agg, struct.pack(
                "<Q", min(self._u64(p) for p in payloads)))
        if agg == b"first":
            return self.pack(agg, payloads[0])
        # "last" and any unknown aggregator: newest record wins.
        return self.pack(agg, payloads[-1])


class CassandraValueMergeOperator(MergeOperator):
    """Cassandra-style row merge (reference utilities/cassandra/): a value is
    a serialized row of columns `varint32 col_id | fixed64 timestamp |
    varint32 len | bytes`; merging keeps the newest timestamp per column.
    A zero-length value for a column is a column tombstone."""

    def name(self) -> str:
        return "CassandraValueMergeOperator"

    @staticmethod
    def _cols(v: bytes) -> dict[int, tuple[int, bytes]]:
        from toplingdb_tpu_torch.utils import coding

        out: dict[int, tuple[int, bytes]] = {}
        off = 0
        while off < len(v):
            cid, off = coding.decode_varint32(v, off)
            ts = struct.unpack_from("<Q", v, off)[0]
            off += 8
            ln, off = coding.decode_varint32(v, off)
            out[cid] = (ts, bytes(v[off : off + ln]))
            off += ln
        return out

    @staticmethod
    def _encode(cols: dict[int, tuple[int, bytes]]) -> bytes:
        from toplingdb_tpu_torch.utils import coding

        out = bytearray()
        for cid in sorted(cols):
            ts, val = cols[cid]
            out += coding.encode_varint32(cid)
            out += struct.pack("<Q", ts)
            out += coding.encode_varint32(len(val))
            out += val
        return bytes(out)

    def full_merge(self, key, existing, operands):
        merged: dict[int, tuple[int, bytes]] = {}
        for v in ([existing] if existing is not None else []) + list(operands):
            for cid, (ts, val) in self._cols(v).items():
                if cid not in merged or ts >= merged[cid][0]:
                    merged[cid] = (ts, val)
        return self._encode(merged)

    def partial_merge(self, key, left, right):
        return self.full_merge(key, None, [left, right])


_REGISTRY = {
    "put": PutOperator,
    "uint64add": UInt64AddOperator,
    "stringappend": StringAppendOperator,
    "max": MaxOperator,
    "bytesxor": BytesXOROperator,
    "sortlist": SortListOperator,
    "aggmerge": AggMergeOperator,
    "cassandra": CassandraValueMergeOperator,
}

# Class-name aliases: the serialized dcompact boundary ships
# MergeOperator.name() strings (ObjectRpcParam.clazz analogue).
_BY_CLASS = {cls().name(): cls for cls in set(_REGISTRY.values())}


def create_merge_operator(name: str) -> MergeOperator:
    cls = _REGISTRY.get(name) or _BY_CLASS.get(name)
    if cls is None:
        from toplingdb_tpu_torch.utils.status import InvalidArgument

        raise InvalidArgument(f"unknown merge operator {name!r}")
    return cls()
