"""Restart-point block: builder and iterator (copied from
toplingdb_tpu/table/block.py, without the native seek).

Each entry is
    varint32 shared_key_len | varint32 non_shared_key_len | varint32 value_len
    | key_delta | value
with full keys at restart points every `restart_interval` entries; the block
ends with a fixed32 array of restart offsets and a fixed32 restart count.
The iterator walks forward and backward, seeks to either end, and seeks
to a key (binary search over the restart points, then a linear scan) under
the comparator it was given (bytewise by default).
"""

from __future__ import annotations

from toplingdb_tpu_torch.utils import coding
from toplingdb_tpu_torch.utils.status import Corruption


class BlockBuilder:
    def __init__(self, restart_interval: int = 16):
        self.restart_interval = restart_interval
        self._buf = bytearray()
        self._restarts: list[int] = [0]
        self._counter = 0
        self._last_key = b""
        self._num_entries = 0

    def reset(self) -> None:
        self._buf.clear()
        self._restarts = [0]
        self._counter = 0
        self._last_key = b""
        self._num_entries = 0

    def empty(self) -> bool:
        return self._num_entries == 0

    @property
    def num_entries(self) -> int:
        return self._num_entries

    def current_size_estimate(self) -> int:
        return len(self._buf) + 4 * len(self._restarts) + 4

    def add(self, key: bytes, value: bytes) -> None:
        shared = 0
        if self._counter < self.restart_interval:
            lk = self._last_key
            n = min(len(lk), len(key))
            while shared < n and lk[shared] == key[shared]:
                shared += 1
        else:
            self._restarts.append(len(self._buf))
            self._counter = 0
        non_shared = len(key) - shared
        self._buf += coding.encode_varint32(shared)
        self._buf += coding.encode_varint32(non_shared)
        self._buf += coding.encode_varint32(len(value))
        self._buf += key[shared:]
        self._buf += value
        self._last_key = key
        self._counter += 1
        self._num_entries += 1

    def finish(self) -> bytes:
        out = bytearray(self._buf)
        for r in self._restarts:
            out += coding.encode_fixed32(r)
        out += coding.encode_fixed32(len(self._restarts))
        return bytes(out)


def _bytewise(a: bytes, b: bytes) -> int:
    return (a > b) - (a < b)


class BlockIter:
    """Iterator over a finished block, in stored (key) order."""

    def __init__(self, contents: bytes, cmp=None):
        if len(contents) < 4:
            raise Corruption("block too small")
        self._data = contents
        self._num_restarts = coding.decode_fixed32(contents, len(contents) - 4)
        if self._num_restarts == 0:
            raise Corruption("block has no restarts")
        self._restart_off = len(contents) - 4 - 4 * self._num_restarts
        if self._restart_off < 0:
            raise Corruption("block restart array overflows block")
        self._limit = self._restart_off
        self._cur = self._limit  # invalid
        self._key = b""
        self._val_off = 0
        self._val_len = 0
        self._restart_idx = 0
        self._cmp = cmp or _bytewise

    def _restart_point(self, i: int) -> int:
        return coding.decode_fixed32(self._data, self._restart_off + 4 * i)

    def _decode_at(self, off: int, prev_key: bytes) -> tuple[int, bytes]:
        """Decode entry at `off` given previous key; returns (next_off, key)
        and sets value span."""
        d = self._data
        shared, p = coding.decode_varint32(d, off)
        non_shared, p = coding.decode_varint32(d, p)
        vlen, p = coding.decode_varint32(d, p)
        if shared > len(prev_key) or p + non_shared + vlen > self._limit:
            raise Corruption("bad block entry")
        key = prev_key[:shared] + bytes(d[p : p + non_shared])
        self._val_off = p + non_shared
        self._val_len = vlen
        return p + non_shared + vlen, key

    def valid(self) -> bool:
        return self._cur < self._limit

    def key(self) -> bytes:
        return self._key

    def value(self) -> bytes:
        return bytes(self._data[self._val_off : self._val_off + self._val_len])

    def seek_to_first(self) -> None:
        self._restart_idx = 0
        self._cur = 0
        if self._limit == 0:
            return
        self._next_off, self._key = self._decode_at(0, b"")

    def seek_to_last(self) -> None:
        if self._limit == 0:
            self._cur = self._limit
            return
        self._restart_idx = self._num_restarts - 1
        off = self._restart_point(self._restart_idx)
        key = b""
        while True:
            self._cur = off
            nxt, key = self._decode_at(off, key)
            if nxt >= self._limit:
                self._key = key
                self._next_off = nxt
                return
            off = nxt

    def seek(self, target: bytes) -> None:
        """Position at the first entry with key >= target."""
        # The last restart point whose key is < target.
        lo, hi = 0, self._num_restarts - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            _, key = self._decode_at(self._restart_point(mid), b"")
            if self._cmp(key, target) < 0:
                lo = mid
            else:
                hi = mid - 1
        off = self._restart_point(lo)
        key = b""
        self._restart_idx = lo
        while off < self._limit:
            self._cur = off
            nxt, key = self._decode_at(off, key)
            if self._cmp(key, target) >= 0:
                self._key = key
                self._next_off = nxt
                return
            off = nxt
        self._cur = self._limit  # every key < target

    def seek_for_prev(self, target: bytes) -> None:
        """Position at the last entry with key <= target."""
        self.seek(target)
        if not self.valid():
            self.seek_to_last()
            return
        if self._cmp(self._key, target) > 0:
            self.prev()

    def next(self) -> None:
        assert self.valid()
        if self._next_off >= self._limit:
            self._cur = self._limit
            return
        self._cur = self._next_off
        self._next_off, self._key = self._decode_at(self._cur, self._key)

    def prev(self) -> None:
        assert self.valid()
        target = self._cur
        if target == 0:
            self._cur = self._limit
            return
        # The last restart before the previous entry, then decode forward.
        while (self._restart_idx > 0
               and self._restart_point(self._restart_idx) >= target):
            self._restart_idx -= 1
        off = self._restart_point(self._restart_idx)
        key = b""
        prev_off = None
        while off < target:
            prev_off = off
            off, key = self._decode_at(off, key)
        if prev_off is None:
            self._cur = self._limit
            return
        # The last decode was the entry at prev_off: its key and value span.
        self._cur = prev_off
        self._key = key
        self._next_off = target

    def entries(self):
        """Yield (key, value) from current position to end."""
        while self.valid():
            yield self._key, self.value()
            self.next()
