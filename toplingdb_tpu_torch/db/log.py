"""WAL / MANIFEST record framing: writer, reader and the tailing reader of
WAL shipping (copied from toplingdb_tpu/db/log.py).

Same framing as RocksDB's log format (db/log_format.h, db/log_writer.cc,
db/log_reader.cc): the file is a
sequence of 32KiB blocks; each record fragment is
    masked_crc32c(4B) | length(2B LE) | type(1B) | payload
with type FULL/FIRST/MIDDLE/LAST so records can span blocks; a block's unusable
tail (<7B) is zero-padded. The CRC covers type+payload. Both the WAL and the
MANIFEST use this framing.
"""

from __future__ import annotations

from toplingdb_tpu_torch.utils import coding, crc32c
from toplingdb_tpu_torch.utils.status import Corruption

BLOCK_SIZE = 32768
HEADER_SIZE = 7
# Recyclable records carry the owning log number after the type byte
# (RocksDB's kRecyclableFullType..kRecyclableLastType):
# a reused WAL file's stale tail from its previous life then reads as
# end-of-log instead of replaying into the wrong recovery.
RECYCLABLE_HEADER_SIZE = 11

FULL = 1
FIRST = 2
MIDDLE = 3
LAST = 4
RECYCLABLE_FULL = 5
RECYCLABLE_FIRST = 6
RECYCLABLE_MIDDLE = 7
RECYCLABLE_LAST = 8

_RECYCLE_OF = {FULL: RECYCLABLE_FULL, FIRST: RECYCLABLE_FIRST,
               MIDDLE: RECYCLABLE_MIDDLE, LAST: RECYCLABLE_LAST}


class LogWriter:
    def __init__(self, wfile, log_number: int = 0, recycled: bool = False):
        """`recycled`: emit recyclable record types stamped with
        `log_number` (required for files that may later be reused AND for
        writes into a reused file)."""
        self._f = wfile
        self._block_offset = wfile.file_size() % BLOCK_SIZE
        self._log_number = log_number
        self._recycled = recycled
        self._hdr = RECYCLABLE_HEADER_SIZE if recycled else HEADER_SIZE

    def add_record(self, data: bytes) -> None:
        left = len(data)
        pos = 0
        begin = True
        while True:
            leftover = BLOCK_SIZE - self._block_offset
            if leftover < self._hdr:
                if leftover > 0:
                    self._f.append(b"\x00" * leftover)
                self._block_offset = 0
                leftover = BLOCK_SIZE
            avail = leftover - self._hdr
            frag = min(left, avail)
            end = left == frag
            if begin and end:
                t = FULL
            elif begin:
                t = FIRST
            elif end:
                t = LAST
            else:
                t = MIDDLE
            self._emit(t, data[pos : pos + frag])
            pos += frag
            left -= frag
            begin = False
            if left == 0:
                break

    def framing_state(self) -> tuple[int, int]:
        """(block_offset, log_number_or_-1) for an external framer (the
        native group-commit plane): -1 selects the classic 7-byte record
        headers, >= 0 the recyclable format stamped with that number."""
        return self._block_offset, (self._log_number if self._recycled else -1)

    def append_preframed(self, data, new_block_offset: int) -> None:
        """Append bytes already framed in THIS writer's log format (the
        native plane produced them from framing_state()) and adopt the
        framer's new block offset. The caller guarantees byte-identity
        with add_record of the same logical record."""
        self._f.append(data)
        self._block_offset = new_block_offset

    def _emit(self, t: int, frag: bytes) -> None:
        if self._recycled:
            t = _RECYCLE_OF[t]
            ln = coding.encode_fixed32(self._log_number)
            crc = crc32c.value(bytes([t]) + ln + frag)
            hdr = (
                coding.encode_fixed32(crc32c.mask(crc))
                + coding.encode_fixed16(len(frag))
                + bytes([t]) + ln
            )
        else:
            crc = crc32c.value(bytes([t]) + frag)
            hdr = (
                coding.encode_fixed32(crc32c.mask(crc))
                + coding.encode_fixed16(len(frag))
                + bytes([t])
            )
        self._f.append(hdr)
        self._f.append(frag)
        self._block_offset += self._hdr + len(frag)

    def flush(self) -> None:
        self._f.flush()

    def sync(self) -> None:
        self._f.sync()

    def close(self) -> None:
        self._f.close()


class LogReader:
    """Sequential record reader. By default tolerates a truncated tail (the
    normal crash case, as RocksDB's log reader does at eof) but raises
    Corruption on checksum mismatches in the middle of the log."""

    def __init__(self, sfile, verify_checksums: bool = True,
                 log_number: int | None = None):
        """`log_number`: expected owner of recyclable records; a mismatch
        (the reused file's previous life) reads as end-of-log."""
        self._f = sfile
        self._verify = verify_checksums
        self._log_number = log_number
        self._buf = b""
        self._buf_off = 0
        self._eof = False
        # Once a recyclable record is seen, mid-block garbage is the stale
        # tail of the file's previous life — end-of-log, not corruption.
        self._recycled_seen = False

    def _read_block(self) -> bool:
        data = self._f.read(BLOCK_SIZE)
        self._buf = data
        self._buf_off = 0
        if len(data) < BLOCK_SIZE:
            self._eof = True
        return len(data) > 0

    def _next_fragment(self):
        """Returns (type, payload) or None at end of log."""
        while True:
            if self._buf_off + HEADER_SIZE > len(self._buf):
                if self._eof:
                    return None
                if not self._read_block():
                    return None
                continue
            b = self._buf
            off = self._buf_off
            stored_crc = coding.decode_fixed32(b, off)
            length = coding.decode_fixed16(b, off + 4)
            t = b[off + 6]
            if t == 0 and length == 0:
                # Zero-padded block tail; skip to the next block.
                self._buf_off = len(self._buf)
                continue
            recyclable = RECYCLABLE_FULL <= t <= RECYCLABLE_LAST
            tolerate = self._eof or self._recycled_seen
            if t > RECYCLABLE_LAST:
                if tolerate:
                    return None  # stale previous-life bytes: end of log
                raise Corruption(f"unknown log record type {t}")
            hdr = RECYCLABLE_HEADER_SIZE if recyclable else HEADER_SIZE
            if off + hdr > len(b):
                if tolerate:
                    return None
                raise Corruption("log header overflows block")
            if off + hdr + length > len(b):
                if tolerate:
                    return None  # truncated tail / stale fragment: drop
                raise Corruption("log fragment overflows block")
            payload = b[off + hdr : off + hdr + length]
            self._buf_off = off + hdr + length
            if recyclable:
                rec_ln = coding.decode_fixed32(b, off + 7)
                if (self._log_number is not None
                        and rec_ln != self._log_number):
                    # Previous life of a recycled file: end of THIS log.
                    return None
                if self._verify:
                    actual = crc32c.value(
                        bytes([t]) + b[off + 7: off + 11] + payload)
                    if crc32c.unmask(stored_crc) != actual:
                        if tolerate:
                            return None  # torn write / stale tail
                        raise Corruption("log record checksum mismatch")
                self._recycled_seen = True
                t -= RECYCLABLE_FULL - FULL  # normalize for read_record
                return t, payload
            if self._recycled_seen:
                # A classic-format header after recyclable records can only
                # be previous-life residue: end of this log.
                return None
            if self._verify:
                actual = crc32c.value(bytes([t]) + payload)
                if crc32c.unmask(stored_crc) != actual:
                    if self._eof:
                        return None  # torn final write
                    raise Corruption("log record checksum mismatch")
            return t, payload

    def read_record(self) -> bytes | None:
        """Returns the next full record, or None at clean end-of-log."""
        partial = None
        while True:
            frag = self._next_fragment()
            if frag is None:
                # A dangling FIRST/MIDDLE chain at EOF is a torn write: drop.
                return None
            t, payload = frag
            if t == FULL:
                if partial is not None:
                    raise Corruption("FULL record inside fragmented record")
                return bytes(payload)
            if t == FIRST:
                if partial is not None:
                    raise Corruption("FIRST record inside fragmented record")
                partial = bytearray(payload)
            elif t == MIDDLE:
                if partial is None:
                    raise Corruption("MIDDLE record without FIRST")
                partial += payload
            elif t == LAST:
                if partial is None:
                    raise Corruption("LAST record without FIRST")
                partial += payload
                return bytes(partial)
            else:
                raise Corruption(f"unknown log record type {t}")

    def records(self):
        while True:
            r = self.read_record()
            if r is None:
                return
            yield r


class TailingLogReader:
    """Tail a LIVE log file: poll() returns the complete records appended
    since the previous poll. The crucial property for WAL shipping
    (replication/log_shipper.py) is that a torn/partial trailing record —
    the writer is mid-append, or a crash cut the tail — is RETRIED on the
    next poll instead of being dropped or mis-read, while a bad checksum
    strictly before the durable tail still raises Corruption (real damage
    must not ship to followers).

    The tail-vs-middle rule: an anomalous fragment whose claimed extent
    reaches the file's current end may still be in flight (appends are not
    atomic), so the reader parks at it; an anomaly with durable bytes
    after it can never be completed by the writer and is corruption.
    """

    def __init__(self, env, path: str, verify_checksums: bool = True,
                 log_number: int | None = None):
        self._env = env
        self._path = path
        self._verify = verify_checksums
        self._log_number = log_number
        self._pos = 0           # absolute offset of the first unparsed byte
        self._partial = None    # FIRST..MIDDLE assembly across polls
        self._recycled_seen = False
        self._ended = False     # recycled previous-life boundary reached

    def tell(self) -> int:
        return self._pos

    def _finish(self):
        self._partial = None  # dangling FIRST/MIDDLE chain: torn write

    def poll(self, final: bool = False) -> list[bytes]:
        """New complete records since the last poll. `final=True` declares
        the log closed (a newer WAL exists / the file was archived): any
        parked torn tail is dropped instead of awaited."""
        if self._ended:
            return []
        size = self._env.get_file_size(self._path)
        if size <= self._pos:
            if final:
                self._finish()
            return []
        f = self._env.new_random_access_file(self._path)
        try:
            data = f.read(self._pos, size - self._pos)
        finally:
            f.close()
        base = self._pos
        n = len(data)
        out: list[bytes] = []
        i = 0
        while i < n:
            abs_off = base + i
            rem_block = BLOCK_SIZE - (abs_off % BLOCK_SIZE)
            if rem_block < HEADER_SIZE:
                # Block-tail padding zone; the writer zero-fills it before
                # starting the next record. Mid-fill: wait for the rest.
                if n - i < rem_block:
                    break
                i += rem_block
                continue
            if n - i < HEADER_SIZE:
                break  # torn header: wait
            stored_crc = coding.decode_fixed32(data, i)
            length = coding.decode_fixed16(data, i + 4)
            t = data[i + 6]
            if t == 0 and length == 0:
                # Zero padding to the end of the block.
                if n - i < rem_block:
                    break  # padding still being written
                i += rem_block
                continue
            recyclable = RECYCLABLE_FULL <= t <= RECYCLABLE_LAST
            hdr = RECYCLABLE_HEADER_SIZE if recyclable else HEADER_SIZE
            claimed_end = abs_off + hdr + length
            at_tail = claimed_end >= size
            if t > RECYCLABLE_LAST:
                if at_tail:
                    break  # garbage that may still be overwritten: wait
                raise Corruption(f"unknown log record type {t}")
            if hdr + length > rem_block:
                # Fragments never span blocks; a length pointing past the
                # block can only complete if it is tail garbage in flight.
                if at_tail:
                    break
                raise Corruption("log fragment overflows block")
            if n - i < hdr + length:
                break  # torn fragment: wait
            payload = data[i + hdr : i + hdr + length]
            if recyclable and self._log_number is not None and \
                    coding.decode_fixed32(data, i + 7) != self._log_number:
                # Previous life of a recycled file. Live tailing: the
                # writer may overwrite these bytes next — wait. Final: the
                # log really ends here.
                if final:
                    self._ended = True
                break
            if self._verify:
                blob = bytes([t]) + (
                    bytes(data[i + 7 : i + 11]) if recyclable else b""
                ) + bytes(payload)
                if crc32c.unmask(stored_crc) != crc32c.value(blob):
                    if at_tail:
                        break  # torn append in flight (or final: dropped)
                    raise Corruption("log record checksum mismatch")
            if recyclable:
                self._recycled_seen = True
                t -= RECYCLABLE_FULL - FULL
            elif self._recycled_seen:
                # Classic-format header after recyclable records: residue
                # of the file's previous life — end of this log.
                self._ended = True
                break
            i += hdr + length
            if t == FULL:
                if self._partial is not None:
                    raise Corruption("FULL record inside fragmented record")
                out.append(bytes(payload))
            elif t == FIRST:
                if self._partial is not None:
                    raise Corruption("FIRST record inside fragmented record")
                self._partial = bytearray(payload)
            elif t == MIDDLE:
                if self._partial is None:
                    raise Corruption("MIDDLE record without FIRST")
                self._partial += payload
            else:  # LAST
                if self._partial is None:
                    raise Corruption("LAST record without FIRST")
                self._partial += payload
                out.append(bytes(self._partial))
                self._partial = None
        self._pos = base + i
        if final:
            self._finish()
        return out
