"""FilePrefetchBuffer: sequential readahead for table iteration (copied
from toplingdb_tpu/table/prefetch.py; RocksDB's
file/file_prefetch_buffer.h:63).

Block-at-a-time iteration over a cold file otherwise pays one pread per
~4KB block. This buffer detects a sequential access pattern and reads
ahead with a doubling window (8KB → 256KB), so a long scan does one
pread per window instead of per block. Random access passes straight
through (no cost, no pollution). One instance per iterator — readahead
state is a property of the scan, not the file.
"""

from __future__ import annotations
from toplingdb_tpu_torch.utils import errors as _errors


class FilePrefetchBuffer:
    """Wraps a RandomAccessFile with auto-readahead. Presents the same
    read(offset, n) surface, so fmt.read_block can consume it directly.

    `initial_readahead` + `arm_immediately` configure the KNOWN-sequential
    mode used by the compaction input scan and ReadOptions.readahead_size
    (a fixed readahead, RocksDB's compaction_readahead_size role): the
    very first read already fetches a full window instead of waiting for
    the doubling ramp."""

    __slots__ = ("_f", "_buf", "_buf_off", "_readahead", "_init_ra", "_max",
                 "_next_expected", "_seq_reads", "_arm0", "hits", "misses",
                 "_ring", "_pending")

    MIN_READAHEAD = 8 * 1024
    MAX_READAHEAD = 256 * 1024
    # Sequential reads before readahead arms (RocksDB's
    # BlockBasedTable::kMinNumFileReadsToStartAutoReadahead).
    ARM_AFTER = 2

    def __init__(self, rfile, max_readahead: int = MAX_READAHEAD,
                 initial_readahead: int | None = None,
                 arm_immediately: bool = False, aio_ring=None):
        self._f = rfile
        self._buf = b""
        self._buf_off = 0
        self._init_ra = min(initial_readahead or self.MIN_READAHEAD,
                            max_readahead)
        self._readahead = self._init_ra
        self._max = max_readahead
        self._next_expected = -1
        self._arm0 = arm_immediately
        self._seq_reads = self.ARM_AFTER if arm_immediately else 0
        self.hits = 0      # reads served from the buffer
        self.misses = 0    # reads that went to the file
        # Async readahead (env/env.py AsyncIORing, a reader ring of the
        # async read plane): when armed, the
        # NEXT window's pread is submitted to the ring as the current one
        # is returned, so the scan's compute overlaps its I/O.
        self._ring = aio_ring
        self._pending = None  # (offset, AioToken) of the in-flight window

    def reset(self) -> None:
        """Back to the initial state (a seek): drop the window and the
        readahead ramp so the next sequential run re-arms from
        `initial_readahead` — the auto-scaling window doubles on
        sequential refills and resets here. hit/miss counters survive
        (they are cumulative scan accounting)."""
        self._buf = b""
        self._buf_off = 0
        self._readahead = self._init_ra
        self._next_expected = -1
        self._seq_reads = self.ARM_AFTER if self._arm0 else 0
        self._pending = None

    def _schedule_next(self) -> None:
        """Submit the window after the current one through the ring."""
        nxt = self._buf_off + len(self._buf)
        want = self._readahead
        f = self._f
        self._pending = (nxt, self._ring.submit_task(
            lambda: f.read(nxt, want)))

    def read(self, offset: int, n: int) -> bytes:
        end = offset + n
        if self._buf and offset >= self._buf_off \
                and end <= self._buf_off + len(self._buf):
            self.hits += 1
            o = offset - self._buf_off
            self._track(end)
            return self._buf[o: o + n]
        if self._pending is not None:
            # Adopt the async window if the read landed in/at it.
            p_off, tok = self._pending
            if offset >= p_off and self._seq_reads >= self.ARM_AFTER:
                self._pending = None
                try:
                    data = tok.wait()
                except Exception as e:
                    _errors.swallow(reason="prefetch-wait-failed", exc=e)
                    data = b""
                if data and end <= p_off + len(data):
                    self.hits += 1
                    self._buf = data
                    self._buf_off = p_off
                    self._readahead = min(self._readahead * 2, self._max)
                    if self._ring is not None:
                        self._schedule_next()
                    self._track(end)
                    o = offset - p_off
                    return self._buf[o: o + n]
            elif offset < p_off:
                self._pending = None  # seek backwards: drop the window
        self.misses += 1
        if offset == self._next_expected:
            self._seq_reads += 1
        elif self._next_expected >= 0:
            # Random access mid-stream: back to the cold state. (A first
            # read keeps any pre-armed window instead of resetting it.)
            self._seq_reads = 0
            self._readahead = self._init_ra
        if self._seq_reads >= self.ARM_AFTER:
            want = max(n, self._readahead)
            self._buf = self._f.read(offset, want)
            self._buf_off = offset
            self._readahead = min(self._readahead * 2, self._max)
            if self._ring is not None:
                self._schedule_next()
            self._track(end)
            return self._buf[:n]
        self._track(end)
        return self._f.read(offset, n)

    def _track(self, end: int) -> None:
        self._next_expected = end

    def size(self) -> int:
        return self._f.size()
