"""FilePrefetchBuffer: sequential readahead for table scans (copied from
toplingdb_tpu/table/prefetch.py, trimmed to the synchronous windowed
readahead; the asynchronous lane through an IO ring comes with the port's
env.AsyncIORing).

Block-at-a-time iteration over a cold file otherwise pays one pread per
~4KB block. This buffer detects a sequential access pattern and reads ahead
with a doubling window (8KB → 256KB by default), so a long scan does one
pread per window instead of per block. Random access passes straight
through (no cost, no pollution). One instance per scan: readahead state is
a property of the scan, not the file.
"""

from __future__ import annotations


class FilePrefetchBuffer:
    """Wraps a RandomAccessFile with auto-readahead. Presents the same
    read(offset, n) surface, so fmt.read_block can consume it directly.

    `initial_readahead` + `arm_immediately` configure the KNOWN-sequential
    mode used by the compaction input scan (a fixed compaction readahead):
    the very first read already fetches a full window instead of waiting
    for the doubling ramp."""

    __slots__ = ("_f", "_buf", "_buf_off", "_readahead", "_init_ra", "_max",
                 "_next_expected", "_seq_reads", "_arm0", "hits", "misses")

    MIN_READAHEAD = 8 * 1024
    MAX_READAHEAD = 256 * 1024
    # Sequential reads before readahead arms.
    ARM_AFTER = 2

    def __init__(self, rfile, max_readahead: int = MAX_READAHEAD,
                 initial_readahead: int | None = None,
                 arm_immediately: bool = False):
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

    def reset(self) -> None:
        """Back to the initial state (a seek): drop the window and the
        readahead ramp so the next sequential run re-arms from
        `initial_readahead`. hit/miss counters survive (they are cumulative
        scan accounting)."""
        self._buf = b""
        self._buf_off = 0
        self._readahead = self._init_ra
        self._next_expected = -1
        self._seq_reads = self.ARM_AFTER if self._arm0 else 0

    def read(self, offset: int, n: int) -> bytes:
        end = offset + n
        if self._buf and offset >= self._buf_off \
                and end <= self._buf_off + len(self._buf):
            self.hits += 1
            o = offset - self._buf_off
            self._next_expected = end
            return self._buf[o: o + n]
        self.misses += 1
        if offset == self._next_expected:
            self._seq_reads += 1
        elif self._next_expected >= 0:
            # Random access mid-stream: back to the cold state. (A first
            # read keeps any pre-armed window instead of resetting it.)
            self._seq_reads = 0
            self._readahead = self._init_ra
        self._next_expected = end
        if self._seq_reads >= self.ARM_AFTER:
            want = max(n, self._readahead)
            self._buf = self._f.read(offset, want)
            self._buf_off = offset
            self._readahead = min(self._readahead * 2, self._max)
            return self._buf[:n]
        return self._f.read(offset, n)

    def size(self) -> int:
        return self._f.size()
