"""Async read plane: batched block-fetch fan-out over AsyncIORing (copied
from toplingdb_tpu/env/async_reads.py).

ToplingDB's biggest read-path win is the fiber/io_uring MultiGet
(db_impl.cc:3026-3227): every block fetch in a batch is
submitted up front and overlapped, instead of serializing preads in the
request thread. `AsyncReadBatcher` is that surgery expressed on top of
the Env's AsyncIORing primitive (env/env.py):

  * callers submit a BATCH of (file, offset, length) block requests;
  * requests are coalesced per file — adjacent/overlapping ranges merge
    into one pread, bounded by `max_span` so a long run of neighbouring
    blocks cannot balloon into an arbitrarily large read;
  * each coalesced range becomes one ring `submit_task` pread, fanned
    round-robin across N rings (N I/O threads) so a cold-cache miss
    storm overlaps rather than serializes;
  * every ORIGINAL request gets back a completion token whose `wait()`
    returns exactly the bytes a synchronous `f.read(offset, n)` would
    have returned — the sync path stays the byte-parity oracle.

`PrereadSpans` adapts a set of tokens back into the `read(offset, n)`
shape `table/format.py read_block` consumes, so the block decode/verify
path is untouched: the overlay slots in as the `pf` source argument of
`TableReader._read_data_block` and falls through to the real file for
anything that was not prefetched.

After `close()` the batcher degrades, it does not poison: submissions
are served synchronously inline (tokens come back pre-completed) and
`READ_ASYNC_FALLBACKS` ticks — a shutdown race costs latency, never
correctness.
"""

from __future__ import annotations


from toplingdb_tpu_torch.env.env import AioToken, AsyncIORing
from toplingdb_tpu_torch.utils import statistics as st
from toplingdb_tpu_torch.utils import telemetry as _tm
from toplingdb_tpu_torch.utils.status import IOError_
from toplingdb_tpu_torch.utils import concurrency as ccy

# One coalesced pread never exceeds this many bytes (matches the upper
# readahead window of FilePrefetchBuffer: big enough to merge a run of
# ~4K blocks + trailers, small enough to keep ring tasks short).
DEFAULT_MAX_SPAN = 1 << 20


class ReadToken:
    """Completion token for ONE submitted (offset, length) request.

    `wait()` returns the same bytes `rfile.read(offset, length)` would:
    the coalesced carrier read is sliced back down, and a short read at
    EOF shortens the slice exactly like the sync pread would.
    """

    __slots__ = ("_tok", "_base", "_off", "_n")

    def __init__(self, tok: AioToken, base: int, off: int, n: int):
        self._tok = tok
        self._base = base   # carrier range start offset
        self._off = off     # this request's absolute offset
        self._n = n

    def ready(self) -> bool:
        return self._tok.ready()

    def wait(self) -> bytes:
        data = self._tok.wait()
        lo = self._off - self._base
        return bytes(data[lo:lo + self._n])


class PrereadSpans:
    """`read(offset, n)` view over a file's prefetched ranges.

    FilePrefetchBuffer-compatible surface (read + hits/misses) so it can
    be passed as the `pf` source of `TableReader._read_data_block`; any
    range that was not prefetched falls through to the real file — a
    correctness backstop, counted as a miss.
    """

    __slots__ = ("_f", "_spans", "hits", "misses")

    def __init__(self, rfile, spans: list[tuple[int, int, ReadToken]]):
        self._f = rfile
        self._spans = sorted(spans, key=lambda s: s[0])
        self.hits = 0
        self.misses = 0

    def read(self, offset: int, n: int) -> bytes:
        spans = self._spans
        lo, hi = 0, len(spans)
        while lo < hi:
            mid = (lo + hi) // 2
            if spans[mid][0] <= offset:
                lo = mid + 1
            else:
                hi = mid
        if lo:
            start, end, tok = spans[lo - 1]
            if offset >= start and offset + n <= end:
                self.hits += 1
                data = tok.wait()
                return bytes(data[offset - start:offset - start + n])
        self.misses += 1
        return self._f.read(offset, n)


class AsyncReadBatcher:
    """Fan a batch of block reads across N AsyncIORings.

    Thread-safe: submission holds `_mu` only for ring round-robin and
    the closed check; the preads themselves run on the ring threads
    (os.pread releases the GIL, so N rings genuinely overlap I/O).
    """

    def __init__(self, rings: int = 2, ring_capacity: int = 256,
                 task_capacity: int | None = None, stats=None,
                 fault_hook=None, name: str = "tpt-read"):
        n = max(1, int(rings))
        self._rings = [
            AsyncIORing(capacity=ring_capacity, name=f"{name}-{i}",
                        task_capacity=task_capacity, fault_hook=fault_hook)
            for i in range(n)
        ]
        self._mu = ccy.Lock("async_reads.AsyncReadBatcher._mu")
        self._rr = 0
        self._closed = False
        self.stats = stats
        self.max_span = DEFAULT_MAX_SPAN
        self.batches = 0
        self.coalesced = 0
        self.fallbacks = 0

    @property
    def n_rings(self) -> int:
        return len(self._rings)

    # -- submission ----------------------------------------------------

    def _next_ring(self) -> AsyncIORing | None:
        with self._mu:
            if self._closed:
                return None
            i = self._rr
            self._rr = (i + 1) % len(self._rings)
            return self._rings[i]

    def submit_batch(self, requests) -> list[ReadToken]:
        """requests: iterable of (rfile, offset, length). Returns one
        ReadToken per request, in order. Adjacent/overlapping ranges of
        the same file are coalesced into shared carrier preads."""
        reqs = list(requests)
        with _tm.span("read.async.batch", requests=len(reqs),
                      rings=len(self._rings)):
            by_file: dict[int, list[tuple[int, int, int]]] = {}
            files: dict[int, object] = {}
            for i, (f, off, n) in enumerate(reqs):
                by_file.setdefault(id(f), []).append((int(off), int(n), i))
                files[id(f)] = f
            out: list[ReadToken | None] = [None] * len(reqs)
            ranges = 0
            for fid, lst in by_file.items():
                f = files[fid]
                lst.sort()
                run: list[tuple[int, int, int]] = []
                run_end = -1
                for off, n, i in lst:
                    if (run and off <= run_end
                            and max(run_end, off + n) - run[0][0]
                            <= self.max_span):
                        run.append((off, n, i))
                        run_end = max(run_end, off + n)
                    else:
                        if run:
                            ranges += 1
                            self._dispatch(f, run, run_end, out)
                        run = [(off, n, i)]
                        run_end = off + n
                if run:
                    ranges += 1
                    self._dispatch(f, run, run_end, out)
            self.batches += 1
            self.coalesced += len(reqs) - ranges
            if self.stats is not None:
                self.stats.record_tick(st.READ_ASYNC_BATCHES, 1)
                if len(reqs) > ranges:
                    self.stats.record_tick(st.READ_ASYNC_COALESCED,
                                           len(reqs) - ranges)
            return out

    def _dispatch(self, f, run, run_end, out) -> None:
        base = run[0][0]
        ring = self._next_ring()
        if ring is not None:
            try:
                tok = ring.submit_task(
                    lambda f=f, base=base, n=run_end - base:
                    f.read(base, n))
            except IOError_:
                tok = None
        else:
            tok = None
        if tok is None:
            # Closed (or closing) batcher: serve inline, stay correct.
            self.fallbacks += 1
            if self.stats is not None:
                self.stats.record_tick(st.READ_ASYNC_FALLBACKS, 1)
            tok = AioToken()
            try:
                tok.done(result=f.read(base, run_end - base))
            except BaseException as e:  # noqa: BLE001
                tok.done(err=e)
        for off, n, i in run:
            out[i] = ReadToken(tok, base, off, n)

    def preread(self, rfile, ranges) -> PrereadSpans:
        """Submit one file's (offset, length) ranges and hand back the
        overlay `_read_data_block` can consume as its `pf` source."""
        toks = self.submit_batch([(rfile, off, n) for off, n in ranges])
        return PrereadSpans(
            rfile,
            [(off, off + n, t) for (off, n), t in zip(ranges, toks)])

    def submit_task(self, fn) -> AioToken:
        """Generic async work round-robined onto a reader ring (zip
        mini-group decodes, iterator readahead windows)."""
        ring = self._next_ring()
        if ring is not None:
            try:
                return ring.submit_task(fn)
            except IOError_:
                pass
        self.fallbacks += 1
        if self.stats is not None:
            self.stats.record_tick(st.READ_ASYNC_FALLBACKS, 1)
        tok = AioToken()
        try:
            tok.done(result=fn())
        except BaseException as e:  # noqa: BLE001
            tok.done(err=e)
        return tok

    def ring_for(self, seq: int) -> AsyncIORing | None:
        """Stable ring handle for long-lived consumers (an iterator's
        FilePrefetchBuffer keeps ONE ring so its windows stay ordered).

        Lock-free on purpose: `_rings` is immutable after construction
        and `_closed` only flips False→True, so the worst race hands
        out a closing ring — whose submits fall back inline. Taking
        `_mu` here would nest it under `db.DB._mutex`
        (DB.new_iterator builds children under it)."""
        if self._closed:
            return None
        return self._rings[seq % len(self._rings)]

    # -- lifecycle -----------------------------------------------------

    def drain(self) -> None:
        for r in self._rings:
            r.drain()

    def close(self) -> None:
        with self._mu:
            if self._closed:
                return
            self._closed = True
        for r in self._rings:
            r.close()
