"""Workload tracing + replay (copied from toplingdb_tpu/utils/trace.py,
whole; RocksDB's trace_replay/trace_replay.cc,
include/rocksdb/utilities/replayer.h and tools/trace_analyzer_tool.cc):
record Get/Put/Delete/Merge/DeleteRange/Iterator ops with timestamps to a
log-framed file; replay them against any DB; analyze per-type/key
statistics.

The file format is toplingdb_tpu's: LogWriter records, each a varint op,
a varint64 timestamp in microseconds and length-prefixed slices, so either
package reads a trace the other wrote."""

from __future__ import annotations

import time

from toplingdb_tpu_torch.db.log import LogReader, LogWriter
from toplingdb_tpu_torch.utils import coding

OP_GET = 1
OP_PUT = 2
OP_DELETE = 3
OP_MERGE = 4
OP_DELETE_RANGE = 5
OP_ITER_SEEK = 6
OP_WRITE_BATCH = 7
OP_ITER_SEEK_FOR_PREV = 8
OP_MULTIGET = 9

_OP_NAMES = {
    OP_GET: "get", OP_PUT: "put", OP_DELETE: "delete", OP_MERGE: "merge",
    OP_DELETE_RANGE: "delete_range", OP_ITER_SEEK: "iter_seek",
    OP_WRITE_BATCH: "write_batch",
    OP_ITER_SEEK_FOR_PREV: "iter_seek_for_prev", OP_MULTIGET: "multiget",
}


class TraceOptions:
    """Reference TraceOptions (include/rocksdb/trace_reader_writer.h):
    byte cap on the trace file + 1-in-N op sampling."""

    def __init__(self, max_trace_file_size: int = 0,
                 sampling_frequency: int = 1):
        self.max_trace_file_size = max_trace_file_size
        self.sampling_frequency = max(1, sampling_frequency)


class OpTracer:
    """DB-attached operation recorder (RocksDB's DB::StartTrace /
    trace_replay/trace_replay.cc): the DB calls record_* from its own
    read/write entry points, so EVERY op is captured — unlike the wrapper
    Tracer below, which only sees calls routed through it. Thread-safe;
    silently stops at max_trace_file_size (RocksDB's behavior)."""

    def __init__(self, env, trace_path: str,
                 options: TraceOptions | None = None):
        from toplingdb_tpu_torch.utils import concurrency as ccy

        self.options = options or TraceOptions()
        self._w = LogWriter(env.new_writable_file(trace_path))
        self._mu = ccy.Lock("trace.OpTracer._mu")
        self._written = 0
        self._seq = 0
        self.stopped = False

    def _record(self, op: int, *slices: bytes) -> None:
        if self.stopped:
            return
        with self._mu:
            # Sampling decides BEFORE any encoding work: on a 1-in-N
            # config the hot read path must not pay the record build for
            # dropped ops. stopped re-checks under the lock so a racing
            # close() can't hand us a closed writer.
            if self.stopped:
                return
            self._seq += 1
            if self._seq % self.options.sampling_frequency:
                return
            out = bytearray()
            out += coding.encode_varint32(op)
            out += coding.encode_varint64(int(time.time() * 1e6))
            for s in slices:
                coding.put_length_prefixed_slice(out, s)
            cap = self.options.max_trace_file_size
            if cap and self._written + len(out) > cap:
                self.stopped = True
                return
            self._written += len(out) + 7  # log framing overhead
            self._w.add_record(bytes(out))

    def record_get(self, key: bytes) -> None:
        self._record(OP_GET, key)

    def record_multiget(self, keys) -> None:
        self._record(OP_MULTIGET, *keys)

    def record_write(self, batch_rep: bytes) -> None:
        self._record(OP_WRITE_BATCH, batch_rep)

    def record_iter_seek(self, key: bytes, for_prev: bool = False) -> None:
        self._record(OP_ITER_SEEK_FOR_PREV if for_prev else OP_ITER_SEEK,
                     key)

    def close(self) -> None:
        with self._mu:
            self._w.sync()
            self._w.close()
            self.stopped = True


class TracingIterator:
    """Proxy recording the seeks of one DB iterator (RocksDB traces
    Iterator::Seek/SeekForPrev through the same mechanism)."""

    def __init__(self, it, tracer: OpTracer):
        self._it = it
        self._tr = tracer

    def seek(self, key):
        self._tr.record_iter_seek(key)
        return self._it.seek(key)

    def seek_for_prev(self, key):
        self._tr.record_iter_seek(key, for_prev=True)
        return self._it.seek_for_prev(key)

    def __getattr__(self, name):
        return getattr(self._it, name)


class Tracer:
    """Wraps a DB; every operation is both executed and recorded."""

    def __init__(self, db, trace_path: str):
        self._db = db
        self._w = LogWriter(db.env.new_writable_file(trace_path))

    def _rec(self, op: int, *slices: bytes) -> None:
        out = bytearray()
        out += coding.encode_varint32(op)
        out += coding.encode_varint64(int(time.time() * 1e6))
        for s in slices:
            coding.put_length_prefixed_slice(out, s)
        self._w.add_record(bytes(out))

    def get(self, key, opts=None):
        self._rec(OP_GET, key)
        return self._db.get(key) if opts is None else self._db.get(key, opts)

    def put(self, key, value, opts=None):
        self._rec(OP_PUT, key, value)
        return self._db.put(key, value) if opts is None else self._db.put(key, value, opts)

    def delete(self, key, opts=None):
        self._rec(OP_DELETE, key)
        return self._db.delete(key)

    def merge(self, key, value, opts=None):
        self._rec(OP_MERGE, key, value)
        return self._db.merge(key, value)

    def delete_range(self, begin, end, opts=None):
        self._rec(OP_DELETE_RANGE, begin, end)
        return self._db.delete_range(begin, end)

    def close(self) -> None:
        self._w.sync()
        self._w.close()


def read_trace(env, trace_path: str):
    """Yields (op, time_micros, [slices])."""
    for rec in LogReader(env.new_sequential_file(trace_path)).records():
        op, off = coding.decode_varint32(rec, 0)
        ts, off = coding.decode_varint64(rec, off)
        slices = []
        while off < len(rec):
            s, off = coding.get_length_prefixed_slice(rec, off)
            slices.append(s)
        yield op, ts, slices


class Replayer:
    """Replay a trace against a DB (RocksDB's Replayer,
    include/rocksdb/utilities/replayer.h): fast-forward or
    timing-faithful (inter-op gaps divided by `speedup`, RocksDB's
    fast-forward factor), optionally fanned out over worker threads (the
    MultiThreadReplay of RocksDB)."""

    def __init__(self, db, trace_path: str):
        self._db = db
        self._path = trace_path

    def _apply(self, op, slices):
        db = self._db
        if op in (OP_GET,):
            db.get(slices[0])
        elif op == OP_MULTIGET:
            db.multi_get(list(slices))
        elif op == OP_PUT:
            db.put(slices[0], slices[1])
        elif op == OP_DELETE:
            db.delete(slices[0])
        elif op == OP_MERGE:
            db.merge(slices[0], slices[1])
        elif op == OP_DELETE_RANGE:
            db.delete_range(slices[0], slices[1])
        elif op == OP_WRITE_BATCH:
            from toplingdb_tpu_torch.db.write_batch import WriteBatch

            db.write(WriteBatch(data=slices[0]))
        elif op in (OP_ITER_SEEK, OP_ITER_SEEK_FOR_PREV):
            it = db.new_iterator()
            if op == OP_ITER_SEEK:
                it.seek(slices[0])
            else:
                it.seek_for_prev(slices[0])

    def replay(self, fast_forward: bool = True, speedup: float = 1.0,
               threads: int = 1) -> int:
        """Returns the number of ops replayed. fast_forward=True ignores
        recorded timing entirely; otherwise inter-op gaps are honored,
        divided by `speedup`. With threads > 1, LOOKUP ops fan out over a
        pool while writes stay ordered on the caller thread (writes
        reordering against each other would corrupt the replayed state)."""
        n = 0
        prev_ts = None
        pool = None
        futures = []
        if threads > 1:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(threads)
        try:
            for op, ts, slices in read_trace(self._db.env, self._path):
                if not fast_forward and prev_ts is not None:
                    time.sleep(max(0, (ts - prev_ts) / 1e6 / speedup))
                prev_ts = ts
                if pool is not None and op in (OP_GET, OP_MULTIGET,
                                               OP_ITER_SEEK,
                                               OP_ITER_SEEK_FOR_PREV):
                    futures.append(pool.submit(self._apply, op, slices))
                else:
                    self._apply(op, slices)
                n += 1
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
        for f in futures:
            f.result()  # surface worker failures, not a clean count
        return n


def analyze_trace(env, trace_path: str) -> dict:
    """Per-op-type counts + hottest keys (RocksDB's trace_analyzer).
    Thin wrapper over the full CLI analyzer so there is exactly ONE
    aggregation loop (tools/trace_analyzer.py)."""
    from toplingdb_tpu_torch.tools.trace_analyzer import analyze

    return analyze(env, trace_path)
