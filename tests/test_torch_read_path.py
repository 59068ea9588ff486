"""The read path of toplingdb_tpu_torch's DB against toplingdb_tpu's, on the
CPU: multi_get, the async read plane (env/async_reads.py,
AsyncIORing.submit_task, the prefetch buffer's ring lane), get_async /
multi_get_async, ReadOptions.async_io and ReadOptions.readahead_size.

- tests/test_native_get.py:135: the 10K mixed fill, multi_get through the
  native whole-batch call (the C extension and the ctypes call) and
  through the Python walk: equal to the fill's oracle, to per-key gets
  and to the reference's multi_get; keys the native call cannot decide
  (merge chains) re-resolve pinned to the batch's sequence;
- every case of tests/test_async_reads.py but the shard router's (the
  port has no sharding yet): the ring's task back-pressure, the batcher's
  coalescing, span cap and closed fallback (the same requests through
  both packages' batchers: bytes, carrier reads and counters equal), the
  sync / async parity matrix over the block (none, zstd) and zip (none,
  zstd) formats, here also with an LRU and a CLOCK block cache — the
  reference observed with TPULSM_ASYNC_READS=0 and =1, the port through
  DB.open(async_reads=False) and (async_reads=True) on twin directories —,
  a reader-ring failure that reaches the caller and then resumes, the
  delay plan, the rings joined by close(), and the futures;
- tests/test_prefetch_partitioned_filters.py: readahead counts, partitioned
  filter probes and the partitioned-filter DB, each against the reference;
- ReadOptions.async_io multi_gets and readahead_size scans (on the scan
  plane and on the per-entry path, with and without ring windows) against
  the reference, and a DelayedReadEnv twin of the cold-cache bench;
- the port reads no TPULSM_ASYNC_READS.

Tolerance: none; bytes, answers and counts must be equal.
"""

import ast
import dataclasses
import os
import random
import threading
import time

import pytest

from toplingdb_tpu.compaction.executor import (
    DeviceCompactionExecutorFactory as RefFactory,
)
from toplingdb_tpu.db.db import DB as RefDB
from toplingdb_tpu.db.dbformat import InternalKeyComparator as RefICmp
from toplingdb_tpu.db.dbformat import ValueType as RefVT
from toplingdb_tpu.db.dbformat import make_internal_key as ref_mik
from toplingdb_tpu.env import default_env as ref_env
from toplingdb_tpu.env.async_reads import AsyncReadBatcher as RefBatcher
from toplingdb_tpu.env.env import AsyncIORing as RefRing
from toplingdb_tpu.env.fault_injection import DelayedReadEnv as RefDelayed
from toplingdb_tpu.env.fault_injection import (
    ReadFaultInjector as RefInjector,
)
from toplingdb_tpu.options import Options as RefOptions
from toplingdb_tpu.options import ReadOptions as RefReadOptions
from toplingdb_tpu.table.builder import TableBuilder as RefTableBuilder
from toplingdb_tpu.table.builder import TableOptions as RefTO
from toplingdb_tpu.table.reader import TableReader as RefTableReader
from toplingdb_tpu.utils import cache as ref_cache
from toplingdb_tpu.utils import merge_operator as ref_mo
from toplingdb_tpu.utils import statistics as ref_st

import toplingdb_tpu_torch.native as native
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory,
)
from toplingdb_tpu_torch.db.db import DB
from toplingdb_tpu_torch.db.dbformat import (
    InternalKeyComparator,
    ValueType,
    make_internal_key,
)
from toplingdb_tpu_torch.env import default_env
from toplingdb_tpu_torch.env.async_reads import AsyncReadBatcher
from toplingdb_tpu_torch.env.env import AsyncIORing
from toplingdb_tpu_torch.env.fault_injection import (
    DelayedReadEnv,
    ReadFaultInjector,
)
from toplingdb_tpu_torch.options import Options, ReadOptions
from toplingdb_tpu_torch.table import format as fmt
from toplingdb_tpu_torch.table.builder import TableBuilder, TableOptions
from toplingdb_tpu_torch.table.reader import TableReader
from toplingdb_tpu_torch.utils import cache
from toplingdb_tpu_torch.utils import merge_operator as mo
from toplingdb_tpu_torch.utils import statistics as st
from toplingdb_tpu_torch.utils.statistics import Statistics
from toplingdb_tpu_torch.utils.status import IOError_

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_thread_leaks():
    """No thread of either package survives the test: the port's are
    named tpt-*, the reference's are in its registry."""
    from toplingdb_tpu.utils import concurrency as ccy

    before_ref = {id(t) for t in ccy.registry.live()}
    before = set(threading.enumerate())
    yield
    deadline = time.monotonic() + 5.0
    while True:
        leaked = [t.name for t in threading.enumerate()
                  if t not in before and t.name.startswith("tpt-")]
        if not leaked or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    assert not leaked, f"test leaked port threads: {leaked}"
    ref_leaked = [t.name for t in ccy.registry.live()
                  if id(t) not in before_ref]
    assert not ref_leaked, f"test leaked reference threads: {ref_leaked}"


@pytest.fixture
def ref_knob(monkeypatch):
    """The reference's TPULSM_ASYNC_READS, set per observation; the port
    reads none."""
    def set_knob(v: str) -> None:
        monkeypatch.setenv("TPULSM_ASYNC_READS", v)

    monkeypatch.delenv("TPULSM_ASYNC_READS", raising=False)
    return set_knob


def _port_options(**kw):
    return Options(compaction_executor_factory=(
        DeviceCompactionExecutorFactory(device="cpu")), **kw)


# ---------------------------------------------------------------------------
# multi_get (tests/test_native_get.py:135)
# ---------------------------------------------------------------------------


def _fill_mixed(db, n=10000, seed=23):
    rng = random.Random(seed)
    model = {}
    for i in range(n):
        k = b"k%06d" % rng.randrange(n // 3)
        if rng.random() < 0.12:
            db.delete(k)
            model[k] = None
        else:
            v = b"val-%d" % i
            db.put(k, v)
            model[k] = v
        if i % 5000 == 4999:
            db.flush()
    return model


@pytest.mark.parametrize("route", ["extension", "ctypes", "python"])
def test_native_multiget_parity(tmp_path, monkeypatch, route):
    if route == "ctypes":
        monkeypatch.setattr(native, "fastmultiget", lambda: None)
    handled = []
    real = DB._native_multi_get

    def spy(self, *a, **kw):
        r = real(self, *a, **kw)
        handled.append(r[0])
        return r

    monkeypatch.setattr(DB, "_native_multi_get", spy)
    ref = RefDB.open(str(tmp_path / "ref"), RefOptions())
    db = DB.open(str(tmp_path / "port"), _port_options())
    if route == "python":
        db._nget_lib = None
    try:
        model = _fill_mixed(ref)
        assert _fill_mixed(db) == model
        for d in (ref, db):
            d.flush()
            d.wait_for_compactions()
        keys = list(model.keys())[:3000] + [b"absent%d" % i
                                            for i in range(100)]
        got = db.multi_get(keys)
        assert got == [model.get(k) for k in keys]
        assert got == [db.get(k) for k in keys]
        assert got == ref.multi_get(keys)
        # 128-key batches, as db_bench's multireadrandom sends them.
        for i in range(0, len(keys), 128):
            assert db.multi_get(keys[i:i + 128]) == got[i:i + 128]
        if route == "python":
            assert handled and not any(handled)
        else:
            assert handled and all(handled)
            st_ = db._nget_tl.states[0]
            assert (st_.fast_mg is None) == (route == "ctypes")
            if route == "ctypes":
                assert st_.mg is not None  # the ctypes scratch was used
    finally:
        db.close()
        ref.close()


def test_native_multiget_fallbacks_pinned(tmp_path, monkeypatch):
    """Merge chains in SSTs are undecidable natively: they re-resolve in
    Python pinned to the batch's sequence, so a write landing between the
    native call and the re-resolution is not seen."""
    u64 = lambda v: v.to_bytes(8, "little")  # noqa: E731
    ref = RefDB.open(str(tmp_path / "ref"), RefOptions(
        merge_operator=ref_mo.UInt64AddOperator()))
    db = DB.open(str(tmp_path / "port"), _port_options(
        merge_operator=mo.UInt64AddOperator()))
    try:
        for d in (ref, db):
            for i in range(300):
                d.put(b"p%04d" % i, b"plain-%d" % i)
                if i % 3 == 0:
                    d.merge(b"c%04d" % i, u64(i))
            d.flush()
            for i in range(0, 300, 6):
                d.merge(b"c%04d" % i, u64(1000))
            d.flush()
        keys = [b"p%04d" % i for i in range(0, 300, 7)] + \
            [b"c%04d" % i for i in range(0, 300, 3)] + [b"zz"]
        resolved = []
        real = DB._mg_resolve_fallbacks

        def racing(self, out, keys_, snap_seq, opts, cf):
            resolved.append(sum(v is False for v in out))
            self.merge(b"c0000", u64(5))  # after the batch's sequence
            return real(self, out, keys_, snap_seq, opts, cf)

        monkeypatch.setattr(DB, "_mg_resolve_fallbacks", racing)
        got = db.multi_get(keys)
        assert resolved and resolved[0] > 0
        assert got == ref.multi_get(keys)
        ref.merge(b"c0000", u64(5))
        assert db.get(b"c0000") == ref.get(b"c0000") == u64(1005)
    finally:
        db.close()
        ref.close()


# ---------------------------------------------------------------------------
# The ring and the batcher
# ---------------------------------------------------------------------------


class _StubFile:
    """read(offset, n) / append(data) double that counts carrier preads."""

    def __init__(self, data: bytes = b""):
        self.data = bytearray(data)
        self.reads = 0
        self.read_ranges = []

    def read(self, offset: int, n: int) -> bytes:
        self.reads += 1
        self.read_ranges.append((offset, n))
        return bytes(self.data[offset:offset + n])

    def append(self, data: bytes) -> None:
        self.data += data

    def flush(self) -> None:
        pass


def test_ring_task_submissions_are_bounded(no_thread_leaks):
    """submit_task meets back-pressure at task_capacity; appends keep
    their own budget."""
    ring = AsyncIORing(capacity=64, task_capacity=4, name="tpt-bp-test")
    gate = threading.Event()
    running = threading.Event()
    try:
        blocker = ring.submit_task(
            lambda: (running.set(), gate.wait(timeout=10.0)))
        assert running.wait(timeout=5.0)
        toks = [ring.submit_task(lambda i=i: i) for i in range(4)]
        stalled = threading.Event()
        passed = threading.Event()

        def overflow():
            stalled.set()
            ring.submit_task(lambda: 99)  # the 5th queued task blocks
            passed.set()

        t = threading.Thread(target=overflow, daemon=True)
        t.start()
        assert stalled.wait(timeout=5.0)
        time.sleep(0.1)
        assert not passed.is_set(), "task submission was not back-pressured"
        f = _StubFile()
        t0 = time.monotonic()
        ring.submit_append(f, b"wal-bytes")
        assert time.monotonic() - t0 < 1.0
        gate.set()
        assert passed.is_set() or passed.wait(timeout=5.0)
        assert [tok.wait() for tok in toks] == [0, 1, 2, 3]
        blocker.wait()
        t.join(timeout=5.0)
    finally:
        gate.set()
        ring.close()
    assert bytes(f.data) == b"wal-bytes"


def _batcher_obs(B, stats_mod, case: str) -> dict:
    stats = stats_mod.Statistics()
    payload = bytes(range(256)) * 64
    f = _StubFile(payload)
    b = B(rings=2, stats=stats, name=f"tpt-{case}")
    try:
        if case == "coalesce":
            reqs = [(f, 0, 100), (f, 100, 100), (f, 150, 200),
                    (f, 8000, 64), (f, 16380, 10)]  # the last one at EOF
            got = [t.wait() for t in b.submit_batch(reqs)]
        elif case == "span":
            b.max_span = 256
            got = [t.wait() for t in b.submit_batch(
                [(f, i * 128, 128) for i in range(8)])]
        elif case == "preread":
            spans = b.preread(f, [(64, 64), (128, 32), (4096, 100)])
            got = [spans.read(64, 10), spans.read(130, 20),
                   spans.read(4100, 50), spans.read(9000, 8)]
            got.append((spans.hits, spans.misses))
        else:  # closed
            b.close()
            got = [t.wait() for t in b.submit_batch([(f, 0, 8),
                                                    (f, 64, 8)])]
            got.append(b.submit_task(lambda: 41 + 1).wait())
    finally:
        b.close()
    return dict(got=got, reads=f.reads, ranges=sorted(f.read_ranges),
                counters=(b.batches, b.coalesced, b.fallbacks),
                tickers=[stats.get_ticker_count(t) for t in (
                    stats_mod.READ_ASYNC_BATCHES,
                    stats_mod.READ_ASYNC_COALESCED,
                    stats_mod.READ_ASYNC_FALLBACKS)])


@pytest.mark.parametrize("case", ["coalesce", "span", "preread", "closed"])
def test_batcher_against_reference(no_thread_leaks, case):
    port = _batcher_obs(AsyncReadBatcher, st, case)
    ref = _batcher_obs(RefBatcher, ref_st, case)
    assert port == ref
    if case == "coalesce":
        assert port["reads"] == 3 and port["counters"] == (1, 2, 0)
    if case == "span":
        assert port["reads"] == 4 and all(n <= 256 for _, n in port["ranges"])
    if case == "closed":
        assert port["got"][-1] == 42 and port["counters"][2] > 0


# ---------------------------------------------------------------------------
# Sync / async parity matrix
# ---------------------------------------------------------------------------


def _build_matrix_db(open_db, table_options):
    """Several SSTs + overwrites + a snapshot pinning the state before a
    range tombstone + live memtable entries."""
    db = open_db(table_options)
    n = 500
    for i in range(n):
        db.put(b"key%05d" % i, b"val-%05d-" % i + b"p" * (i % 37))
    db.flush()
    for i in range(0, n, 3):
        db.put(b"key%05d" % i, b"OVR-%05d" % i)
    db.flush()
    db.wait_for_compactions()
    snap = db.get_snapshot()
    db.delete_range(b"key00100", b"key00160")
    for i in range(200, 230):
        db.put(b"key%05d" % i, b"mem-%05d" % i)  # stays in the memtable
    return db, snap, n


FORMATS = {
    "block-none": dict(block_size=512, compression=fmt.NO_COMPRESSION),
    "block-zstd": dict(block_size=512, compression=fmt.ZSTD_COMPRESSION),
    "zip-none": dict(format="zip", compression=fmt.NO_COMPRESSION),
    "zip-zstd": dict(format="zip", compression=fmt.ZSTD_COMPRESSION),
}


def _cache_of(mod, kind):
    if kind == "lru":
        return mod.LRUCache(64 * 1024, num_shards=1)
    if kind == "clock":
        return mod.ClockCache(16 * 1024, secondary=(
            mod.CompressedSecondaryCache(32 * 1024)))
    return None


def _opener(ref: bool, path: str, kind: str, async_reads=False, **kw):
    def open_db(topts):
        if ref:
            return RefDB.open(path, RefOptions(
                create_if_missing=True, write_buffer_size=16 * 1024,
                statistics=ref_st.Statistics(), table_options=RefTO(**topts),
                block_cache=_cache_of(ref_cache, kind), **kw))
        return DB.open(path, _port_options(
            create_if_missing=True, write_buffer_size=16 * 1024,
            statistics=Statistics(), table_options=TableOptions(**topts),
            block_cache=_cache_of(cache, kind), **kw),
            async_reads=async_reads)
    return open_db


def _observe(db, snap, keys, ro):
    out = {
        "mget": db.multi_get(keys),
        "mget_snap": db.multi_get(keys[::7], ro(snapshot=snap)),
        "mget_async_io": db.multi_get(keys[::3], ro(async_io=True)),
        "gets": [db.get(k) for k in keys[::13]],
        "get_snap": db.get(b"key00120", ro(snapshot=snap)),
    }
    it = db.new_iterator()
    it.seek_to_first()
    out["scan"] = list(it.entries())
    it = db.new_iterator(ro(readahead_size=64 * 1024))
    it.seek(b"key00250")
    out["scan_ra"] = list(it.entries())
    out["mget_async"] = db.multi_get_async(keys[::11]).result()
    out["get_async"] = db.get_async(b"key00300").result()
    return out


@pytest.mark.parametrize("kind", ["none", "lru", "clock"])
@pytest.mark.parametrize("label", sorted(FORMATS))
def test_sync_async_parity_matrix(tmp_path, ref_knob, no_thread_leaks,
                                  label, kind):
    topts = FORMATS[label]
    rdb, rsnap, n = _build_matrix_db(
        _opener(True, str(tmp_path / "ref"), kind), topts)
    sdb, ssnap, _ = _build_matrix_db(
        _opener(False, str(tmp_path / "sync"), kind), topts)
    adb, asnap, _ = _build_matrix_db(
        _opener(False, str(tmp_path / "async"), kind, async_reads=True),
        topts)
    try:
        keys = [b"key%05d" % i for i in range(n)] + [b"nope", b"zzzz"]
        ref_knob("0")
        ref_sync = _observe(rdb, rsnap, keys, RefReadOptions)
        ref_knob("1")
        ref_async = _observe(rdb, rsnap, keys, RefReadOptions)
        assert ref_async == ref_sync
        port_sync = _observe(sdb, ssnap, keys, ReadOptions)
        port_async = _observe(adb, asnap, keys, ReadOptions)
        assert port_sync == ref_sync
        assert port_async == ref_sync
        assert ref_sync["mget"][110] is None  # the tombstone is exercised
        assert ref_sync["get_snap"] is not None
        assert adb._read_batcher is not None and sdb._read_batcher is None
        if label != "zip-none":
            # The async handle drove the batcher (cold blocks or
            # compressed value groups were planned); zip-none holds its
            # table resident with uncompressed value groups.
            assert adb.stats.get_ticker_count(st.READ_ASYNC_BATCHES) > 0
        assert sdb.stats.get_ticker_count(st.READ_ASYNC_BATCHES) == 0
    finally:
        for db, snap in ((rdb, rsnap), (sdb, ssnap), (adb, asnap)):
            db.release_snapshot(snap)
            db.close()


# ---------------------------------------------------------------------------
# Faults through the reader rings, close(), futures
# ---------------------------------------------------------------------------


def _matrix_pair(tmp_path):
    topts = FORMATS["block-none"]
    rdb, rsnap, n = _build_matrix_db(
        _opener(True, str(tmp_path / "ref"), "none"), topts)
    rdb.release_snapshot(rsnap)
    adb, asnap, _ = _build_matrix_db(
        _opener(False, str(tmp_path / "async"), "none", async_reads=True),
        topts)
    adb.release_snapshot(asnap)
    return rdb, adb, [b"key%05d" % i for i in range(n)]


def test_async_read_error_propagates_then_resumes(tmp_path, ref_knob,
                                                  no_thread_leaks):
    rdb, adb, keys = _matrix_pair(tmp_path)
    try:
        oracle = rdb.multi_get(keys)
        rdb.read_fault_hook = RefInjector(schedule={0: "fail"})
        adb.read_fault_hook = ReadFaultInjector(schedule={0: "fail"})
        ref_knob("1")
        with pytest.raises(Exception, match="injected reader-ring"):
            rdb.multi_get(keys)
        with pytest.raises(IOError_, match="injected reader-ring"):
            adb.multi_get(keys)
        # The error settled one token; the same rings serve cleanly.
        assert adb.multi_get(keys) == rdb.multi_get(keys) == oracle
        assert adb.read_fault_hook.injected_counts() == \
            rdb.read_fault_hook.injected_counts() == {"fail": 1}
    finally:
        adb.close()
        rdb.close()


def test_async_read_delay_plan_keeps_parity(tmp_path, ref_knob,
                                            no_thread_leaks):
    rdb, adb, keys = _matrix_pair(tmp_path)
    try:
        oracle = rdb.multi_get(keys)
        adb.read_fault_hook = ReadFaultInjector(
            rate=1.0, plans=("delay",), delay_sec=0.0002)
        assert adb.multi_get(keys) == oracle
        assert adb.read_fault_hook.injected_counts().get("delay", 0) > 0
    finally:
        adb.close()
        rdb.close()


def test_db_close_joins_reader_rings(tmp_path, no_thread_leaks):
    """No reader-ring or executor thread outlives DB.close()."""
    topts = FORMATS["block-none"]
    db, snap, _ = _build_matrix_db(
        _opener(False, str(tmp_path / "db"), "lru", async_reads=True), topts)
    db.release_snapshot(snap)
    db.multi_get([b"key%05d" % i for i in range(0, 500, 5)])
    db.multi_get([b"key%05d" % i for i in range(0, 500, 5)],
                 ReadOptions(async_io=True))
    it = db.new_iterator()
    it.seek_to_first()
    next(iter(it.entries()), None)
    assert db.get_async(b"key00042").result() == db.get(b"key00042")
    before = {t.name for t in threading.enumerate()}
    assert any(n.startswith("tpt-read-") for n in before)
    assert any(n.startswith("tpt-get-async") for n in before)
    db.close()
    after = {t.name for t in threading.enumerate()}
    assert not any(n.startswith(("tpt-read", "tpt-get-async", "tpt-mget"))
                   for n in after), after
    # A closed DB's batcher is gone: nothing re-creates it.
    assert db._read_batcher is None and db._reader_batcher() is None


@pytest.mark.parametrize("async_reads", [False, True])
def test_get_async_multi_get_async_futures(tmp_path, ref_knob,
                                           no_thread_leaks, async_reads):
    ref_knob("1" if async_reads else "0")
    ref = RefDB.open(str(tmp_path / "ref"), RefOptions(
        statistics=ref_st.Statistics()))
    db = DB.open(str(tmp_path / "port"), _port_options(
        statistics=Statistics()), async_reads=async_reads)
    try:
        for d in (ref, db):
            for i in range(64):
                d.put(b"k%03d" % i, b"v%03d" % i)
            d.flush()
        for d in (ref, db):
            futs = [d.get_async(b"k%03d" % i) for i in range(0, 64, 4)]
            assert [f.result() for f in futs] == \
                [b"v%03d" % i for i in range(0, 64, 4)]
            mf = d.multi_get_async([b"k001", b"missing", b"k050"])
            assert mf.result() == [b"v001", None, b"v050"]
        for t in (st.NUMBER_MULTIGET_CALLS, st.NUMBER_MULTIGET_KEYS_READ,
                  st.NUMBER_MULTIGET_BYTES_READ):
            assert db.stats.get_ticker_count(t) == \
                ref.stats.get_ticker_count(t)
    finally:
        db.close()
        ref.close()


# ---------------------------------------------------------------------------
# tests/test_prefetch_partitioned_filters.py
# ---------------------------------------------------------------------------


def _build_table(path, n, ref: bool, **topts):
    env = ref_env() if ref else default_env()
    icmp = RefICmp() if ref else InternalKeyComparator()
    to = (RefTO if ref else TableOptions)(**topts)
    w = env.new_writable_file(path)
    b = (RefTableBuilder if ref else TableBuilder)(w, icmp, to)
    mk = ref_mik if ref else make_internal_key
    vt = (RefVT if ref else ValueType).VALUE
    for i in range(n):
        b.add(mk(b"key%07d" % i, i + 1, vt), b"value-%07d" % i)
    b.finish()
    w.close()
    return (RefTableReader if ref else TableReader)(
        env.new_random_access_file(path), icmp, to)


@pytest.mark.parametrize("mode", ["auto", "readahead", "ring"])
def test_prefetch_buffer_counts(tmp_path, no_thread_leaks, mode):
    """A sequential scan is served mostly from the readahead window, random
    seeks arm none; the same counts in both packages, for the auto ramp,
    a fixed readahead_size window and windows read on a ring."""
    obs = []
    for ref in (True, False):
        r = _build_table(str(tmp_path / f"t{ref}.sst"), 20000, ref,
                         block_size=4096, filter_policy=None)
        ring = None
        kw = {}
        if mode == "readahead":
            kw = dict(readahead_size=64 * 1024)
        elif mode == "ring":
            ring = (RefRing if ref else AsyncIORing)(name="tpt-pf-test")
            kw = dict(aio_ring=ring)
        try:
            it = r.new_iterator(**kw)
            it.seek_to_first()
            rows = list(it.entries())
            pf = it._pf
            it2 = r.new_iterator(**kw)
            rng = random.Random(3)
            vt = (RefVT if ref else ValueType).MAX
            mk = ref_mik if ref else make_internal_key
            for _ in range(50):
                it2.seek(mk(b"key%07d" % rng.randrange(20000), 1 << 40, vt))
                assert it2.valid()
            obs.append((rows, pf.hits, pf.misses, it2._pf.hits,
                        r.properties.num_data_blocks))
        finally:
            if ring is not None:
                ring.close()
            r.close()
    assert obs[1] == obs[0]
    rows, hits, misses, rand_hits, nblocks = obs[1]
    assert len(rows) == 20000 and nblocks > 50
    assert misses < nblocks / 4 and hits > nblocks / 2
    if mode == "auto":
        assert rand_hits <= 2  # random seeks: essentially all misses


def test_partitioned_filter_probes(tmp_path):
    topts = dict(block_size=512, partition_filters=True,
                 metadata_block_size=1024)
    rr = _build_table(str(tmp_path / "r.sst"), 5000, True, **topts)
    pr = _build_table(str(tmp_path / "p.sst"), 5000, False, **topts)
    assert open(str(tmp_path / "r.sst"), "rb").read() == \
        open(str(tmp_path / "p.sst"), "rb").read()
    assert pr._filter_top is not None
    probes = [b"key%07d" % i for i in range(0, 5000, 61)] + \
        [b"zzz%07d" % i for i in range(5000)] + [b"~~~~"]
    got = [pr.key_may_match(k) for k in probes]
    assert got == [rr.key_may_match(k) for k in probes]
    assert all(got[:82]) and not got[-1]
    assert sum(got[82:-1]) < 5000 * 0.05
    rr.close()
    pr.close()


@pytest.mark.parametrize("with_cache", [False, True])
def test_partitioned_filter_in_db(tmp_path, no_thread_leaks, with_cache):
    obs = []
    for ref in (True, False):
        stats = (ref_st if ref else st).Statistics()
        kw = dict(create_if_missing=True, write_buffer_size=1 << 20,
                  statistics=stats,
                  block_cache=(_cache_of(ref_cache if ref else cache, "lru")
                               if with_cache else None))
        # Both compactions on the device route, which reads its inputs
        # past the block cache (the reference's host route reads them
        # through it).
        o = RefOptions(compaction_executor_factory=RefFactory(
            device="cpu-jax"), **kw) if ref else _port_options(**kw)
        o.table_options = dataclasses.replace(
            o.table_options, partition_filters=True,
            metadata_block_size=512, block_size=512)
        d = str(tmp_path / ("ref" if ref else "port"))
        open_ = RefDB.open if ref else DB.open
        with open_(d, o) as db:
            for i in range(4000):
                db.put(b"key%06d" % i, b"v%06d" % i)
            db.flush()
            db.compact_range()
            got = [db.get(b"key001234"), db.get(b"nope"),
                   db.multi_get([b"key%06d" % i for i in range(0, 4400, 9)])]
        with open_(d, o) as db2:
            got.append(db2.get(b"key003999"))
        bc = o.block_cache
        obs.append((got, stats.get_ticker_count(
            (ref_st if ref else st).BLOOM_USEFUL),
            None if bc is None else (bc.hit_rate(), bc.usage())))
    assert obs[1] == obs[0]
    assert obs[1][0][0] == b"v001234" and obs[1][0][1] is None


# ---------------------------------------------------------------------------
# async_io, readahead_size scans, the cold twin
# ---------------------------------------------------------------------------


def _layered(d, rng_seed=8):
    """A leveled DB with three levels' worth of flushes, a snapshot and a
    range tombstone in an SST."""
    rng = random.Random(rng_seed)
    model = {}
    for layer in range(4):
        for _ in range(1200):
            k = b"key%05d" % rng.randrange(2500)
            model[k] = b"L%d-" % layer + k * rng.randrange(1, 5)
            d.put(k, model[k])
        if layer == 2:
            d.delete_range(b"key00300", b"key00420")
        d.flush()
        if layer == 1:
            d.compact_range()
    return sorted(model)


@pytest.mark.parametrize("chunk", [4096, 0])
def test_async_io_and_readahead_scans(tmp_path, monkeypatch, ref_knob,
                                      no_thread_leaks, chunk):
    """multi_get(async_io=True) and scans with readahead_size, on the scan
    plane (chunk rows 4096) and on the per-entry path (0), with and
    without the async plane's ring windows, against the reference; the
    PREFETCH_* tickers of the readahead scan are equal."""
    monkeypatch.setenv("TPULSM_ITER_CHUNK", str(chunk))
    ref = RefDB.open(str(tmp_path / "ref"), RefOptions(
        disable_auto_compactions=True, statistics=ref_st.Statistics()))
    ports = [DB.open(str(tmp_path / f"port{a}"), _port_options(
        disable_auto_compactions=True, statistics=Statistics()),
        iter_chunk_rows=chunk, async_reads=a) for a in (False, True)]
    try:
        for d in [ref] + ports:
            keys = _layered(d)
        probe = keys[::3] + [b"key00350", b"nope"]
        ra = 256 * 1024

        def views(db, ro):
            out = [db.multi_get(probe, ro(async_io=True)),
                   db.multi_get(probe, ro(async_io=True,
                                          async_queue_depth=1))]
            for kw in ({}, dict(readahead_size=ra)):
                it = db.new_iterator(ro(**kw))
                it.seek_to_first()
                out.append(list(it.entries()))
                it = db.new_iterator(ro(**kw))
                it.seek(b"key01000")
                part = []
                while it.valid() and len(part) < 300:
                    part.append((it.key(), it.value()))
                    it.next()
                it.seek_to_last()
                while it.valid() and len(part) < 600:
                    part.append((it.key(), it.value()))
                    it.prev()
                out.append(part)
            return out

        def prefetch_counts(db, mod):
            return [db.stats.get_ticker_count(t)
                    for t in (mod.PREFETCH_HITS, mod.PREFETCH_MISSES)]

        # The views' own prefetch counts (the reference's host compactions
        # tick them too, before the views).
        counts = {}
        for name, db, mod in (("ref", ref, ref_st), ("sync", ports[0], st),
                              ("async", ports[1], st)):
            counts[name] = prefetch_counts(db, mod)
        ref_knob("0")
        want = views(ref, RefReadOptions)
        ref0 = prefetch_counts(ref, ref_st)
        for p in ports:
            assert views(p, ReadOptions) == want
        ref_knob("1")
        assert views(ref, RefReadOptions) == want
        ref1 = prefetch_counts(ref, ref_st)
        assert want[2] == want[4] and len(want[2]) > 2000
        delta = lambda a, b: [x - y for x, y in zip(a, b)]  # noqa: E731
        assert delta(prefetch_counts(ports[0], st), counts["sync"]) == \
            delta(ref0, counts["ref"])
        assert delta(prefetch_counts(ports[1], st), counts["async"]) == \
            delta(ref1, ref0)
        if chunk:
            assert delta(ref0, counts["ref"])[0] > 0
    finally:
        for d in ports + [ref]:
            d.close()


def test_delayed_read_env_cold_twin(tmp_path, ref_knob, no_thread_leaks):
    """The cold-cache twin of the bench at a small size: a DelayedReadEnv
    (no raw fd, so the native chain is off on both), a 64 KiB LRU block
    cache, the async plane on and off: equal answers, and the reference's
    knob-1 run equal too."""
    n = 3000
    path = str(tmp_path / "db")
    with DB.open(path, _port_options(write_buffer_size=64 * 1024)) as db:
        for i in range(n):
            db.put(b"user%08d" % i, b"v%08d" % i + b"x" * 40)
        db.flush()
        db.compact_range()
    rng = random.Random(2)
    probes = [b"user%08d" % rng.randrange(n + 50) for _ in range(512)]
    views = []
    for a in (False, True):
        env = DelayedReadEnv(default_env(), delay_sec=0.0001)
        stats = Statistics()
        with DB.open(path, _port_options(
                block_cache=cache.LRUCache(64 * 1024), statistics=stats),
                env=env, async_reads=a) as db:
            v = [db.multi_get(probes[i:i + 128])
                 for i in range(0, len(probes), 128)]
            v.append([db.get(k) for k in probes[:64]])
            assert env.delayed_reads > 0
            batches = stats.get_ticker_count(st.READ_ASYNC_BATCHES)
            assert (batches > 0) == a
        views.append(v)
    assert views[0] == views[1]
    flat = [x for b in views[0][:-1] for x in b]
    assert flat == [b"v%08d" % int(k[4:]) + b"x" * 40 if int(k[4:]) < n
                    else None for k in probes]
    ref_knob("1")
    env = RefDelayed(ref_env(), delay_sec=0.0001)
    with RefDB.open(path, RefOptions(
            block_cache=ref_cache.LRUCache(64 * 1024)), env=env) as rdb:
        assert [rdb.multi_get(probes[i:i + 128])
                for i in range(0, len(probes), 128)] == views[0][:-1]


def test_port_reads_no_async_knob():
    """No source of the port names TPULSM_ASYNC_READS as a string constant
    (the way an environment lookup would), and the read path's modules
    read no os.environ or os.getenv."""
    port = os.path.join(REPO, "toplingdb_tpu_torch")
    read_path = ("db/db.py", "env/async_reads.py", "table/reader.py",
                 "table/prefetch.py", "db/table_cache.py",
                 "db/level_iterator.py", "utils/cache.py",
                 "utils/persistent_cache.py")
    seen = 0
    for dirpath, _, names in os.walk(port):
        for n in names:
            if not n.endswith(".py"):
                continue
            path = os.path.join(dirpath, n)
            tree = ast.parse(open(path).read(), filename=path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Constant) and \
                        node.value == "TPULSM_ASYNC_READS":
                    pytest.fail(f"{path}:{node.lineno} names the knob")
                if (path.endswith(read_path)
                        and isinstance(node, ast.Attribute)
                        and node.attr in ("environ", "getenv")):
                    pytest.fail(f"{path}:{node.lineno} reads os.{node.attr}")
            seen += 1
    assert seen > 50
