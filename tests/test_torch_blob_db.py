"""Integrated blob files in toplingdb_tpu_torch's DB against toplingdb_tpu's,
on the CPU:

- each blob field opens the port's DB;
- the blob cases of tests/test_db.py (:175, 206, 236, 422, 444, 464, 491,
  931: separation at flush, a merge over a blob base, min_blob_size 0,
  blob refs and the deletion of an unreferenced blob file, refs through
  reopen and a pass-through compaction, blob GC rewriting the aged files,
  GC inlining small survivors, GC shrinking storage after an overwrite;
  the checkpoint case :223 waits for the port's checkpoints), each
  through both DBs in tests/test_torch_db.py's `Twin` with the device
  executor ("cpu" against "cpu-jax": the columnar blob route without GC,
  the per-entry route with it) and the host path: views, and the SST,
  blob file, WAL and MANIFEST bytes and the level sets where flushes are
  explicit;
- a flush whose blob file comes out empty deletes it and still draws its
  number, as the reference's; a universal blob DB with GC;
- the value cache of tests/test_blob_cache.py:30-90 (warm hits, capacity
  eviction, a shared cache instance, no cache, the open-reader limit),
  with every BLOB_DB_* ticker equal to the reference DB's;
- gets of BLOB_INDEX rows take the Python chain, inline values the native
  one, and scans resolve blobs in the chunk plane;
- seeded random blob sequences with and without GC, with bytes;
- a blob DB's job through the port's in-process dcompact service: the
  worker resolves blobs through its own BlobSource.

Tolerance: none.
"""

import os
import random

import pytest
from test_torch_db import Twin, pinned_clock  # noqa: F401

import toplingdb_tpu.db.db as ref_dbm
from toplingdb_tpu.options import Options as RefOptions
from toplingdb_tpu.utils import statistics as ref_st

import toplingdb_tpu_torch.db.db as dbm
from toplingdb_tpu_torch import options as popts
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory,
    LocalCompactionExecutorFactory,
)
from toplingdb_tpu_torch.db import blob as blob_mod
from toplingdb_tpu_torch.options import Options
from toplingdb_tpu_torch.utils import statistics as st
from toplingdb_tpu_torch.utils.cache import LRUCache

BLOB = dict(enable_blob_files=True)
GC = dict(enable_blob_files=True, enable_blob_garbage_collection=True,
          blob_garbage_collection_age_cutoff=1.0)


def _blob_files(d):
    return sorted(n for n in os.listdir(d) if n.endswith(".blob"))


# ---------------------------------------------------------------------------
# The fields open
# ---------------------------------------------------------------------------

NOW_OPEN = {
    "enable_blob_files": dict(enable_blob_files=True),
    "min_blob_size": dict(enable_blob_files=True, min_blob_size=4),
    "enable_blob_garbage_collection": dict(
        enable_blob_files=True, enable_blob_garbage_collection=True),
    "blob_garbage_collection_age_cutoff": dict(
        enable_blob_files=True, enable_blob_garbage_collection=True,
        blob_garbage_collection_age_cutoff=0.5),
    "blob_cache": dict(enable_blob_files=True, blob_cache=1 << 20),
    "blob_file_open_limit": dict(enable_blob_files=True,
                                 blob_file_open_limit=4),
}


@pytest.mark.parametrize("name", sorted(NOW_OPEN))
def test_ported_option_opens(tmp_path, name):
    assert name not in popts.UNPORTED
    opts = Options(compaction_executor_factory=(
        LocalCompactionExecutorFactory()), **NOW_OPEN[name])
    assert popts.unported_fields(opts) == []
    with dbm.DB.open(str(tmp_path / "db"), opts) as db:
        db.put(b"k", b"v" * 300)
        db.flush()
        assert db.get(b"k") == b"v" * 300
        assert db.versions.current.files[0][0].blob_refs
        db.compact_range()
        assert db.get(b"k") == b"v" * 300
    with dbm.DB.open(str(tmp_path / "db"), opts) as db:
        assert db.get(b"k") == b"v" * 300


# ---------------------------------------------------------------------------
# The blob cases of tests/test_db.py through both DBs
# ---------------------------------------------------------------------------


def case_blob_files(t):                                      # :175
    small, big = b"s" * 10, b"B" * 5000
    for i in range(200):
        t.put(b"key%03d" % i, big if i % 2 else small)
    t.flush()
    assert _blob_files(t.dir) == _blob_files(t.ref_dir) != []
    assert t.get(b"key001") == big and t.get(b"key002") == small
    vals = [v for _, v in t.check()]
    assert vals[1] == big and vals[2] == small
    sst = sum(os.path.getsize(os.path.join(t.dir, n))
              for n in os.listdir(t.dir) if n.endswith(".sst"))
    assert sst < 100 * 5000 / 4
    t.compact_range()  # blob indexes pass through compaction
    assert t.get(b"key199") == big


def case_blob_merge_resolves_base(t):                        # :206
    t.put(b"k", b"B" * 500)
    t.flush()  # the value becomes a BLOB_INDEX
    t.merge(b"k", b"tail")
    t.flush()
    t.compact_range()
    assert t.get(b"k") == b"B" * 500 + b",tail"


def case_min_size_zero_separates_everything(t):              # :236
    t.put(b"k", b"tiny")
    t.flush()
    assert _blob_files(t.dir) != []
    assert t.get(b"k") == b"tiny"


def case_unreferenced_blob_deleted(t):                       # :422
    t.put(b"k1", b"B" * 100)
    t.flush()
    assert t.port.versions.current.files[0][0].blob_refs
    assert len(_blob_files(t.dir)) == 1
    t.put(b"k1", b"small")
    t.flush()
    t.compact_range()
    assert t.get(b"k1") == b"small"
    assert _blob_files(t.dir) == [] == _blob_files(t.ref_dir)


def case_refs_survive_reopen_and_passthrough(t):             # :444
    for i in range(5):
        t.put(b"k%d" % i, b"V%d" % i * 20)
    t.flush()
    refs0 = t.port.versions.current.files[0][0].blob_refs
    assert refs0
    t.reopen()  # the MANIFEST round trip
    assert t.port.versions.current.files[0][0].blob_refs == refs0
    t.compact_range()  # pass-through: the output carries the refs
    files = [f for lvl in t.port.versions.current.files for f in lvl]
    assert len(files) == 1 and files[0].blob_refs == refs0
    assert len(_blob_files(t.dir)) == 1


def case_gc_rewrites_old_files(t):                           # :464
    for i in range(4):
        t.put(b"a%d" % i, b"X%d" % i * 30)
    t.flush()
    for i in range(4):
        t.put(b"b%d" % i, b"Y%d" % i * 30)
    t.flush()
    old = _blob_files(t.dir)
    assert len(old) == 2
    t.compact_range()
    new = _blob_files(t.dir)
    assert len(new) == 1 and new[0] not in old
    assert new == _blob_files(t.ref_dir)
    for i in range(4):
        assert t.get(b"a%d" % i) == b"X%d" % i * 30


def case_gc_inlines_small_survivors(t):                      # :491
    t.put(b"k", b"Z" * 50)
    t.flush()
    t.close()
    # At GC time the 50-byte value is under the new 100-byte threshold.
    t.kw.update(GC, min_blob_size=100)
    t.open()
    t.compact_range()
    assert t.get(b"k") == b"Z" * 50
    assert _blob_files(t.dir) == []
    assert all(not f.blob_refs
               for lvl in t.port.versions.current.files for f in lvl)


def case_gc_shrinks_storage_on_overwrite(t):                 # :931
    for i in range(2000):
        t.put(b"k%05d" % i, b"B" * 500)
    t.flush()
    for i in range(2000):
        t.put(b"k%05d" % i, b"C" * 500)
    t.flush()

    def blob_bytes(d):
        return sum(os.path.getsize(os.path.join(d, n))
                   for n in _blob_files(d))

    before = blob_bytes(t.dir)
    t.compact_range()
    t.wait()
    assert blob_bytes(t.dir) < before * 0.6
    for i in range(0, 2000, 97):
        assert t.get(b"k%05d" % i) == b"C" * 500


def case_empty_blob_file_keeps_its_number(t):
    """A flush with no value to separate draws the blob number and deletes
    the empty file; the MANIFEST's next file number follows."""
    t.put(b"a", b"x")
    t.flush()
    assert _blob_files(t.dir) == []
    assert not t.port.versions.current.files[0][0].blob_refs
    t.put(b"b", b"y" * 300)
    t.flush()
    assert len(_blob_files(t.dir)) == 1
    assert t.port.versions.next_file_number == \
        t.ref.versions.next_file_number
    t.compact_range()


def case_universal_blob_gc(t):
    for round_ in range(5):
        for i in range(round_, 300, 2):
            t.put(b"k%04d" % i, b"%d" % round_ * 200)
        t.flush()
    t.wait()
    t.compact_range()
    levels = [fl for fl in t.port.versions.current.files if fl]
    assert len(levels) == 1 and len(levels[0]) == 1
    # The older half of the referenced blob files was rewritten away.
    assert len(levels[0][0].blob_refs) == 2
    assert _blob_files(t.dir) == _blob_files(t.ref_dir)


CASES = [
    (case_blob_files, dict(BLOB, min_blob_size=100), False),
    (case_blob_merge_resolves_base,
     dict(BLOB, min_blob_size=100, merge_operator="StringAppendOperator"),
     False),
    (case_min_size_zero_separates_everything, dict(BLOB, min_blob_size=0),
     False),
    (case_unreferenced_blob_deleted, dict(BLOB, min_blob_size=10), False),
    (case_refs_survive_reopen_and_passthrough, dict(BLOB, min_blob_size=10),
     False),
    (case_gc_rewrites_old_files, dict(GC, min_blob_size=10), False),
    (case_gc_inlines_small_survivors, dict(BLOB, min_blob_size=10), False),
    (case_gc_shrinks_storage_on_overwrite,
     dict(GC, min_blob_size=50, write_buffer_size=4 << 20), True),
    (case_empty_blob_file_keeps_its_number, dict(BLOB, min_blob_size=100),
     False),
    (case_universal_blob_gc,
     dict(GC, min_blob_size=100, compaction_style="universal",
          level0_file_num_compaction_trigger=3,
          blob_garbage_collection_age_cutoff=0.5), True),
]


@pytest.mark.parametrize("executor", ["device", "cpu"])
@pytest.mark.parametrize("case,kw,auto", CASES,
                         ids=[c[0].__name__[5:] for c in CASES])
def test_blob_scenario(tmp_path, pinned_clock, case, kw, auto,  # noqa: F811
                       executor):
    t = Twin(str(tmp_path), executor, True, auto=auto, **kw)
    try:
        case(t)
        t.check()
        if executor == "device":
            assert t.port.options.compaction_executor_factory.jobs or \
                not any(t.port.versions.current.files[1:])
        t.reopen()
    finally:
        t.close()


def test_gc_jobs_take_the_per_entry_route_on_the_device(tmp_path,
                                                        pinned_clock,  # noqa: F811
                                                        monkeypatch):
    """With GC on, the device executor's jobs take the per-entry route
    (collect_raw_entries -> device_gc_entries); without it, the columnar
    route; the bytes equal the reference's either way."""
    import toplingdb_tpu_torch.ops.device_compaction as dc

    calls = []
    real = dc.collect_raw_entries

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(dc, "collect_raw_entries", spy)
    for gc, sub in ((False, "plain"), (True, "gc")):
        calls.clear()
        kw = dict(GC if gc else BLOB, min_blob_size=20)
        t = Twin(str(tmp_path / sub), "device", True, **kw)
        try:
            for r in range(3):
                for i in range(r, 500, 3):
                    t.put(b"k%04d" % i, b"%d" % r * 40 if i % 4 else b"s")
                t.flush()
            t.compact_range()
            t.check()
            jobs = t.port.options.compaction_executor_factory.jobs
            assert jobs
            assert bool(calls) == gc, (gc, len(calls), len(jobs))
        finally:
            t.close()


# ---------------------------------------------------------------------------
# The value cache (tests/test_blob_cache.py:30-90), tickers against the
# reference DB's
# ---------------------------------------------------------------------------

BLOB_TICKERS = [name for name in dir(st) if name.startswith("BLOB_DB_")]


class _Pair:
    """The reference DB and the port's, each with its own Statistics."""

    def __init__(self, root, n=300, vsize=600, blob_cache=None, **kw):
        self.rs, self.ps = ref_st.Statistics(), st.Statistics()
        rcache, pcache = blob_cache, blob_cache
        if blob_cache == "instance":
            from toplingdb_tpu.utils.cache import LRUCache as RefLRUCache

            rcache, pcache = RefLRUCache(1 << 20), LRUCache(1 << 20)
        common = dict(create_if_missing=True, enable_blob_files=True,
                      min_blob_size=256, memtable_rep="vector", **kw)
        self.ref = ref_dbm.DB.open(os.path.join(root, "ref"), RefOptions(
            statistics=self.rs, blob_cache=rcache, **common))
        self.port = dbm.DB.open(os.path.join(root, "port"), Options(
            statistics=self.ps, blob_cache=pcache,
            compaction_executor_factory=DeviceCompactionExecutorFactory(
                device="cpu"), **common))
        for db in (self.ref, self.port):
            for i in range(n):
                db.put(b"k%06d" % i, b"B%05d" % i + b"x" * (vsize - 6))
            db.flush()
            db.wait_for_compactions()

    def get(self, k):
        r, p = self.ref.get(k), self.port.get(k)
        assert p == r, k
        return p

    def tick(self, name):
        return self.ps.get_ticker_count(getattr(st, name))

    def check_tickers(self):
        for name in BLOB_TICKERS:
            assert self.tick(name) == self.rs.get_ticker_count(
                getattr(ref_st, name)), name

    def close(self):
        self.ref.close()
        self.port.close()


def test_blob_value_cache_hits(tmp_path):
    p = _Pair(str(tmp_path), blob_cache=4 << 20)
    try:
        for i in range(300):
            assert p.get(b"k%06d" % i)[:6] == b"B%05d" % i
        misses0 = p.tick("BLOB_DB_CACHE_MISS")
        file_bytes0 = p.tick("BLOB_DB_BLOB_FILE_BYTES_READ")
        assert misses0 > 0 and file_bytes0 > 0
        for i in range(300):
            assert p.get(b"k%06d" % i)[:6] == b"B%05d" % i
        assert p.tick("BLOB_DB_CACHE_MISS") == misses0
        assert p.tick("BLOB_DB_BLOB_FILE_BYTES_READ") == file_bytes0
        assert p.tick("BLOB_DB_CACHE_HIT") >= 300
        p.check_tickers()
    finally:
        p.close()


def test_blob_cache_capacity_evicts(tmp_path):
    p = _Pair(str(tmp_path), blob_cache=2048)
    try:
        for i in range(300):
            p.get(b"k%06d" % i)
        m0 = p.tick("BLOB_DB_CACHE_MISS")
        for i in range(300):
            p.get(b"k%06d" % i)
        assert p.tick("BLOB_DB_CACHE_MISS") > m0
        p.check_tickers()
    finally:
        p.close()


def test_blob_cache_accepts_cache_instance(tmp_path):
    p = _Pair(str(tmp_path), blob_cache="instance")
    try:
        assert isinstance(p.port.blob_source._cache, LRUCache)
        for _ in range(2):
            for i in range(100):
                p.get(b"k%06d" % i)
        assert p.tick("BLOB_DB_CACHE_HIT") >= 100
        p.check_tickers()
    finally:
        p.close()


def test_no_cache_still_reads(tmp_path):
    p = _Pair(str(tmp_path))
    try:
        for i in range(50):
            assert p.get(b"k%06d" % i) is not None
        assert p.tick("BLOB_DB_CACHE_HIT") == 0
        assert p.tick("BLOB_DB_BLOB_FILE_BYTES_READ") > 0
        p.check_tickers()
    finally:
        p.close()


def test_reader_open_limit(tmp_path):
    p = _Pair(str(tmp_path), n=400, write_buffer_size=16 << 10,
              blob_file_open_limit=2)
    try:
        assert len(_blob_files(p.port.dbname)) > 2
        for i in range(0, 400, 7):
            assert p.get(b"k%06d" % i) is not None
        assert len(p.port.blob_source._readers) <= 2
        p.check_tickers()
    finally:
        p.close()


def test_lru_cache_against_the_reference():
    """The port's LRUCache: the same hits, evictions and usage as the
    reference's, over one random op stream."""
    from toplingdb_tpu.utils.cache import LRUCache as RefLRUCache

    rng = random.Random(4)
    rc = RefLRUCache(4096, num_shards=4)
    pc = LRUCache(4096, num_shards=4)
    for _ in range(3000):
        k = b"k%03d" % rng.randrange(200)
        r = rng.random()
        if r < 0.5:
            assert pc.lookup(k) == rc.lookup(k)
        elif r < 0.9:
            v = b"v" * rng.randrange(1, 200)
            rc.insert(k, v, len(v))
            pc.insert(k, v, len(v))
        else:
            rc.erase(k)
            pc.erase(k)
        assert pc.usage() == rc.usage()
    assert pc.hit_rate() == rc.hit_rate()


# ---------------------------------------------------------------------------
# Read paths
# ---------------------------------------------------------------------------


def test_blob_gets_take_the_python_chain(tmp_path):
    """Gets of keys whose SST row is a BLOB_INDEX are decided by the Python
    chain (the native walk hands them back), inline values by the native
    chain; a scan resolves the blobs in the chunk plane."""
    opts = Options(enable_blob_files=True, min_blob_size=100,
                   compaction_executor_factory=DeviceCompactionExecutorFactory(
                       device="cpu"))
    with dbm.DB.open(str(tmp_path / "db"), opts) as db:
        for i in range(100):
            db.put(b"k%03d" % i, b"B" * 300 if i % 2 else b"s%d" % i)
        db.flush()
        calls = []
        chain = db._native_get

        def spy(*a):
            r = chain(*a)
            calls.append(r[0])
            return r

        db._native_get = spy
        for i in range(100):
            want = b"B" * 300 if i % 2 else b"s%d" % i
            assert db.get(b"k%03d" % i) == want
        assert calls == [i % 2 == 0 for i in range(100)]
        it = db.new_iterator()
        it.seek_to_first()
        got = list(it.entries())
        assert it._plane is not None
        assert [v for _, v in got] == [
            b"B" * 300 if i % 2 else b"s%d" % i for i in range(100)]


def test_blob_resolver_reads_a_foreign_blob_file(tmp_path):
    """The port's BlobSource reads a blob file the reference wrote, and
    the reference's reads the port's (one format)."""
    from toplingdb_tpu.db import blob as ref_blob
    from toplingdb_tpu.env import default_env as ref_env

    from toplingdb_tpu_torch.env import PosixEnv

    d = str(tmp_path)
    idx = {}
    for mod, env, num in ((ref_blob, ref_env(), 7), (blob_mod, PosixEnv(), 8)):
        b = mod.BlobFileBuilder(env, d, num)
        idx[num] = [b.add(b"k%d" % i, b"v%d" % i * 50) for i in range(20)]
        assert b.finish() == 20
    with open(os.path.join(d, "000007.blob"), "rb") as f7, \
            open(os.path.join(d, "000008.blob"), "rb") as f8:
        a, b = f7.read(), f8.read()
    assert a == b
    rsrc = ref_blob.BlobSource(ref_env(), d)
    psrc = blob_mod.BlobSource(PosixEnv(), d, blob_cache=1 << 16)
    for num in (7, 8):
        for i, ix in enumerate(idx[num]):
            assert psrc.get(ix) == rsrc.get(ix) == b"v%d" % i * 50
    psrc.close()
    rsrc.close()


# ---------------------------------------------------------------------------
# Random blob sequences
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("executor", ["device", "cpu"])
@pytest.mark.parametrize("gc", [False, True], ids=["blob", "blob-gc"])
@pytest.mark.parametrize("seed", range(2))
def test_random_blob_sequence(tmp_path, pinned_clock, gc, seed,  # noqa: F811
                              executor):
    kw = dict(GC if gc else BLOB, min_blob_size=64,
              blob_garbage_collection_age_cutoff=0.5,
              merge_operator="StringAppendOperator")
    t = Twin(str(tmp_path), executor, True, **kw)
    try:
        rng = random.Random(seed)
        snaps = []
        for step in range(10):
            for _ in range(rng.randrange(30, 150)):
                k = b"k%04d" % rng.randrange(400)
                r = rng.random()
                if r < 0.7:
                    t.put(k, b"%d-" % step * rng.choice([1, 5, 40]))
                elif r < 0.8:
                    t.merge(k, b"m%d" % step)
                elif r < 0.95:
                    t.delete(k)
                else:
                    a = rng.randrange(400)
                    t.delete_range(b"k%04d" % a, b"k%04d" % (a + 4))
            if rng.random() < 0.2:
                snaps.append(t.snapshot())
            t.flush()
            if rng.random() < 0.3:
                t.compact_range()
        t.check()
        for s in snaps:
            t.check(snap=s)
        t.reopen()
    finally:
        t.close()


def test_remote_job_of_a_blob_db_resolves_blobs_in_the_worker(tmp_path):
    """A blob DB's compaction through the port's in-process dcompact
    service: the worker resolves a merge over a blob base through its own
    BlobSource over the DB's directory (compaction/worker.py), and the
    views equal the same DB's with the job in process."""
    from toplingdb_tpu_torch.compaction.dcompact_service import (
        DcompactWorkerService,
        HttpCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.utils import merge_operator as mo

    svc = DcompactWorkerService(device="cpu-jax")
    port = svc.start()
    views = []
    try:
        for name, factory in (
                ("remote", HttpCompactionExecutorFactory(
                    [f"http://127.0.0.1:{port}"], device="cpu-jax")),
                ("local", DeviceCompactionExecutorFactory(device="cpu"))):
            opts = Options(enable_blob_files=True, min_blob_size=50,
                           merge_operator=mo.StringAppendOperator(),
                           disable_auto_compactions=True,
                           compaction_executor_factory=factory)
            with dbm.DB.open(str(tmp_path / name), opts) as db:
                for i in range(300):
                    db.put(b"k%04d" % i, b"B%d" % i * 40)
                db.flush()
                for i in range(0, 300, 3):
                    db.merge(b"k%04d" % i, b"m%d" % i)
                db.flush()
                db.compact_range()
                assert db._bg_error is None
                assert db.get(b"k0003") == b"B3" * 40 + b",m3"
                it = db.new_iterator()
                it.seek_to_first()
                views.append(list(it.entries()))
        assert svc.jobs_done >= 1 and svc.jobs_failed == 0
    finally:
        svc.stop()
    assert views[0] == views[1] and len(views[0]) == 300
