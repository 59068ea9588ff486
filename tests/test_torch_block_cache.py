"""The block cache of toplingdb_tpu_torch against toplingdb_tpu's, on the
CPU (utils/cache.py, utils/persistent_cache.py,
tools/block_cache_analyzer.py, and the cache in the table readers and the
DB):

- every cache class driven alone by the same seeded sequence of inserts,
  lookups and erases in both packages: LRUCache with 1 and 16 shards (one
  process hashes a key to the same shard in both), with a
  CompressedSecondaryCache or a PersistentCache tier, ClockCache with and
  without a tier, SimCache and the BlockCacheTracer. Every lookup's value,
  the hit / miss / usage counts, the tiers' counts, the persistent
  tier's files and the trace records (without `ts_us`) must be equal;
- the cache cases of tests/test_utilities.py (:485, :840-997, :1248,
  :1276, :1415) and tests/test_db.py:646, each run in both packages with
  the observations compared;
- a persistent-cache directory written by either package recovers in the
  other with the same index and the same bytes;
- both DBs over the same writes, each with its own block cache of every
  class: gets and multi_gets equal, and with one shard the cache's hit /
  miss / usage counts equal (the DB prefixes every key with a random
  per-open session, so with 16 shards only the answers compare), the
  analyzer's hit count equal to the cache's own.

The reference's DB runs its host compaction path; the port's its device
executor on "cpu"; `time.time()` is pinned in both (tables carry
creation_time, so blocks sit at the same offsets). Tolerance: none.
"""

import os
import random
import shutil
import threading
import time

import pytest

import toplingdb_tpu.tools.block_cache_analyzer as ref_bca
import toplingdb_tpu.utils.cache as ref_cache
import toplingdb_tpu.utils.persistent_cache as ref_pc
from toplingdb_tpu.db.db import DB as RefDB
from toplingdb_tpu.db.dbformat import InternalKeyComparator as RefICmp
from toplingdb_tpu.db.table_cache import TableCache as RefTableCache
from toplingdb_tpu.env import default_env as ref_env
from toplingdb_tpu.options import Options as RefOptions

import toplingdb_tpu_torch.tools.block_cache_analyzer as bca
import toplingdb_tpu_torch.utils.cache as cache
import toplingdb_tpu_torch.utils.persistent_cache as pc
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory,
)
from toplingdb_tpu_torch.db.db import DB
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator
from toplingdb_tpu_torch.db.table_cache import TableCache
from toplingdb_tpu_torch.env import default_env
from toplingdb_tpu_torch.options import Options
from toplingdb_tpu_torch.utils import codecs

from test_torch_db import pinned_clock  # noqa: F401


@pytest.fixture
def no_thread_leaks():
    """Neither package's cache or DB leaves a thread behind: the port's
    threads are named tpt-*, the reference's are in its registry."""
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


class Pkg:
    """One package's cache classes and DB, under the same names."""

    def __init__(self, ref: bool):
        self.ref = ref
        m = ref_cache if ref else cache
        self.LRUCache = m.LRUCache
        self.ClockCache = m.ClockCache
        self.CompressedSecondaryCache = m.CompressedSecondaryCache
        self.SimCache = m.SimCache
        self.BlockCacheTracer = m.BlockCacheTracer
        self.analyze_block_cache_trace = m.analyze_block_cache_trace
        self.PersistentCache = (ref_pc if ref else pc).PersistentCache
        self.analyze = (ref_bca if ref else bca).analyze
        self.DB = RefDB if ref else DB
        self.TableCache = RefTableCache if ref else TableCache
        self.ICmp = RefICmp if ref else InternalKeyComparator
        self.env = ref_env if ref else default_env

    def options(self, **kw):
        if self.ref:
            return RefOptions(**kw)
        return Options(compaction_executor_factory=(
            DeviceCompactionExecutorFactory(device="cpu")), **kw)


REF, PORT = Pkg(True), Pkg(False)
BOTH = [REF, PORT]


def _trace_records(path, strip_session=False):
    """The trace's records without `ts_us`; `strip_session` drops the
    DB's 8-byte per-open session prefix from every key (16 hex digits)."""
    import json

    out = []
    for line in open(path):
        rec = json.loads(line)
        rec.pop("ts_us")
        if strip_session:
            rec["key"] = rec["key"][16:]
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# Each cache class driven alone by the same sequence
# ---------------------------------------------------------------------------


def _make_cache(p: Pkg, kind: str, root: str):
    """(cache, tier or None, tracer path or None) of case `kind`."""
    tier = None
    trace = None
    if kind == "lru16":
        c = p.LRUCache(24 * 1024)
    elif kind == "lru1":
        c = p.LRUCache(24 * 1024, num_shards=1)
    elif kind == "lru1-compressed":
        tier = p.CompressedSecondaryCache(16 * 1024)
        c = p.LRUCache(8 * 1024, num_shards=1, secondary=tier)
    elif kind == "lru16-compressed":
        tier = p.CompressedSecondaryCache(16 * 1024)
        c = p.LRUCache(8 * 1024, secondary=tier)
    elif kind == "lru1-persistent":
        tier = p.PersistentCache(os.path.join(root, "pc"),
                                 capacity_bytes=48 * 1024,
                                 file_size=8 * 1024, write_behind=False)
        c = p.LRUCache(8 * 1024, num_shards=1, secondary=tier)
    elif kind == "clock":
        c = p.ClockCache(16 * 1024)
    elif kind == "clock-compressed":
        tier = p.CompressedSecondaryCache(16 * 1024)
        c = p.ClockCache(8 * 1024, secondary=tier)
    elif kind == "sim":
        c = p.SimCache(p.LRUCache(8 * 1024, num_shards=1), 64 * 1024)
    elif kind == "lru1-tracer":
        trace = os.path.join(root, "bc.trace")
        c = p.LRUCache(8 * 1024, num_shards=1,
                       tracer=p.BlockCacheTracer(trace))
    else:
        raise AssertionError(kind)
    return c, tier, trace


CACHE_KINDS = ["lru16", "lru1", "lru1-compressed", "lru16-compressed",
               "lru1-persistent", "clock", "clock-compressed", "sim",
               "lru1-tracer"]


def _drive(p: Pkg, kind: str, root: str, seed: int = 5) -> dict:
    os.makedirs(root, exist_ok=True)
    c, tier, trace = _make_cache(p, kind, root)
    rng = random.Random(seed)
    looked = []
    for _ in range(1500):
        k = b"blk%04d" % int(rng.paretovariate(1.2) * 7 % 300)
        r = rng.random()
        if r < 0.45:
            v = bytes([len(k) % 7]) * 40 + k * rng.randrange(1, 40)
            c.insert(k, v, len(v))
        elif r < 0.95:
            looked.append(c.lookup(k))
        else:
            c.erase(k)
    obs = {"lookups": looked, "usage": c.usage(),
           "hit_rate": c.hit_rate()}
    real = c.real if kind == "sim" else c
    if hasattr(real, "_shards"):
        obs["shards"] = [(s.hits, s.misses, s.usage) for s in real._shards]
    else:
        obs["clock"] = (real.hits, real.misses, real.usage())
    if kind == "sim":
        obs["sim"] = (c.sim_hits, c.sim_misses, c.sim_hit_rate())
    if tier is not None:
        obs["tier"] = (tier.hits, tier.misses, tier.usage())
    if kind == "lru1-persistent":
        obs["tier_stats"] = tier.stats()
        tier.close()
        d = os.path.join(root, "pc")
        obs["files"] = {n: open(os.path.join(d, n), "rb").read()
                        for n in sorted(os.listdir(d))}
    if trace is not None:
        c.tracer.close()
        obs["trace"] = _trace_records(trace)
    return obs


@pytest.mark.parametrize("kind", CACHE_KINDS)
def test_cache_class_parity(tmp_path, no_thread_leaks, kind):
    ref = _drive(REF, kind, str(tmp_path / "ref"))
    port = _drive(PORT, kind, str(tmp_path / "port"))
    assert port == ref
    hits = sum(v is not None for v in port["lookups"])
    assert 0 < hits < len(port["lookups"])  # the sequence hits and misses
    if "tier" in port:
        assert port["tier"][0] > 0  # the tier served promotions


# ---------------------------------------------------------------------------
# The cache cases of tests/test_utilities.py and tests/test_db.py
# ---------------------------------------------------------------------------


def _fill_flush(p, path, n, val, **kw):
    """n keys in one memtable, flushed once by hand (byte-equal tables in
    both packages: no flush on memory use)."""
    db = p.DB.open(path, p.options(write_buffer_size=8 << 20,
                                   disable_auto_compactions=True, **kw))
    for i in range(n):
        db.put(b"key%05d" % i, val(i))
    db.flush()
    return db


def scen_lru_table_cache(p, root):                     # test_utilities:485
    cache_ = p.LRUCache(1 << 20)
    src = os.path.join(root, "db")
    db = _fill_flush(p, src, 500, lambda i: b"v" * 100)
    files = [f.number for _, f in db.versions.current.all_files()]
    db.close()
    tc = p.TableCache(p.env(), src, p.ICmp(), block_cache=cache_)
    r = tc.get_reader(files[0])
    rows = []
    for _ in range(2):
        it = r.new_iterator()
        it.seek_to_first()
        rows.append(list(it.entries()))
    assert rows[0] == rows[1] and len(rows[0]) == 500
    assert cache_.usage() > 0 and cache_.hit_rate() > 0.3
    tc.close()
    return dict(rows=rows[0], usage=cache_.usage(),
                hit_rate=cache_.hit_rate())


def scen_persistent_spill_restart(p, root):            # :840
    pdir = os.path.join(root, "pcache")
    sec = p.PersistentCache(pdir, capacity_bytes=1 << 20, file_size=8 * 1024)
    lru = p.LRUCache(4 * 1024, num_shards=1, secondary=sec)
    blocks = {b"blk%03d" % i: bytes([i % 256]) * 512 for i in range(32)}
    for k, v in blocks.items():
        lru.insert(k, v, len(v))
    assert lru.lookup(b"blk000") == blocks[b"blk000"]
    assert sec.hits >= 1
    h = sec.hits
    assert lru.lookup(b"blk000") == blocks[b"blk000"]  # promoted
    assert sec.hits == h
    sec.close()
    sec2 = p.PersistentCache(pdir, capacity_bytes=1 << 20,
                             file_size=8 * 1024)
    got = sec2.lookup(b"blk005")
    assert got == blocks[b"blk005"]
    index = dict(sec2._index)
    sec2.close()
    return dict(hits=h, got=got, index=index, usage=lru.usage())


def scen_persistent_capacity_eviction(p, root):        # :866
    pdir = os.path.join(root, "pc2")
    c = p.PersistentCache(pdir, capacity_bytes=32 * 1024, file_size=8 * 1024,
                          compress=False, write_behind=False)
    for i in range(200):
        c.insert(b"k%04d" % i, b"x" * 500)
    assert c.usage() <= 40 * 1024
    assert c.lookup(b"k0199") is not None
    assert c.lookup(b"k0000") is None
    files = sorted(os.listdir(pdir))
    assert len(files) <= 6
    c.close()
    return dict(files={n: open(os.path.join(pdir, n), "rb").read()
                       for n in files}, stats=c.stats())


def scen_persistent_corrupt_tail(p, root):             # :884
    pdir = os.path.join(root, "pc3")
    c = p.PersistentCache(pdir, capacity_bytes=1 << 20, compress=False,
                          write_behind=False)
    c.insert(b"good", b"G" * 100)
    c.insert(b"torn", b"T" * 100)
    c.close()
    path = os.path.join(pdir, sorted(os.listdir(pdir))[0])
    data = open(path, "rb").read()
    open(path, "wb").write(data[:-30])  # tear the last record
    c2 = p.PersistentCache(pdir, capacity_bytes=1 << 20)
    out = dict(good=c2.lookup(b"good"), torn=c2.lookup(b"torn"))
    assert out == dict(good=b"G" * 100, torn=None)
    c2.close()
    return out


def scen_persistent_insert_after_close(p, root):       # :903
    out = {}
    for wb in (False, True):
        pdir = os.path.join(root, f"pc_closed_{wb}")
        c = p.PersistentCache(pdir, capacity_bytes=1 << 20, compress=False,
                              write_behind=wb)
        c.insert(b"live", b"L" * 64)
        c.flush()
        c.close()
        files_after_close = sorted(os.listdir(pdir))
        c.insert(b"straggler", b"S" * 64)
        c._write_record(b"direct", b"D" * 64)
        c.flush()
        assert sorted(os.listdir(pdir)) == files_after_close
        assert c.lookup(b"straggler") is None
        c2 = p.PersistentCache(pdir, capacity_bytes=1 << 20)
        out[wb] = (c2.lookup(b"live"), c2.lookup(b"direct"))
        assert out[wb] == (b"L" * 64, None)
        c2.close()
    return out


def scen_persistent_write_behind(p, root):             # :931
    pdir = os.path.join(root, "pc4")
    c = p.PersistentCache(pdir, capacity_bytes=1 << 20, compress=True,
                          write_behind=True)
    val = b"compress-me " * 100
    for i in range(50):
        c.insert(b"wb%03d" % i, val)
    assert c.lookup(b"wb000") == val  # visible before the writeback lands
    c.flush()
    st = c.stats()
    assert st["pending_bytes"] == 0 and st["inserts"] == 50
    if st["compressed"]:
        assert st["bytes_written"] < 50 * len(val) // 2
    assert c.lookup(b"wb042") == val
    c.close()
    c2 = p.PersistentCache(pdir, capacity_bytes=1 << 20)
    got = c2.lookup(b"wb042")
    assert got == val
    n_index = len(c2._index)
    c2.close()
    st = dict(st, hits=None)  # a pending hit races the writer thread
    return dict(stats=st, n_index=n_index)


def scen_persistent_access_lru(p, root):               # :958
    c = p.PersistentCache(os.path.join(root, "pc5"),
                          capacity_bytes=24 * 1024, file_size=8 * 1024,
                          compress=False, write_behind=False)
    for i in range(14):
        c.insert(b"hot%03d" % i, b"h" * 500)
    assert c.lookup(b"hot000") is not None
    for i in range(80):
        c.insert(b"cold%03d" % i, b"c" * 500)
        c.lookup(b"hot000")  # keep file 0 recent
    assert c.lookup(b"hot000") is not None, "hot file evicted despite use"
    idx = dict(c._index)
    c.close()
    return dict(index=idx, stats=c.stats())


def scen_persistent_stats(p, root):                    # :979
    c = p.PersistentCache(os.path.join(root, "pc6"), capacity_bytes=1 << 20,
                          write_behind=False)
    c.insert(b"a", b"x" * 200)
    assert c.lookup(b"a") is not None
    assert c.lookup(b"zz") is None
    st = c.stats()
    assert st["hits"] == 1 and st["misses"] == 1
    assert 0 < st["hit_rate"] < 1
    assert st["bytes_written"] > 0 and st["files"] >= 1
    c.close()
    return st


def scen_db_persistent_tier(p, root):                  # :997
    sec = p.PersistentCache(os.path.join(root, "pc"), capacity_bytes=1 << 20,
                            write_behind=False)
    bc = p.LRUCache(8 * 1024, num_shards=1, secondary=sec)
    db = _fill_flush(p, os.path.join(root, "db"), 2000,
                     lambda i: b"v%05d" % i, block_cache=bc)
    got = [db.get(b"key%05d" % i) for i in range(0, 2000, 17)]
    assert got == [b"v%05d" % i for i in range(0, 2000, 17)]
    db.close()
    sec.close()
    return dict(got=got, lru=(bc.hit_rate(), bc.usage()),
                tier=(sec.hits, sec.misses, sec.inserts, sec.usage()))


def scen_clock_cache(p, root):                         # :1248
    c = p.ClockCache(1000)
    for i in range(10):
        c.insert(b"k%02d" % i, b"x" * 90, 100)
    assert c.usage() <= 1000
    for i in (0, 1):
        c.lookup(b"k%02d" % i)
    for i in range(10, 16):
        c.insert(b"k%02d" % i, b"y" * 90, 100)
    assert c.usage() <= 1000
    c.erase(b"k15")
    assert c.lookup(b"k15") is None
    alive = [c.lookup(b"k%02d" % i) is not None for i in range(16)]
    bc = p.ClockCache(64 * 1024)
    db = _fill_flush(p, os.path.join(root, "db"), 2000,
                     lambda i: b"v%05d" % i, block_cache=bc)
    got = [db.get(b"key%05d" % i) for i in range(0, 2000, 7)]
    assert got == [b"v%05d" % i for i in range(0, 2000, 7)]
    assert bc.hits > 0
    db.close()
    return dict(alive=alive, usage=c.usage(), got=got,
                db_cache=(bc.hits, bc.misses, bc.usage()))


def scen_compressed_secondary(p, root):                # :1276
    sec = p.CompressedSecondaryCache(1 << 20)
    lru = p.LRUCache(2 * 1024, num_shards=1, secondary=sec)
    blocks = {b"b%02d" % i: (b"content-%02d" % i) * 40 for i in range(20)}
    for k, v in blocks.items():
        lru.insert(k, v, len(v))
    assert lru.lookup(b"b00") == blocks[b"b00"]
    assert sec.hits >= 1
    assert sec.usage() < sum(len(v) for v in blocks.values())
    sec.erase(b"b01")
    lru2 = p.LRUCache(1024, num_shards=1, secondary=sec)
    assert lru2.lookup(b"b01") is None
    return dict(sec=(sec.hits, sec.misses, sec.usage()), usage=lru.usage())


def scen_sim_cache(p, root):                           # :1415
    sim = p.SimCache(p.LRUCache(4 * 1024, num_shards=1), 1 << 20)
    for i in range(64):
        sim.insert(b"k%02d" % i, b"x" * 256, 256)
    for i in range(64):
        sim.lookup(b"k%02d" % i)
    assert sim.sim_hit_rate() > 0.9 and sim.hit_rate() < 0.5
    bc = p.SimCache(p.LRUCache(4 * 1024, num_shards=1), 1 << 22)
    db = _fill_flush(p, os.path.join(root, "db"), 2000, lambda i: b"v" * 30,
                     block_cache=bc)
    for _ in range(2):
        for i in range(0, 2000, 10):
            assert db.get(b"key%05d" % i) == b"v" * 30
    assert bc.sim_hit_rate() > bc.hit_rate()
    db.close()
    return dict(sim=(sim.sim_hit_rate(), sim.hit_rate()),
                db_sim=(bc.sim_hits, bc.sim_misses, bc.hit_rate(),
                        bc.usage()))


def scen_block_cache_tracer(p, root):                  # test_db.py:646
    trace = os.path.join(root, "bc.trace")
    tracer = p.BlockCacheTracer(trace)
    bc = p.LRUCache(1 << 20, num_shards=1, tracer=tracer)
    db = _fill_flush(p, os.path.join(root, "db"), 1000, lambda i: b"v" * 30,
                     block_cache=bc)
    for _ in range(3):
        assert db.get(b"key00500") == b"v" * 30
    db.close()
    tracer.close()
    agg = p.analyze_block_cache_trace(trace)
    assert agg["hits"] > 0, "repeat reads must hit the cache"
    report = p.analyze(trace, top_n=None)
    assert report["hits"] == agg["hits"] == bc._shards[0].hits
    # Keys carry the per-open session: compare without it.
    agg["accesses_per_file_prefix"] = sorted(
        agg["accesses_per_file_prefix"].values())
    for k in ("hottest_blocks", "miss_ratio_timeline"):
        report.pop(k)
    return dict(agg=agg, report=report,
                records=_trace_records(trace, strip_session=True))


SCENARIOS = [scen_lru_table_cache, scen_persistent_spill_restart,
             scen_persistent_capacity_eviction, scen_persistent_corrupt_tail,
             scen_persistent_insert_after_close, scen_persistent_write_behind,
             scen_persistent_access_lru, scen_persistent_stats,
             scen_db_persistent_tier, scen_clock_cache,
             scen_compressed_secondary, scen_sim_cache,
             scen_block_cache_tracer]


@pytest.mark.parametrize("scen", SCENARIOS,
                         ids=[s.__name__[5:] for s in SCENARIOS])
def test_reference_cache_scenarios(tmp_path, no_thread_leaks, pinned_clock,
                                   scen):
    for d in ("ref", "port"):
        os.makedirs(str(tmp_path / d))
    ref = scen(REF, str(tmp_path / "ref"))
    port = scen(PORT, str(tmp_path / "port"))
    assert port == ref


# ---------------------------------------------------------------------------
# Persistent-cache files recovered across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("compress", [True, False])
def test_persistent_cache_recovers_across_packages(tmp_path, no_thread_leaks,
                                                   writer, compress):
    """A directory written by one package (write-behind, several files,
    some evicted) recovers in the other with the same index, the same
    bytes for every key, and the same counters on the same lookups; a
    record appended by the reader's package is read back by the writer's."""
    w, r = (REF, PORT) if writer == "ref" else (PORT, REF)
    d = str(tmp_path / "pc")
    rng = random.Random(9)
    vals = {b"blk%04d" % i: bytes(rng.randrange(4) for _ in range(
        rng.randrange(10, 3000))) for i in range(120)}
    c = w.PersistentCache(d, capacity_bytes=96 * 1024, file_size=16 * 1024,
                          compress=compress)
    for k, v in vals.items():
        c.insert(k, v)
    c.flush()
    c.close()
    before = {n: open(os.path.join(d, n), "rb").read()
              for n in sorted(os.listdir(d))}
    shutil.copytree(d, str(tmp_path / "pc-twin"))
    mine = w.PersistentCache(str(tmp_path / "pc-twin"),
                             capacity_bytes=96 * 1024, file_size=16 * 1024)
    other = r.PersistentCache(d, capacity_bytes=96 * 1024,
                              file_size=16 * 1024)
    assert other._index == mine._index
    assert other._files == mine._files and other._sizes == mine._sizes
    assert 0 < len(other._index) < len(vals)  # whole files were evicted
    for k, v in vals.items():
        got = other.lookup(k)
        assert got == mine.lookup(k)
        assert got is None or got == v
    assert other.stats() == mine.stats()
    other.insert(b"appended", b"A" * 500)
    other.close()
    mine.close()
    after = {n: open(os.path.join(d, n), "rb").read()
             for n in sorted(os.listdir(d))}
    for n, b in before.items():
        assert after[n][:len(b)] == b  # appended to, never rewritten
    back = w.PersistentCache(d, capacity_bytes=96 * 1024,
                             file_size=16 * 1024)
    assert back.lookup(b"appended") == b"A" * 500
    back.close()


def test_persistent_cache_same_inserts_same_files(tmp_path, no_thread_leaks):
    """The same inserts, synchronous, write byte-identical cache files."""
    compress = codecs.available("snappy")
    out = []
    for p in BOTH:
        d = str(tmp_path / ("ref" if p.ref else "port"))
        c = p.PersistentCache(d, capacity_bytes=40 * 1024,
                              file_size=8 * 1024, compress=compress,
                              write_behind=False)
        for i in range(90):
            c.insert(b"k%03d" % i, (b"payload-%03d " % i) * (i % 17 + 3))
            if i % 5 == 0:
                c.lookup(b"k%03d" % (i // 2))
            if i % 11 == 0:
                c.erase(b"k%03d" % (i // 3))
        c.close()
        out.append(({n: open(os.path.join(d, n), "rb").read()
                     for n in sorted(os.listdir(d))}, c.stats()))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# Both DBs with a block cache of every class
# ---------------------------------------------------------------------------


def _db_cache(p: Pkg, kind: str, root: str):
    if kind == "lru1-persistent":
        tier = p.PersistentCache(os.path.join(root, "pc"),
                                 capacity_bytes=1 << 20, write_behind=False)
        return p.LRUCache(16 * 1024, num_shards=1, secondary=tier), tier
    if kind == "lru16":
        return p.LRUCache(64 * 1024), None
    if kind == "lru1":
        return p.LRUCache(16 * 1024, num_shards=1), None
    if kind == "lru1-compressed":
        tier = p.CompressedSecondaryCache(32 * 1024)
        return p.LRUCache(16 * 1024, num_shards=1, secondary=tier), tier
    if kind == "clock-compressed":
        tier = p.CompressedSecondaryCache(32 * 1024)
        return p.ClockCache(16 * 1024, secondary=tier), tier
    if kind == "sim-clock":
        return p.SimCache(p.ClockCache(16 * 1024), 256 * 1024), None
    raise AssertionError(kind)


DB_KINDS = ["lru16", "lru1", "lru1-compressed", "lru1-persistent",
            "clock-compressed", "sim-clock"]


def _db_reads(p: Pkg, kind: str, root: str) -> dict:
    """The same DB in both packages: three flushed layers (the last one
    partitioned-filter, two-level-index tables) under 2 compact_ranges
    (auto compactions off), then gets and multi_gets through the cache."""
    import dataclasses

    os.makedirs(root, exist_ok=True)
    bc, tier = _db_cache(p, kind, root)
    trace = os.path.join(root, "bc.trace")
    tracer = p.BlockCacheTracer(trace)
    real = bc.real if kind.startswith("sim") else bc
    real.tracer = tracer
    o = p.options(write_buffer_size=8 << 20, disable_auto_compactions=True,
                  block_cache=bc)
    o.table_options = dataclasses.replace(
        o.table_options, block_size=512, partition_filters=True,
        metadata_block_size=512, index_type="two_level")
    path = os.path.join(root, "db")
    db = p.DB.open(path, o)
    rng = random.Random(4)
    model = {}
    for layer in range(3):
        for _ in range(1500):
            k = b"key%05d" % rng.randrange(3000)
            if rng.random() < 0.1:
                db.delete(k)
                model[k] = None
            else:
                model[k] = b"v%d-" % layer + k * rng.randrange(1, 4)
                db.put(k, model[k])
        db.flush()
        if layer == 1:
            db.compact_range()
    keys = [b"key%05d" % rng.randrange(3200) for _ in range(600)]
    gets = [db.get(k) for k in keys]
    mget = db.multi_get(keys)
    assert gets == mget == [model.get(k) for k in keys]
    db.close()
    tracer.close()
    obs = dict(gets=gets, usage=bc.usage())
    if hasattr(real, "_shards"):
        obs["hits"] = sum(s.hits for s in real._shards)
        obs["misses"] = sum(s.misses for s in real._shards)
    else:
        obs["hits"], obs["misses"] = real.hits, real.misses
    report = p.analyze(trace, top_n=None)
    # The analyzer's count equals the cache's own: every lookup is traced,
    # a hit of the tier (promoted or served) as a hit.
    assert report["hits"] == obs["hits"] + (
        tier.hits if tier is not None else 0)
    obs["trace_hits"] = report["hits"]
    if tier is not None:
        obs["tier"] = (tier.hits, tier.misses)
        if kind == "lru1-persistent":
            tier.close()
    if kind.startswith("sim"):
        obs["sim"] = (bc.sim_hits, bc.sim_misses)
    return obs


@pytest.mark.parametrize("kind", DB_KINDS)
def test_db_block_cache_parity(tmp_path, no_thread_leaks, pinned_clock,
                               kind):
    ref = _db_reads(REF, kind, str(tmp_path / "ref"))
    port = _db_reads(PORT, kind, str(tmp_path / "port"))
    assert port["hits"] > 0 and port["misses"] > 0
    if kind == "lru16":
        # 16 shards: the session prefix spreads the two DBs' blocks over
        # different shards, so only the answers compare.
        assert port["gets"] == ref["gets"]
        return
    assert port == ref
