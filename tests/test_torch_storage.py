"""The shared SST store of toplingdb_tpu_torch (storage/: the object store,
the HTTP store, SharedSstEnv with its cache tier, mark-sweep GC; the DB's
shared_store option, the reference-mode checkpoint, store-mode dcompact
and StoreFaultInjector) against toplingdb_tpu's, on the CPU.

- the cases of tests/test_shared_store.py at :102, :117, :134, :156, :175,
  :202, :236, :262, :291, :323, :390, :418, :456, :487, :558, :602, :638,
  :654 and :679 run on each package (the port's DB with
  DeviceCompactionExecutorFactory(device="cpu"), the reference's with its
  device factory on "cpu-jax", both driven by Options.shared_store with
  TPULSM_SHARED_STORE removed from the environment), with what the
  reference's test asserts; each case's observations (reads, addresses,
  store listings, tickers, refs tables, reports) are equal across the
  packages. The lease of :456 is a small stand-in with the interface of
  toplingdb_tpu's LeaseCoordinator (sharding/ is not in the port);
  :343 (the shard migration bootstrap) waits for sharding/;
- the store on and off, in both packages, give the same reads over the
  parity matrix's workload, and the two packages' stores list the same
  addresses: the same tables, byte for byte (time.time() pinned where
  tables stamp it);
- a checkpoint taken while the store fails degrades to the byte copy in
  both packages, counted by utils/errors.swallow;
- the port alone: its DB reads no TPULSM_SHARED_STORE; the reclaim
  ladder's red steps prune the cache tier and sweep the store; the last
  close releases the tier's threads.

Tolerance: none (bytes, addresses and reads equal).
"""

import glob
import json
import os
import threading
import time
import urllib.request

import pytest

import toplingdb_tpu.compaction.compaction_job as ref_cj
import toplingdb_tpu.compaction.executor as ref_ex
import toplingdb_tpu.db.db as ref_dbm
import toplingdb_tpu.ops.device_compaction as ref_dc
import toplingdb_tpu.ops.pipeline as ref_pl
import toplingdb_tpu.storage as ref_storage
import toplingdb_tpu.storage.shared_env as ref_se
from toplingdb_tpu.compaction.resilience import (
    DcompactOptions as RefDcompactOptions,
)
from toplingdb_tpu.env import MemEnv as RefMemEnv
from toplingdb_tpu.env import default_env as ref_default_env
from toplingdb_tpu.env.fault_injection import (
    StoreFaultInjector as RefStoreFaultInjector,
)
from toplingdb_tpu.options import Options as RefOptions
from toplingdb_tpu.options import ReadOptions as RefReadOptions
from toplingdb_tpu.table import format as ref_tfmt
from toplingdb_tpu.utilities.checkpoint import Checkpoint as RefCheckpoint
from toplingdb_tpu.utils import errors as ref_errors
from toplingdb_tpu.utils import slo as ref_slo
from toplingdb_tpu.utils import statistics as ref_st
from toplingdb_tpu.utils import status as ref_status
from toplingdb_tpu.utils.config import SidePluginRepo as RefSidePluginRepo
from toplingdb_tpu.utils.file_checksum import (
    FileChecksumGenFactory as RefFileChecksumGenFactory,
)

import toplingdb_tpu_torch.compaction.compaction_job as cj
import toplingdb_tpu_torch.compaction.executor as ex
import toplingdb_tpu_torch.db.db as dbm
import toplingdb_tpu_torch.ops.device_compaction as dc
import toplingdb_tpu_torch.ops.pipeline as pl
import toplingdb_tpu_torch.storage as storage
import toplingdb_tpu_torch.storage.shared_env as pse
from toplingdb_tpu_torch.compaction.resilience import DcompactOptions
from toplingdb_tpu_torch.env import MemEnv, default_env
from toplingdb_tpu_torch.env.fault_injection import StoreFaultInjector
from toplingdb_tpu_torch.options import Options, ReadOptions
from toplingdb_tpu_torch.table import format as tfmt
from toplingdb_tpu_torch.utilities.checkpoint import Checkpoint
from toplingdb_tpu_torch.utils import errors
from toplingdb_tpu_torch.utils import slo
from toplingdb_tpu_torch.utils import statistics as st
from toplingdb_tpu_torch.utils import status
from toplingdb_tpu_torch.utils.config import SidePluginRepo
from toplingdb_tpu_torch.utils.file_checksum import FileChecksumGenFactory

from test_torch_block_cache import no_thread_leaks  # noqa: F401

CLOCK = 1_700_000_000.0


class _PinnedTime:
    """`time` as a module sees it, with time.time() fixed."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def time():
        return CLOCK


@pytest.fixture(autouse=True)
def store_knob_off(monkeypatch):
    """Options.shared_store drives both packages: the reference's env var
    (which would win over its Options) is removed."""
    monkeypatch.delenv("TPULSM_SHARED_STORE", raising=False)


@pytest.fixture
def pinned_clock(monkeypatch):
    """Tables stamp time.time() as their creation_time: fixed in both
    packages, so the same writes give the same bytes and addresses."""
    for m in (ref_dbm, ref_cj, ref_dc, ref_pl, ref_ex, dbm, cj, dc, pl, ex):
        monkeypatch.setattr(m, "time", _PinnedTime())


class Pkg:
    """One package's storage surface under the same names."""

    def __init__(self, ref: bool):
        self.ref = ref
        self.DB = ref_dbm.DB if ref else dbm.DB
        self.storage = ref_storage if ref else storage
        self.shared_env = ref_se if ref else pse
        self.default_env = ref_default_env if ref else default_env
        self.MemEnv = RefMemEnv if ref else MemEnv
        self.Checkpoint = RefCheckpoint if ref else Checkpoint
        self.StoreFaultInjector = (RefStoreFaultInjector if ref
                                   else StoreFaultInjector)
        self.FileChecksumGenFactory = (RefFileChecksumGenFactory if ref
                                       else FileChecksumGenFactory)
        self.st = ref_st if ref else st
        self.status = ref_status if ref else status
        self.slo = ref_slo if ref else slo
        self.errors = ref_errors if ref else errors
        self.tfmt = ref_tfmt if ref else tfmt
        self.ex = ref_ex if ref else ex
        self.DcompactOptions = RefDcompactOptions if ref else DcompactOptions
        self.SidePluginRepo = RefSidePluginRepo if ref else SidePluginRepo
        self.ReadOptions = RefReadOptions if ref else ReadOptions

    def options(self, **kw):
        kw.setdefault("create_if_missing", True)
        kw.setdefault("write_buffer_size", 1 << 20)
        if "compaction_executor_factory" not in kw:
            kw["compaction_executor_factory"] = (
                ref_ex.DeviceCompactionExecutorFactory(device="cpu-jax")
                if self.ref else
                ex.DeviceCompactionExecutorFactory(device="cpu"))
        return (RefOptions if self.ref else Options)(**kw)

    def addr_for(self, payload: bytes, func: str = "crc32c") -> str:
        gen = self.FileChecksumGenFactory(func).create()
        gen.update(payload)
        return self.storage.object_address(func, gen.finalize(),
                                           len(payload))

    def untapped(self, env):
        """The DB's env below the port's checksum tap (the reference has
        none)."""
        return getattr(env, "base", env) if hasattr(env, "take_digest") \
            else env


def _workload(db, n=400):
    """tests/test_shared_store.py's workload: overwrites, deletes, a
    snapshot and a range tombstone over two flushes and a compact_range."""
    for i in range(n):
        db.put(b"k%05d" % i, b"v%d" % i * 17)
    db.flush()
    snap = db.get_snapshot()
    for i in range(0, n, 3):
        db.put(b"k%05d" % i, b"w%d" % i * 11)
    for i in range(0, n, 7):
        db.delete(b"k%05d" % i)
    db.delete_range(b"k%05d" % (n // 2), b"k%05d" % (n // 2 + 20))
    db.flush()
    db.compact_range()
    return snap


def _fingerprint(p, db, snap, n=400):
    rows = []
    it = db.new_iterator()
    it.seek_to_first()
    while it.valid():
        rows.append((it.key(), it.value()))
        it.next()
    gets = [db.get(b"k%05d" % i) for i in range(n)]
    snap_gets = []
    if snap is not None:
        ro = p.ReadOptions(snapshot=snap)
        snap_gets = [db.get(b"k%05d" % i, ro) for i in range(0, n, 13)]
    return rows, gets, snap_gets


def _sorted_refs(refs: dict) -> list:
    return sorted(refs.values())


# ---------------------------------------------------------------------------
# The cases of tests/test_shared_store.py (line numbers of that file)
# ---------------------------------------------------------------------------


def sc_address_scheme_stability_and_verification(p, d, obs, mp):  # :102
    payload = b"block" * 1000
    a1, a2 = p.addr_for(payload), p.addr_for(payload)
    assert a1 == a2
    func, digest, size = p.storage.parse_address(a1)
    assert func == "crc32c" and size == len(payload)
    assert p.storage.object_address(func, digest, size) == a1
    p.storage.verify_payload(a1, payload)
    for bad in (payload[:-1], b"X" + payload[1:]):
        with pytest.raises(p.status.Corruption):
            p.storage.verify_payload(a1, bad)
    assert p.addr_for(payload) != p.addr_for(payload + b"x")
    with pytest.raises(p.status.InvalidArgument):
        p.storage.parse_address("no-address")
    obs += [a1, p.addr_for(payload, "xxh64"),
            p.storage.address_size(a1)]


def sc_local_store_dedup_and_pins(p, d, obs, mp):                  # :117
    store = p.storage.LocalObjectStore(os.path.join(d, "store"))
    payload = b"sst" * 500
    addr = p.addr_for(payload)
    obs.append(store.put(addr, payload))
    obs.append(store.put(addr, payload))  # dedup
    assert store.fetch(addr) == payload
    with pytest.raises(p.status.Corruption):
        store.put(p.addr_for(b"other"), payload)
    with pytest.raises(p.status.NotFound):
        store.fetch(p.addr_for(b"missing"))
    store.pin(addr, "tester", ttl=60.0)
    obs.append(sorted(store.pinned()))
    store.unpin(addr)
    obs.append(sorted(store.pinned()))
    status_doc = store.status()
    obs.append({k: status_doc[k] for k in ("backend", "objects", "bytes",
                                            "pinned")})
    # The shard layout: <root>/objects/<digest[:2]>/<addr>.
    obs.append(sorted(os.path.relpath(q, d) for q in glob.glob(
        os.path.join(d, "store", "objects", "*", "*"))))


def sc_concurrent_publish_idempotent(p, d, obs, mp):               # :134
    store = p.storage.LocalObjectStore(os.path.join(d, "store"))
    payload = bytes(range(256)) * 256
    addr = p.addr_for(payload)
    results, errs = [], []

    def racer():
        try:
            results.append(store.put(addr, payload))
        except Exception as e:  # noqa: BLE001 - the test records it
            errs.append(e)

    threads = [threading.Thread(target=racer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errs and not any(t.is_alive() for t in threads)
    assert store.fetch(addr) == payload
    assert results.count(True) >= 1
    obs.append(store.list_addresses())  # one object, no tmp residue


def sc_open_store_spec_forms(p, d, obs, mp):                       # :156
    for spec in (None, "", "0"):
        assert not p.storage.store_spec_enabled(spec)
    assert p.storage.store_spec_enabled(os.path.join(d, "s"))
    s = p.storage.open_store(os.path.join(d, "s"))
    assert isinstance(s, p.storage.LocalObjectStore)
    assert p.storage.open_store(s) is s
    c = p.storage.open_store("http://127.0.0.1:9")
    assert isinstance(c, p.storage.StoreClient)
    with pytest.raises(ValueError):
        p.storage.open_store("0")
    obs += [type(s).__name__, type(c).__name__, c.url]


def sc_shared_env_reads_are_reference_then_local(p, d, obs, mp):   # :202
    store = p.storage.LocalObjectStore(os.path.join(d, "store"))
    payload = bytes(range(251)) * 130
    addr = p.addr_for(payload)
    store.put(addr, payload)
    stats = p.st.Statistics()
    env = p.storage.SharedSstEnv(p.default_env(), store,
                                 cache_dir=os.path.join(d, "cache"),
                                 stats=stats)
    try:
        dd = os.path.join(d, "d")
        os.makedirs(dd)
        f = f"{dd}/000007.sst"
        env.adopt(f, addr)
        obs += [env.file_exists(f), env.get_file_size(f),
                os.path.exists(f), env.get_children(dd)]
        assert env.read_file(f) == payload
        obs.append(os.path.exists(f))  # materialized
        t = stats.tickers()
        obs += [t.get(p.st.STORE_MISSES, 0),
                t.get(p.st.STORE_BYTES_FETCHED, 0)]
        env.read_file(f)
        obs.append(stats.tickers().get(p.st.STORE_MISSES, 0))  # local now
        # A rename carries the reference; a delete drops it.
        env.adopt(f"{dd}/000008.sst", addr)
        env.rename_file(f"{dd}/000008.sst", f"{dd}/000009.sst")
        obs.append(env.refs_of(dd))
        env.delete_file(f)
        env.delete_file(f"{dd}/000009.sst")
        obs += [env.file_exists(f), env.refs_of(dd),
                os.path.exists(os.path.join(dd, p.storage.REFS_NAME))]
    finally:
        env.close()


def sc_warm_refs_prefetches_into_cache(p, d, obs, mp):            # :236
    store = p.storage.LocalObjectStore(os.path.join(d, "store"))
    payloads = [bytes([i]) * (8 * 1024 + i) for i in range(4)]
    env = p.storage.SharedSstEnv(p.default_env(), store,
                                 cache_dir=os.path.join(d, "cache"))
    try:
        dd = os.path.join(d, "d")
        os.makedirs(dd)
        for i, q in enumerate(payloads):
            addr = p.addr_for(q)
            store.put(addr, q)
            env.adopt(f"{dd}/{i:06d}.sst", addr)
        obs.append(env.warm_refs(dd))
        env.tier.drain()
        for i, q in enumerate(payloads):
            assert os.path.exists(f"{dd}/{i:06d}.sst")
            assert env.read_file(f"{dd}/{i:06d}.sst") == q
        obs.append(sorted(os.listdir(dd)))
    finally:
        env.close()


def sc_reference_checkpoint_and_restore_equivalence(p, d, obs, mp):  # :262
    spec = os.path.join(d, "store")
    db = p.DB.open(os.path.join(d, "db"), p.options(shared_store=spec))
    try:
        snap = _workload(db)
        want = _fingerprint(p, db, snap)
        ck = os.path.join(d, "ckpt")
        p.Checkpoint.create(db, ck)
        # SSTs held by reference: no SST bytes, a refs table instead.
        assert not glob.glob(os.path.join(ck, "*.sst"))
        refs = db.env.refs_of(ck)
        assert refs
        for addr in refs.values():
            p.storage.parse_address(addr)
        dest = os.path.join(d, "restored")
        env = p.untapped(db.env)
        p.Checkpoint(ck, env).restore_to(dest)
        db2 = p.DB.open(dest, p.options(create_if_missing=False), env=env)
        try:
            got = _fingerprint(p, db2, None)
            assert got[0] == want[0] and got[1] == want[1]
            obs += [want, sorted(refs.items()), env.refs_of(dest) == refs]
        finally:
            db2.close()
    finally:
        db.close()


def sc_restore_hardlink_fast_path_parity(p, d, obs, mp):           # :291
    db = p.DB.open(os.path.join(d, "db"), p.options())
    _workload(db, n=200)
    ck = os.path.join(d, "ckpt")
    p.Checkpoint.create(db, ck)
    db.close()
    linked = os.path.join(d, "linked")
    p.Checkpoint(ck).restore_to(linked)
    ssts = glob.glob(os.path.join(linked, "*.sst"))
    assert ssts and all(os.stat(q).st_nlink >= 2 for q in ssts)

    def no_link(*a, **kw):
        raise OSError("EXDEV: cross-device link")

    with mp.context() as m:
        m.setattr(os, "link", no_link)
        copied = os.path.join(d, "copied")
        p.Checkpoint(ck).restore_to(copied)
    for name in sorted(os.listdir(linked)):
        with open(os.path.join(linked, name), "rb") as a, \
                open(os.path.join(copied, name), "rb") as b:
            assert a.read() == b.read(), name
    assert all(os.stat(q).st_nlink == 1
               for q in glob.glob(os.path.join(copied, "*.sst")))
    for dest in (linked, copied):
        db2 = p.DB.open(dest, p.options(create_if_missing=False))
        obs.append(db2.get(b"k00001"))
        db2.close()


def sc_mem_env_restore_copy_path(p, d, obs, mp):                   # :323
    env = p.MemEnv()
    db = p.DB.open("/db", p.options(), env=env)
    _workload(db, n=120)
    p.Checkpoint.create(db, "/ckpt")
    db.close()
    p.Checkpoint("/ckpt", env).restore_to("/restored")
    db2 = p.DB.open("/restored", p.options(create_if_missing=False),
                    env=env)
    try:
        obs += [db2.get(b"k00001"), _fingerprint(p, db2, None, n=120)]
    finally:
        db2.close()


def sc_store_fault_injector_is_seeded_and_verified(p, d, obs, mp):  # :390
    store = p.storage.LocalObjectStore(os.path.join(d, "store"))
    payload = bytes(range(256)) * 64
    addr = p.addr_for(payload)
    store.put(addr, payload)
    a = p.StoreFaultInjector(store, rate=0.5, seed=3)
    b = p.StoreFaultInjector(store, rate=0.5, seed=3)
    plans_a = [a._plan("fetch") for _ in range(50)]
    assert plans_a == [b._plan("fetch") for _ in range(50)]
    # A write never lies: its corrupt and truncate plans become drops.
    w = p.StoreFaultInjector(store, schedule={0: "corrupt", 1: "truncate",
                                              2: "delay"})
    obs.append([w._plan("put") for _ in range(3)])
    inj = p.StoreFaultInjector(store, schedule={0: "corrupt", 1: "corrupt"},
                               rate=0.0)
    tier = p.shared_env.StoreCacheTier(inj, attempts=4, backoff_base=0.0)
    assert tier.fetch(addr) == payload  # two corrupt answers, then clean
    drop = p.StoreFaultInjector(store, schedule={0: "drop"})
    with pytest.raises(p.status.IOError_):
        drop.fetch(addr)
    obs += [plans_a, inj.injected_counts(), drop.injected_counts()]


def sc_gc_never_sweeps_live(p, d, obs, mp):                        # :418
    spec = os.path.join(d, "store")
    dbdir = os.path.join(d, "db")
    db = p.DB.open(dbdir, p.options(shared_store=spec,
                                    statistics=p.st.Statistics()))
    try:
        _workload(db)
        store = db.env.store
        junk = b"junk" * 1024
        junk_addr = p.addr_for(junk)
        store.put(junk_addr, junk)
        pinned = b"pinned" * 341
        pinned_addr = p.addr_for(pinned)
        store.put(pinned_addr, pinned)
        store.pin(pinned_addr, "publisher", ttl=120.0)
        live = p.storage.collect_live_addresses([dbdir])
        assert live
        graced = p.storage.mark_sweep(store, [dbdir], grace_sec=3600.0)
        assert graced["swept"] == []
        rep = p.storage.mark_sweep(store, [dbdir],
                                   statistics=db.stats)
        assert junk_addr in rep["swept"] and not store.contains(junk_addr)
        assert pinned_addr not in rep["swept"]
        assert store.contains(pinned_addr)
        for addr in live:
            assert store.contains(addr), f"GC swept live object {addr}"
        assert db.get(b"k00001") == b"v1" * 17
        obs += [sorted(live), sorted(rep["swept"]), graced["kept_young"],
                db.stats.get_ticker_count(p.st.STORE_GC_SWEPT)]
    finally:
        db.close()


class _Lease:
    """A lease service with toplingdb_tpu's LeaseCoordinator interface:
    one holder per shard, Busy for anyone else."""

    def __init__(self, busy):
        self.busy = busy
        self.held = {}
        self.calls = []

    def acquire(self, shard, holder, ttl):
        self.calls.append(("acquire", shard, holder))
        cur = self.held.get(shard)
        if cur is not None and cur[0] != holder:
            raise self.busy(f"{shard} held by {cur[0]}")
        token = len(self.calls)
        self.held[shard] = (holder, token)
        return {"token": token}

    def release(self, shard, holder, token):
        self.calls.append(("release", shard, holder))
        if self.held.get(shard) == (holder, token):
            del self.held[shard]


def sc_gc_respects_refs_table_and_lease(p, d, obs, mp):            # :456
    store = p.storage.LocalObjectStore(os.path.join(d, "store"))
    payload = b"p" * 1024
    addr = p.addr_for(payload)
    store.put(addr, payload)
    boot = os.path.join(d, "bootstrapping")
    os.makedirs(boot)
    with open(os.path.join(boot, p.storage.REFS_NAME), "w") as f:
        f.write(json.dumps({"000001.sst": addr}))
    rep = p.storage.mark_sweep(store, [boot])
    assert rep["swept"] == [] and store.contains(addr)
    lease = _Lease(p.status.Busy)
    grant = lease.acquire("store-gc", "other-process", 60.0)
    with pytest.raises(p.status.Busy):
        p.storage.mark_sweep(store, [boot], lease=lease, holder="me")
    lease.release("store-gc", "other-process", grant["token"])
    rep = p.storage.mark_sweep(store, [], lease=lease, holder="me")
    assert rep["swept"] == [addr]
    assert p.storage.mark_sweep(store, [], lease=lease,
                                holder="me")["swept"] == []
    obs += [rep, lease.calls, lease.held]


def _store_dcompact(p, d, n_rounds, tag):
    """A DB on a store root whose jobs go through the subprocess worker on
    "cpu" (the per-entry route in both packages): returns the DB and the
    job dirs' SST paths seen when each worker finished, and the jobs'
    stats."""
    captured, stats_out = [], []

    class Capturing(p.ex.SubprocessCompactionExecutor):
        def _spawn_local(self, job_dir, device):
            super()._spawn_local(job_dir, device)
            captured.append(glob.glob(os.path.join(job_dir, "**", "*.sst"),
                                      recursive=True))

        def execute(self, db, compaction, snapshots, new_file_number):
            out = super().execute(db, compaction, snapshots,
                                  new_file_number)
            stats_out.append(out[1])
            return out

    class Factory(p.ex.SubprocessCompactionExecutorFactory):
        def new_executor(self, compaction):
            return Capturing(self.device, self.job_root, policy=self.policy)

    opts = p.options(shared_store=os.path.join(d, "store"),
                     statistics=p.st.Statistics(),
                     disable_auto_compactions=True,
                     compaction_executor_factory=Factory(
                         device="cpu", job_root=os.path.join(d, "jobs")))
    db = p.DB.open(os.path.join(d, tag), opts)
    for r in range(n_rounds):
        for i in range(r * 200, r * 200 + 300):
            db.put(b"k%05d" % i, b"v%d-%d" % (i, r) * 9)
        db.flush()
    db.compact_range()
    return db, captured, stats_out


def sc_dcompact_zero_sst_bytes_shipped(p, d, obs, mp):             # :487
    db, captured, stats_out = _store_dcompact(p, d, 2, "db")
    try:
        assert stats_out, "no dcompact job ran"
        for s in stats_out:
            assert s.remote is True and s.sst_bytes_shipped == 0
        assert captured and all(lst == [] for lst in captured), captured
        refs = db.env.refs_of(os.path.join(d, "db"))
        assert refs
        store = p.storage.LocalObjectStore(os.path.join(d, "store"))
        for addr in refs.values():
            assert store.contains(addr)
        reads = [db.get(b"k%05d" % i) for i in range(500)]
        assert reads[0] == b"v0-0" * 9 and reads[499] == b"v499-1" * 9
        # Adopted outputs are unpinned: their refs shield them now.
        obs += [sorted(refs.items()), reads, sorted(store.pinned()),
                store.list_addresses(), len(stats_out)]
    finally:
        db.close()


def sc_dcompact_output_meta_checksum_matches_address(p, d, obs, mp):  # :558
    db, _captured, _stats = _store_dcompact(p, d, 2, "db")
    try:
        refs = db.env.refs_of(os.path.join(d, "db"))
        assert refs
        live = [f for cf in db.versions.column_families.values()
                for _lvl, f in cf.current.all_files()]
        by_name = {f"{f.number:06d}.sst": f for f in live}
        matched = 0
        for name, addr in refs.items():
            meta = by_name.get(name)
            if meta is None:
                continue  # a ref the next obsolete-file sweep drops
            assert p.storage.address_of_meta(meta) == addr
            matched += 1
        assert matched == len(live)
        obs += [matched, sorted(p.storage.address_of_meta(f) for f in live)]
    finally:
        db.close()


def sc_http_store_round_trip(p, d, obs, mp):                       # :602
    srv = p.storage.StoreServer(
        p.storage.LocalObjectStore(os.path.join(d, "store")))
    port = srv.start()
    try:
        cl = p.storage.StoreClient(f"http://127.0.0.1:{port}")
        payload = bytes(range(200)) * 120
        addr = p.addr_for(payload)
        obs += [cl.put(addr, payload), cl.put(addr, payload)]
        assert cl.fetch(addr) == payload and cl.contains(addr)
        with pytest.raises(p.status.NotFound):
            cl.fetch(p.addr_for(b"nothing"))
        with pytest.raises(p.status.Corruption):
            cl.put(p.addr_for(b"aaaa"), b"bbbb")  # 422
        cl.pin(addr, "tester", ttl=60.0)
        obs.append(sorted(cl.pinned()))
        cl.unpin(addr)
        doc = cl.status()
        obs.append({k: doc[k] for k in ("backend", "objects", "bytes",
                                         "pinned")})
        env = p.storage.SharedSstEnv(p.default_env(), cl,
                                     cache_dir=os.path.join(d, "cache"))
        try:
            dd = os.path.join(d, "d")
            os.makedirs(dd)
            env.adopt(f"{dd}/000001.sst", addr)
            assert env.read_file(f"{dd}/000001.sst") == payload
        finally:
            env.close()
        obs += [cl.list_addresses(), cl.delete(addr), cl.contains(addr)]
    finally:
        srv.stop()


def sc_store_client_maps_dead_server_to_ioerror(p, d, obs, mp):    # :638
    cl = p.storage.StoreClient(
        "http://127.0.0.1:9", timeout=0.2,
        options=p.DcompactOptions(max_attempts=2, backoff_base=0.0))
    with pytest.raises(p.status.IOError_):
        cl.contains("crc32c-00000000-1")
    obs.append(cl.breaker.state)


def sc_slo_spec_over_cold_fetch_histogram(p, d, obs, mp):          # :654
    stats = p.st.Statistics()
    store = p.storage.LocalObjectStore(os.path.join(d, "store"))
    payload = b"c" * 4096
    addr = p.addr_for(payload)
    store.put(addr, payload)
    tier = p.shared_env.StoreCacheTier(store, stats=stats)
    for _ in range(3):
        tier.fetch(addr)  # no cache dir: every fetch is cold
    spec = p.slo.SLOSpec(name="store-cold-fetch", kind="latency",
                         histogram=p.st.STORE_FETCH_MICROS,
                         threshold_usec=5_000_000.0, objective=0.99)
    doc = p.slo.SLOEngine(stats, [spec]).evaluate()
    assert doc["health"] == "green"
    assert not doc["specs"]["store-cold-fetch"]["firing"]
    t = stats.tickers()
    obs += [t.get(p.st.STORE_MISSES, 0), t.get(p.st.STORE_BYTES_FETCHED, 0),
            stats.get_histogram(p.st.STORE_FETCH_MICROS).count]


def sc_store_http_view(p, d, obs, mp):                             # :679
    db = p.DB.open(os.path.join(d, "db"),
                   p.options(shared_store=os.path.join(d, "store"),
                             statistics=p.st.Statistics()))
    repo = p.SidePluginRepo()
    try:
        _workload(db, n=100)
        repo.attach_db("d1", db)
        port = repo.start_http(0)
        doc = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/store/d1", timeout=5).read())
        assert doc["enabled"] is True
        assert doc["tickers"][p.st.STORE_PUBLISHES] >= 1
        plain = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/stats/d1", timeout=5).read())
        assert plain is not None
        obs += [doc["tickers"], doc["store"]["objects"],
                doc["store"]["backend"], sorted(doc["referenced"])]
    finally:
        repo.stop_http()
        db.close()


class _DownStore:
    """A store whose every verb fails, as an unreachable one does."""

    def __init__(self, io_error):
        self.io_error = io_error

    def __getattr__(self, name):
        def fail(*a, **kw):
            raise self.io_error(f"store down: {name}")
        return fail


def sc_checkpoint_degrades_on_store_outage(p, d, obs, mp):
    """A store that fails while a checkpoint is taken: each SST takes the
    byte path, the fallback is counted, and the copy opens and verifies."""
    db = p.DB.open(os.path.join(d, "db"),
                   p.options(shared_store=os.path.join(d, "store")))
    try:
        _workload(db, n=150)
        env = p.untapped(db.env)
        env.store = _DownStore(p.status.IOError_)
        before = p.errors.swallowed_total()
        ck = os.path.join(d, "ckpt")
        p.Checkpoint.create(db, ck)
        n_ssts = len(glob.glob(os.path.join(ck, "*.sst")))
        assert n_ssts >= 1
        assert p.errors.swallowed_total() - before >= n_ssts
        assert env.refs_of(ck) == {}
        db2 = p.DB.open(ck, p.options(create_if_missing=False))
        try:
            obs += [n_ssts, _fingerprint(p, db2, None, n=150)]
        finally:
            db2.close()
    finally:
        db.close()


SCENARIOS = [
    sc_address_scheme_stability_and_verification,
    sc_local_store_dedup_and_pins,
    sc_concurrent_publish_idempotent,
    sc_open_store_spec_forms,
    sc_shared_env_reads_are_reference_then_local,
    sc_warm_refs_prefetches_into_cache,
    sc_reference_checkpoint_and_restore_equivalence,
    sc_restore_hardlink_fast_path_parity,
    sc_mem_env_restore_copy_path,
    sc_store_fault_injector_is_seeded_and_verified,
    sc_gc_never_sweeps_live,
    sc_gc_respects_refs_table_and_lease,
    sc_dcompact_zero_sst_bytes_shipped,
    sc_dcompact_output_meta_checksum_matches_address,
    sc_http_store_round_trip,
    sc_store_client_maps_dead_server_to_ioerror,
    sc_slo_spec_over_cold_fetch_histogram,
    sc_store_http_view,
    sc_checkpoint_degrades_on_store_outage,
]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__[3:] for f in SCENARIOS])
def test_shared_store_against_reference(tmp_path, monkeypatch,
                                        no_thread_leaks,  # noqa: F811
                                        pinned_clock, scenario):
    seen = {}
    for name in ("ref", "port"):
        obs = []
        d = str(tmp_path / name)
        os.makedirs(d)
        scenario(Pkg(name == "ref"), d, obs, monkeypatch)
        seen[name] = obs
    assert seen["port"] == seen["ref"]


# ---------------------------------------------------------------------------
# The parity matrix (:175): the store on and off, in both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt_name,codec", [
    ("block", "NO_COMPRESSION"),
    ("zip", "ZLIB_COMPRESSION"),
])
def test_shared_env_parity_matrix(tmp_path, no_thread_leaks,  # noqa: F811
                                  pinned_clock, fmt_name, codec):
    """The same workload with the store off and on in each package: equal
    iterator, point and snapshot reads in all four runs, and the two
    packages' stores list the same addresses (the same table bytes)."""
    runs, stores = {}, {}
    for name in ("ref", "port"):
        p = Pkg(name == "ref")
        for mode in ("oracle", "shared"):
            spec = str(tmp_path / name / "store") if mode == "shared" \
                else None
            opts = p.options(compression=getattr(p.tfmt, codec),
                             shared_store=spec)
            opts.table_options.format = fmt_name
            db = p.DB.open(str(tmp_path / name / mode), opts)
            try:
                snap = _workload(db)
                runs[(name, mode)] = _fingerprint(p, db, snap)
                if mode == "shared":
                    assert hasattr(db.env, "publish_sst")
            finally:
                db.close()
        stores[name] = p.storage.LocalObjectStore(
            str(tmp_path / name / "store")).list_addresses()
    assert runs[("port", "shared")] == runs[("port", "oracle")] \
        == runs[("ref", "shared")] == runs[("ref", "oracle")]
    assert stores["port"] and stores["port"] == stores["ref"]


# ---------------------------------------------------------------------------
# The port alone
# ---------------------------------------------------------------------------


def test_port_reads_no_store_env_var(tmp_path, monkeypatch):
    """TPULSM_SHARED_STORE (the reference's knob, which wins over its
    Options) does nothing to the port: only Options.shared_store opens a
    store, and a spec naming no backend is refused at open."""
    monkeypatch.setenv("TPULSM_SHARED_STORE", str(tmp_path / "store"))
    p = Pkg(False)
    with dbm.DB.open(str(tmp_path / "db"), p.options()) as db:
        db.put(b"k", b"v")
        db.flush()
        assert not hasattr(db.env, "publish_sst")
    assert not os.path.exists(str(tmp_path / "store"))
    with pytest.raises(status.NotSupported, match="store_spec"):
        dbm.DB.open(str(tmp_path / "db2"),
                    p.options(shared_store="mem://store"))
    assert not os.path.exists(str(tmp_path / "db2"))


def test_reclaim_ladder_red_prunes_the_tier_and_sweeps_the_store(
        tmp_path, no_thread_leaks):  # noqa: F811
    """The reclaim ladder's red steps on a SharedSstEnv: the cache tier
    drops its clean objects (refetched on demand) and a mark-sweep GC
    rooted at this DB and its siblings removes an unreferenced object
    older than the grace, never a live one."""
    p = Pkg(False)
    spec = str(tmp_path / "store")
    stats = st.Statistics()
    db = dbm.DB.open(str(tmp_path / "db"), p.options(
        shared_store=spec, statistics=stats,
        free_space_poll_period_sec=3600.0))
    try:
        _workload(db, n=200)
        store = db.env.store
        junk = b"j" * 2048
        junk_addr = p.addr_for(junk)
        store.put(junk_addr, junk)
        old = time.time() - 3600
        os.utime(store._obj_path(junk_addr), (old, old))
        live = storage.collect_live_addresses([str(tmp_path / "db")])
        # A cold fetch through the tier fills its cache.
        addr = sorted(live)[0]
        db.env.tier.fetch(addr)
        assert db.env.tier.cache_stats()
        db._run_reclaim_ladder("red")
        for t in list(db._recover_threads):
            t.join(timeout=30)
        assert not store.contains(junk_addr)
        assert all(store.contains(a) for a in live)
        assert stats.get_ticker_count(st.STORE_GC_SWEPT) >= 1
        assert stats.get_ticker_count(st.DISK_RECLAIM_RUNS) == 1
        assert db.get(b"k00001") == b"v1" * 17
    finally:
        db.close()


def test_last_close_releases_the_shared_env(tmp_path,
                                            no_thread_leaks):  # noqa: F811
    """Two DBs on one SharedSstEnv (a restore reopened on the source's
    env): the warm ring lives until the last of them closes."""
    p = Pkg(False)
    db = dbm.DB.open(str(tmp_path / "db"),
                     p.options(shared_store=str(tmp_path / "store")))
    _workload(db, n=100)
    env = p.untapped(db.env)
    ck = str(tmp_path / "ck")
    Checkpoint.create(db, ck)
    Checkpoint(ck, env).restore_to(str(tmp_path / "r"))  # warms: a ring
    env.tier.drain()
    db2 = dbm.DB.open(str(tmp_path / "r"),
                      p.options(create_if_missing=False), env=env)
    assert env._attached == 2 and env.tier._ring is not None
    db.close()
    assert env._attached == 1 and env.tier._ring is not None
    assert db2.get(b"k00001") == b"v1" * 17
    db2.close()
    assert env._attached == 0 and env.tier._ring is None
