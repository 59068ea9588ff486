"""The replication plane of toplingdb_tpu_torch (replication/: the log
shipper with its CRC-framed ShipFrames, the transports and the
ReplicationServer, FollowerDB, ReplicaRouter; ShipFaultInjector and
PartitionGate; the SidePlugin repo's /replication view and POST /promote)
against toplingdb_tpu's, on the CPU.

- the cases of tests/test_replication.py at :53, :61, :77, :101, :133,
  :169, :204, :236, :260, :345, :388, :417, :464, :488, :513 and :548
  run on each package (the port's primary with
  DeviceCompactionExecutorFactory(device="cpu"), the reference's with its
  device factory on "cpu-jax"), with what the reference's test asserts;
  each case's observations (dumps, applied sequences, deterministic
  tickers, frames) are equal across the packages. The chaos soak (:260)
  runs in both of its modes at 15 rounds of 20 writes (the reference
  runs 30). The SidePlugin case drives the HTTP routes where the
  reference's drives tools/repl_admin (tools/ is not in the port);
- frames: with time.time() pinned in both shippers, the port's ShipFrame
  bytes for the same WAL equal the reference's, and so do the MANIFEST
  epochs (manifest number, records in the live MANIFEST) they carry;
- the injectors: ShipFaultInjector's seeded plans equal the reference's,
  PartitionGate fails fast while engaged;
- the port alone: a follower runs no compaction and reads the tables the
  primary's device executor wrote; POST /promote on a DB that is no
  follower answers 400.

Tolerance: none.
"""

import json
import os
import random
import threading
import time
import urllib.error
import urllib.request

import pytest

import toplingdb_tpu.db.db as ref_dbm
import toplingdb_tpu.replication as ref_repl
import toplingdb_tpu.replication.log_shipper as ref_ls
import toplingdb_tpu.replication.router as ref_router
from toplingdb_tpu.compaction.executor import (
    DeviceCompactionExecutorFactory as RefFactory,
)
from toplingdb_tpu.db.db_readonly import ReadOnlyDB as RefReadOnlyDB
from toplingdb_tpu.db.db_readonly import SecondaryDB as RefSecondaryDB
from toplingdb_tpu.env import fault_injection as ref_fi
from toplingdb_tpu.options import Options as RefOptions
from toplingdb_tpu.utilities.checkpoint import Checkpoint as RefCheckpoint
from toplingdb_tpu.utils import status as ref_status
from toplingdb_tpu.utils.config import SidePluginRepo as RefSidePluginRepo
from toplingdb_tpu.utils.config import load_latest_options as ref_load_opts
from toplingdb_tpu.utils.statistics import Statistics as RefStatistics

import toplingdb_tpu_torch.db.db as dbm
import toplingdb_tpu_torch.replication as repl
import toplingdb_tpu_torch.replication.log_shipper as ls
import toplingdb_tpu_torch.replication.router as router_mod
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory,
)
from toplingdb_tpu_torch.db.db_readonly import ReadOnlyDB, SecondaryDB
from toplingdb_tpu_torch.env import fault_injection as fi
from toplingdb_tpu_torch.options import Options
from toplingdb_tpu_torch.utilities.checkpoint import Checkpoint
from toplingdb_tpu_torch.utils import status
from toplingdb_tpu_torch.utils.config import SidePluginRepo
from toplingdb_tpu_torch.utils.config import load_latest_options
from toplingdb_tpu_torch.utils.statistics import Statistics

from test_torch_block_cache import no_thread_leaks  # noqa: F401

CLOCK = 1_700_000_000.0
CPU = {"class": "device", "params": {"device_name": "cpu"}}


class _PinnedTime:
    """`time` as a module sees it, with time.time() fixed."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def time():
        return CLOCK


class Pkg:
    """One package's replication surface under the same names."""

    def __init__(self, ref: bool):
        self.ref = ref
        self.DB = ref_dbm.DB if ref else dbm.DB
        self.repl = ref_repl if ref else repl
        self.ls = ref_ls if ref else ls
        self.router = ref_router if ref else router_mod
        self.ReadOnlyDB = RefReadOnlyDB if ref else ReadOnlyDB
        self.SecondaryDB = RefSecondaryDB if ref else SecondaryDB
        self.fi = ref_fi if ref else fi
        self.Checkpoint = RefCheckpoint if ref else Checkpoint
        self.status = ref_status if ref else status
        self.SidePluginRepo = RefSidePluginRepo if ref else SidePluginRepo
        self.load_latest_options = (ref_load_opts if ref
                                    else load_latest_options)
        self.Statistics = RefStatistics if ref else Statistics
        self.Options = RefOptions if ref else Options

    def opts(self, **kw):
        """A primary's options (the reference test's opts())."""
        kw.setdefault("write_buffer_size", 1 << 20)
        kw.setdefault("statistics", self.Statistics())
        kw.setdefault("create_if_missing", True)
        kw["compaction_executor_factory"] = (
            RefFactory(device="cpu-jax") if self.ref
            else DeviceCompactionExecutorFactory(device="cpu"))
        return self.Options(**kw)

    def fopts(self, **kw):
        """A follower's options."""
        return self.Options(**kw)

    def open_follower(self, path, transport, mode, **kw):
        return self.repl.FollowerDB.open(path, self.fopts(**kw),
                                         transport=transport, mode=mode)


def dump(db):
    """Full user-visible content across every CF: the parity fingerprint."""
    out = []
    for handle in sorted(db.list_column_families(), key=lambda h: h.id):
        it = db.new_iterator(cf=handle)
        it.seek_to_first()
        rows = []
        while it.valid():
            rows.append((it.key(), it.value()))
            it.next()
        out.append((handle.id, handle.name, rows))
    return out


def http_json(url, body=None):
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


# ---------------------------------------------------------------------------
# The cases of tests/test_replication.py (line numbers of that file)
# ---------------------------------------------------------------------------


def sc_frame_roundtrip(p, d, obs):                                 # :53
    f = p.repl.ShipFrame(epoch=7, first_seq=10, last_seq=42,
                         shipped_unix_us=123456,
                         batches=[b"abc", b"", b"x" * 999])
    enc = f.encode()
    g = p.repl.ShipFrame.decode(enc)
    assert (g.epoch, g.first_seq, g.last_seq, g.shipped_unix_us,
            g.batches) == (7, 10, 42, 123456, [b"abc", b"", b"x" * 999])
    obs += [enc, p.ls.pack_epoch(5, 9), p.ls.pack_epoch(1 << 33, 1)]


def sc_frame_detects_truncation_and_bitflips(p, d, obs):           # :61
    f = p.repl.ShipFrame(epoch=1, first_seq=1, last_seq=3,
                         shipped_unix_us=0, batches=[b"payload-bytes" * 10])
    enc = f.encode()
    for cut in (0, 4, len(enc) // 2, len(enc) - 1):
        with pytest.raises(p.status.Corruption):
            p.repl.ShipFrame.decode(enc[:cut])
    flipped = bytearray(enc)
    flipped[len(enc) - 3] ^= 0x40
    with pytest.raises(p.status.Corruption):
        p.repl.ShipFrame.decode(bytes(flipped))
    bad = bytearray(enc)
    bad[4] = 9  # an unknown version
    with pytest.raises(p.status.Corruption):
        p.repl.ShipFrame.decode(bytes(bad))
    obs.append(enc)


def sc_shipper_serves_and_detects_retention_gone(p, d, obs):       # :77
    db = p.DB.open(os.path.join(d, "db"), p.opts())
    ship = p.repl.LogShipper(db)
    for i in range(20):
        db.put(b"k%02d" % i, b"v%02d" % i)
    frames, state = ship.frames_since(0)
    assert frames and frames[0].first_seq == 1
    assert frames[-1].last_seq == state["last_sequence"] == 20
    obs += [[f.encode() for f in frames], state]
    frames, _ = ship.frames_since(20)
    assert frames == []
    db.flush()
    for i in range(5):
        db.put(b"x%02d" % i, b"y")
    db.flush()
    db.put(b"tail", b"t")
    with pytest.raises(p.repl.WalRetentionGone):
        ship.frames_since(3)
    frames, state = ship.frames_since(None)
    obs += [[f.encode() for f in frames], state, ship.status()]
    db.close()


def sc_follower_shared_parity_and_epoch_reload(p, d, obs):         # :101
    src = os.path.join(d, "db")
    db = p.DB.open(src, p.opts())
    ship = p.repl.LogShipper(db)
    fol = p.open_follower(src, p.repl.LocalTransport(ship), "shared",
                          statistics=db.stats)
    for i in range(50):
        db.put(b"a%03d" % i, b"v%03d" % i)
    fol.catch_up()
    assert fol.get(b"a025") == b"v025"
    db.flush()
    for i in range(50):
        db.put(b"a%03d" % i, b"w%03d" % i)
    db.delete(b"a000")
    db.flush()
    db.compact_range()
    for _ in range(4):
        fol.catch_up()
    assert fol.get(b"a000") is None
    assert fol.get(b"a001") == b"w001"
    assert dump(fol) == dump(db)
    s = fol.replication_status()
    assert s["role"] == "follower"
    assert s["applied_sequence"] == db.versions.last_sequence
    reloads = db.stats.get_ticker_count("replication.epoch.reloads")
    assert reloads >= 1
    obs += [dump(fol), s, reloads]
    fol.close()
    db.close()


def sc_follower_standalone_bootstrap_after_wal_gc(p, d, obs):      # :133
    src, fdir = os.path.join(d, "db"), os.path.join(d, "fol")
    db = p.DB.open(src, p.opts())
    tr = p.repl.LocalTransport(p.repl.LogShipper(db))
    for i in range(30):
        db.put(b"k%03d" % i, b"v%03d" % i)
    fol = p.open_follower(fdir, tr, "standalone", statistics=db.stats)
    assert fol.get(b"k010") == b"v010"  # bootstrapped from a checkpoint
    db.put(b"live", b"1")
    fol.catch_up()
    assert fol.get(b"live") == b"1"
    db.flush()
    for i in range(40):
        db.put(b"g%03d" % i, b"w%03d" % i)
    db.flush()
    db.put(b"tail", b"t")
    for _ in range(4):
        fol.catch_up()
    assert fol.get(b"g020") == b"w020"
    assert fol.get(b"tail") == b"t"
    assert fol.applied_sequence() == db.versions.last_sequence
    boots = db.stats.get_ticker_count("replication.bootstraps")
    assert boots >= 1
    assert dump(fol) == dump(db)
    obs += [dump(fol), boots, fol.replication_status()["mode"]]
    fol.close()
    db.close()
    # The frame journal: the reopened follower resumes from it.
    fol = p.open_follower(fdir, None, "standalone")
    try:
        obs.append(fol.get(b"tail"))
    finally:
        fol.close()


def sc_router_read_your_writes_token(p, d, obs):                   # :169
    src = os.path.join(d, "db")
    db = p.DB.open(src, p.opts())
    ship = p.repl.LogShipper(db)
    fol = p.open_follower(src, p.repl.LocalTransport(ship), "shared")
    router = p.repl.ReplicaRouter(db, [fol])
    stats = db.stats
    token = router.put(b"k", b"v1")
    assert token == db.versions.last_sequence
    assert router.get(b"k", token=token) == b"v1"
    assert stats.get_ticker_count("replication.router.primary.reads") == 1
    assert stats.get_ticker_count("replication.router.stale.skips") == 1
    fol.catch_up()
    assert fol.applied_sequence() >= token
    assert router.get(b"k", token=token) == b"v1"
    assert stats.get_ticker_count("replication.router.follower.reads") == 1
    assert router.get(b"k") == b"v1"
    t2 = router.put(b"k2", b"v2")
    assert router.multi_get([b"k", b"k2"], token=t2) == [b"v1", b"v2"]
    fol.catch_up()
    assert router.multi_get([b"k", b"k2"], token=t2) == [b"v1", b"v2"]
    t3 = router.put(b"k3", b"v3")
    it = router.new_iterator(token=t3)
    it.seek(b"k3")
    assert it.valid() and it.value() == b"v3"
    # An epoch-stamped token of another epoch goes to the primary.
    stale = p.repl.StalenessToken(seq=1, epoch=99)
    assert router.get(b"k", token=stale) == b"v1"
    tok = router.token(t3)
    obs += [token, t2, t3, (tok.seq, tok.epoch),
            [stats.get_ticker_count(f"replication.router.{k}") for k in
             ("primary.reads", "follower.reads", "stale.skips",
              "epoch.rejects")]]
    fol.close()
    db.close()


def sc_router_breaker_skips_failing_follower(p, d, obs):           # :204
    db = p.DB.open(os.path.join(d, "db"), p.opts())
    db.put(b"k", b"v")

    class BrokenReplica:
        def applied_sequence(self):
            return 1 << 60

        def get(self, *a, **kw):
            raise RuntimeError("replica down")

        multi_get = new_iterator = get

    router = p.repl.ReplicaRouter(
        db, [BrokenReplica()], p.router.RouterOptions(
            breaker_failure_threshold=2, breaker_reset_timeout=3600.0))
    for _ in range(4):
        assert router.get(b"k") == b"v"
    skips = db.stats.get_ticker_count("replication.router.breaker.skips")
    assert skips >= 1
    snap = router.status()["health"]
    assert list(snap.values())[0]["state"] == "open"
    obs += [skips, [v["state"] for v in snap.values()]]
    db.close()


def sc_router_max_lag_bound(p, d, obs):                            # :236
    src = os.path.join(d, "db")
    db = p.DB.open(src, p.opts())
    fol = p.open_follower(src, p.repl.LocalTransport(p.repl.LogShipper(db)),
                          "shared")
    router = p.repl.ReplicaRouter(db, [fol],
                                  p.router.RouterOptions(max_lag_seq=5))
    for i in range(20):
        db.put(b"k%02d" % i, b"v")
    assert router.get(b"k00") == b"v"
    skips = db.stats.get_ticker_count("replication.router.stale.skips")
    assert skips >= 1
    fol.catch_up()
    assert router.get(b"k00") == b"v"
    reads = db.stats.get_ticker_count("replication.router.follower.reads")
    assert reads >= 1
    obs += [skips, reads, [f["lag_seq"] for f in
                           router.status()["followers"]]]
    fol.close()
    db.close()


def _chaos_soak(p, d, obs, mode, rounds=15):                       # :260
    src = os.path.join(d, "db")
    fdir = src if mode == "shared" else os.path.join(d, "fol")
    db = p.DB.open(src, p.opts())
    ship = p.repl.LogShipper(db)
    injector = p.fi.ShipFaultInjector(rate=0.30, seed=1234, delay_sec=0.001)
    transport = p.repl.FaultyTransport(p.repl.LocalTransport(ship),
                                       injector)
    fol = p.open_follower(fdir, transport, mode, statistics=db.stats)
    router = p.repl.ReplicaRouter(db, [fol])
    rng = random.Random(99)
    expected = {}
    for round_no in range(rounds):
        for _ in range(20):
            k = b"key%03d" % rng.randrange(200)
            if rng.random() < 0.15 and k in expected:
                token = router.delete(k)
                expected.pop(k, None)
            else:
                v = b"val%06d" % rng.randrange(1 << 20)
                token = router.put(k, v)
                expected[k] = v
            if rng.random() < 0.3:
                got = router.get(k, token=token)
                assert got == expected.get(k), (round_no, k)
        if round_no % 5 == 4:
            db.flush()
        fol.catch_up()
    counts = injector.injected_counts()
    assert sum(counts.values()) >= 5, counts
    for _ in range(60):
        fol.catch_up()
        if fol.applied_sequence() == db.versions.last_sequence:
            break
    assert fol.applied_sequence() == db.versions.last_sequence
    ckpt_dir = os.path.join(d, "ckpt")
    p.Checkpoint.create(db, ckpt_dir)
    ck = p.ReadOnlyDB.open(ckpt_dir, p.fopts())
    try:
        follower_view = {k: v for _, _, rows in dump(fol) for k, v in rows}
        ckpt_view = {k: v for _, _, rows in dump(ck) for k, v in rows}
        assert follower_view == ckpt_view == expected
    finally:
        ck.close()
    if counts.get("truncate"):
        assert db.stats.get_ticker_count("replication.frame.corrupt") >= 1
    assert db.stats.get_histogram("replication.lag.micros").count >= 1
    obs += [sorted(expected.items()), counts,
            db.stats.get_ticker_count("replication.frame.corrupt")]
    fol.close()
    db.close()


def sc_chaos_soak_shared(p, d, obs):
    _chaos_soak(p, d, obs, "shared")


def sc_chaos_soak_standalone(p, d, obs):
    _chaos_soak(p, d, obs, "standalone")


def sc_background_tailing_with_concurrent_writes(p, d, obs):       # :345
    src = os.path.join(d, "db")
    db = p.DB.open(src, p.opts())
    fol = p.open_follower(src, p.repl.LocalTransport(p.repl.LogShipper(db)),
                          "shared")
    fol.start_tailing(interval=0.005)
    router = p.repl.ReplicaRouter(db, [fol])
    errors = []

    def writer(tid):
        try:
            for i in range(150):
                token = router.put(b"t%d-%03d" % (tid, i), b"v%03d" % i)
                if i % 20 == 0:
                    got = router.get(b"t%d-%03d" % (tid, i), token=token)
                    assert got == b"v%03d" % i
        except Exception as e:  # noqa: BLE001 - the test records it
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(t,)) for t in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    deadline = time.monotonic() + 10
    while (fol.applied_sequence() != db.versions.last_sequence
           and time.monotonic() < deadline):
        time.sleep(0.02)
    assert fol.applied_sequence() == db.versions.last_sequence
    fol.stop_tailing()
    assert dump(fol) == dump(db)
    obs += [dump(fol), fol.replication_status()["tailing"]]
    fol.close()
    db.close()


def sc_http_transport_and_replication_server(p, d, obs):           # :388
    src, fdir = os.path.join(d, "db"), os.path.join(d, "fol")
    db = p.DB.open(src, p.opts())
    srv = p.repl.ReplicationServer(db)
    port = srv.start()
    try:
        for i in range(25):
            db.put(b"h%03d" % i, b"v%03d" % i)
        tr = p.repl.HttpTransport(f"http://127.0.0.1:{port}")
        fol = p.open_follower(fdir, tr, "standalone")
        assert fol.get(b"h011") == b"v011"
        db.put(b"after", b"x")
        fol.catch_up()
        assert fol.get(b"after") == b"x"
        assert dump(fol) == dump(db)
        s = http_json(f"http://127.0.0.1:{port}/replication/status")
        assert s["role"] == "primary"
        assert s["last_sequence"] == db.versions.last_sequence
        health = http_json(f"http://127.0.0.1:{port}/replication/health")
        assert health["replication"]["role"] == "primary"
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            assert r.status == 200
        # A pull past WAL retention answers 410 -> WalRetentionGone.
        db.flush()
        db.put(b"more", b"m")
        db.flush()
        db.put(b"last", b"l")
        with pytest.raises(p.repl.WalRetentionGone):
            tr.pull(1)
        obs += [dump(fol), s["role"], s["last_sequence"]]
        fol.close()
    finally:
        srv.stop()
        db.close()


def sc_sideplugin_replication_view_and_promote(p, d, obs):         # :417
    src = os.path.join(d, "db")
    repo = p.SidePluginRepo()
    cfg = {"create_if_missing": True}
    if not p.ref:
        cfg["compaction_executor_factory"] = CPU
    db = repo.open_db({"path": src, "options": cfg}, name="prim")
    ship = p.repl.LogShipper(db)
    fol = p.open_follower(src, p.repl.LocalTransport(ship), "shared")
    repo.attach_db("fol", fol, {"options": {} if p.ref else {
        "compaction_executor_factory": CPU}})
    port = repo.start_http()
    base = f"http://127.0.0.1:{port}"
    try:
        db.put(b"a", b"1")
        fol.catch_up()
        prim = http_json(f"{base}/replication/prim")
        assert prim["role"] == "primary" and prim["frames_shipped"] >= 1
        fv = http_json(f"{base}/replication/fol")
        assert fv["role"] == "follower"
        assert fv["applied_sequence"] == db.versions.last_sequence
        # The primary "dies"; the follower becomes read-write.
        db.close()
        out = http_json(f"{base}/promote/fol", {})
        promoted = repo.get_db("fol")
        assert promoted is not fol
        promoted.put(b"post-promote", b"yes")
        assert promoted.get(b"a") == b"1"
        pv = http_json(f"{base}/replication/fol")
        assert pv["role"] == "primary-unshipped"
        with pytest.raises(urllib.error.HTTPError) as ei:
            http_json(f"{base}/promote/nope", {})
        obs += [prim["role"], fv["role"], out["promoted"],
                out["last_sequence"], pv["role"], ei.value.code,
                promoted.get(b"post-promote")]
    finally:
        repo.stop_http()
        d2 = repo.get_db("fol")
        if d2 is not None:
            d2.close()


def sc_secondary_catchup_cf_created_and_dropped(p, d, obs):        # :464
    src = os.path.join(d, "db")
    db = p.DB.open(src, p.opts())
    doomed = db.create_column_family("doomed")
    db.put(b"d", b"1", cf=doomed)
    db.put(b"k", b"v")
    db.flush()
    sec = p.SecondaryDB.open(src, p.fopts())
    assert sec.get(b"k") == b"v"
    assert sec.get(b"d", cf=1) == b"1"
    db.drop_column_family(doomed)
    newcf = db.create_column_family("fresh")
    db.put(b"f", b"2", cf=newcf)
    sec.try_catch_up_with_primary()
    names = sorted(h.name for h in sec.list_column_families())
    assert "doomed" not in names and "fresh" in names
    fresh = sec.get_column_family("fresh")
    assert sec.get(b"f", cf=fresh) == b"2"
    obs += [names, dump(sec)]
    sec.close()
    db.close()


def sc_secondary_catchup_survives_wal_gc(p, d, obs):               # :488
    src = os.path.join(d, "db")
    db = p.DB.open(src, p.opts())
    db.put(b"k", b"old")
    sec = p.SecondaryDB.open(src, p.fopts())
    assert sec.get(b"k") == b"old"
    db.put(b"k", b"mid")
    db.delete(b"k")
    db.flush()
    db.compact_range()
    sec.try_catch_up_with_primary()
    assert sec.get(b"k") is None
    db.put(b"k", b"new")
    sec.try_catch_up_with_primary()
    assert sec.get(b"k") == b"new"
    obs.append(dump(sec))
    sec.close()
    db.close()


def sc_checkpoint_options_and_restore_refusal(p, d, obs):          # :513
    src, dst = os.path.join(d, "db"), os.path.join(d, "ck")
    db = p.DB.open(src, p.opts())
    for i in range(10):
        db.put(b"c%02d" % i, b"v")
    ck = p.Checkpoint.create(db, dst)
    names = sorted(os.listdir(dst))
    assert "CURRENT" in names
    assert any(n.startswith("OPTIONS-") for n in names), names
    ck.verify()
    restored = ck.restore_to(os.path.join(d, "restored"))
    db.close()
    lo = p.load_latest_options(restored)
    assert lo is not None
    os.remove(os.path.join(dst, "CURRENT"))  # an interrupted create
    with pytest.raises(p.status.InvalidArgument):
        p.Checkpoint(dst).restore_to(os.path.join(d, "nope"))
    rdb = p.ReadOnlyDB.open(restored, p.fopts())
    try:
        obs += [[n for n in names if not n.startswith("OPTIONS-")],
                rdb.get(b"c05")]
    finally:
        rdb.close()


def sc_ship_fault_injector_is_seeded(p, d, obs):
    a = p.fi.ShipFaultInjector(rate=0.4, seed=7)
    b = p.fi.ShipFaultInjector(rate=0.4, seed=7)
    plans = [a.plan() for _ in range(60)]
    assert plans == [b.plan() for _ in range(60)]
    s = p.fi.ShipFaultInjector(schedule={1: "truncate"})
    obs += [plans, a.injected_counts(), [s.plan() for _ in range(3)],
            s.truncate_bytes(b"0123456789"), s.truncate_bytes(b"ab")]


def sc_partition_gate_fails_fast(p, d, obs):
    gate = p.fi.PartitionGate()
    gate.check("pull")
    gate.engage()
    assert gate.engaged
    for _ in range(3):
        with pytest.raises(p.status.IOError_, match="partitioned: pull"):
            gate.check("pull")
    gate.heal()
    gate.check("pull")
    obs += [gate.blocked, gate.engaged]


SCENARIOS = [
    sc_frame_roundtrip,
    sc_frame_detects_truncation_and_bitflips,
    sc_shipper_serves_and_detects_retention_gone,
    sc_follower_shared_parity_and_epoch_reload,
    sc_follower_standalone_bootstrap_after_wal_gc,
    sc_router_read_your_writes_token,
    sc_router_breaker_skips_failing_follower,
    sc_router_max_lag_bound,
    sc_chaos_soak_shared,
    sc_chaos_soak_standalone,
    sc_background_tailing_with_concurrent_writes,
    sc_http_transport_and_replication_server,
    sc_sideplugin_replication_view_and_promote,
    sc_secondary_catchup_cf_created_and_dropped,
    sc_secondary_catchup_survives_wal_gc,
    sc_checkpoint_options_and_restore_refusal,
    sc_ship_fault_injector_is_seeded,
    sc_partition_gate_fails_fast,
]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__[3:] for f in SCENARIOS])
def test_replication_against_reference(tmp_path, monkeypatch,
                                       no_thread_leaks,  # noqa: F811
                                       scenario):
    # Frames carry time.time() as their ship stamp: pinned in both
    # shippers, so equal WALs give equal frame bytes.
    for m in (ref_ls, ls):
        monkeypatch.setattr(m, "time", _PinnedTime())
    seen = {}
    for name in ("ref", "port"):
        obs = []
        d = str(tmp_path / name)
        os.makedirs(d)
        scenario(Pkg(name == "ref"), d, obs)
        seen[name] = obs
    assert seen["port"] == seen["ref"]


# ---------------------------------------------------------------------------
# The port alone
# ---------------------------------------------------------------------------


def test_follower_runs_no_compaction_and_reads_device_tables(
        tmp_path, no_thread_leaks):  # noqa: F811
    """A follower's options come back with auto compactions off and it has
    no scheduler; the tables it reads are the ones the primary's device
    executor wrote (the kernels' plain versions here, the card on the
    card)."""
    p = Pkg(False)
    src = str(tmp_path / "db")
    db = dbm.DB.open(src, p.opts(disable_auto_compactions=True))
    fol = repl.FollowerDB.open(src, Options(), transport=repl.LocalTransport(
        repl.LogShipper(db)), mode="shared")
    try:
        assert fol.options.disable_auto_compactions and fol.options.read_only
        assert fol._compaction_scheduler is None
        for r in range(3):
            for i in range(300):
                db.put(b"k%05d" % (i * 3 + r), b"v%d" % r)
            db.flush()
        db.compact_range()
        jobs = db._compaction_scheduler.num_local_jobs
        for _ in range(3):
            fol.catch_up()
        assert dump(fol) == dump(db)
        levels = [len(x) for x in fol.versions.current.files]
        assert levels == [len(x) for x in db.versions.current.files]
        assert sum(levels[1:]) >= 1 and levels[0] == 0
        assert jobs == 0  # every job ran on the device executor
        with pytest.raises(status.NotSupported):
            fol.compact_range()
        with pytest.raises(ValueError):
            repl.FollowerDB.open(src, mode="both")
    finally:
        fol.close()
        db.close()


def test_promote_of_a_primary_answers_400(tmp_path,
                                          no_thread_leaks):  # noqa: F811
    repo = SidePluginRepo()
    repo.open_db({"path": str(tmp_path / "db"), "options": {
        "create_if_missing": True, "compaction_executor_factory": CPU}},
        name="d")
    port = repo.start_http()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            http_json(f"http://127.0.0.1:{port}/promote/d", {})
        assert ei.value.code == 400
        assert "not a follower" in json.loads(ei.value.read())["error"]
    finally:
        repo.close_all()
