"""The wrapper Envs, the fault-injection additions and the CUDA probe of
toplingdb_tpu_torch against toplingdb_tpu's, on the CPU.

- OverlayEnv: tests/test_utilities.py:1053 on both packages (reads fall
  through, writes land in the overlay, whiteouts, copy-up) and :1097 (a DB
  opened through it leaves the base dir untouched), and the dcompact
  worker running a job whose inputs it reads through an overlay;
- RemapEnv: paths translated by the longest prefix, a DB opened through a
  remapped mount;
- EncryptedEnv: :1380 on both packages, the on-disk bytes of a file equal
  the reference's for the same key and plaintext, no plaintext key on disk
  after a compaction on the device executor ("cpu"), and every get of a DB
  over it decided on the Python chain;
- IOTracingEnv: :1126 on both packages; the records equal apart from
  their times, and the parser's aggregates;
- FaultInjectionEnv: :539 on both packages (drop unsynced, deactivate,
  reactivate and truncate), per-op failures and io_counts;
- the CUDA probe on a machine without a card: it raises with the child's
  evidence and never redirects to the CPU.

Tolerance: none.
"""

import json
import os
import random

import pytest

import toplingdb_tpu.db.db as ref_dbm
from toplingdb_tpu import env as ref_env
from toplingdb_tpu.env import encrypted as ref_enc
from toplingdb_tpu.env import fault_injection as ref_fi
from toplingdb_tpu.env import io_tracer as ref_iot
from toplingdb_tpu.env import overlay as ref_overlay
from toplingdb_tpu.env import remap as ref_remap
from toplingdb_tpu.options import Options as RefOptions
from toplingdb_tpu.options import WriteOptions as RefWriteOptions
from toplingdb_tpu.tools import io_tracer_parser as ref_parser
from toplingdb_tpu.utils import status as ref_status

import toplingdb_tpu_torch.db.db as dbm
from toplingdb_tpu_torch import env as port_env
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory,
)
from toplingdb_tpu_torch.env import encrypted as enc
from toplingdb_tpu_torch.env import fault_injection as fi
from toplingdb_tpu_torch.env import io_tracer as iot
from toplingdb_tpu_torch.env import overlay
from toplingdb_tpu_torch.env import remap
from toplingdb_tpu_torch.options import Options, WriteOptions
from toplingdb_tpu_torch.tools import io_tracer_parser as parser
from toplingdb_tpu_torch.utils import status


class Side:
    def __init__(self, ref: bool):
        self.ref = ref
        self.DB = ref_dbm.DB if ref else dbm.DB
        self.env = ref_env if ref else port_env
        self.enc = ref_enc if ref else enc
        self.fi = ref_fi if ref else fi
        self.iot = ref_iot if ref else iot
        self.overlay = ref_overlay if ref else overlay
        self.remap = ref_remap if ref else remap
        self.WriteOptions = RefWriteOptions if ref else WriteOptions
        self.status = ref_status if ref else status

    def options(self, **kw):
        kw.setdefault("write_buffer_size", 16 * 1024)
        if self.ref:
            return RefOptions(**kw)
        return Options(compaction_executor_factory=(
            DeviceCompactionExecutorFactory(device="cpu")), **kw)

    def raises(self, obs, exc_name, fn, *a, **kw):
        exc = getattr(self.status, exc_name)
        with pytest.raises(exc) as ei:
            fn(*a, **kw)
        obs.append(("raised", type(ei.value).__name__))


def both(scenario, tmp_path):
    seen = {}
    for name in ("ref", "port"):
        d = str(tmp_path / name)
        os.makedirs(d)
        obs = []
        scenario(Side(name == "ref"), d, obs)
        seen[name] = obs
    assert seen["port"] == seen["ref"]
    return seen["port"]


def scan(db):
    it = db.new_iterator()
    it.seek_to_first()
    return list(it.entries())


# -- overlay and remap --------------------------------------------------------


def sc_overlay_env(s, d, obs):                      # test_utilities:1053
    base = s.env.MemEnv()
    base.create_dir("/db")
    base.write_file("/db/000010.sst", b"BASE-SST")
    base.write_file("/db/CURRENT", b"MANIFEST-000002\n")
    over = s.env.MemEnv()
    over.create_dir("/db")
    e = s.overlay.OverlayEnv(base, over)
    obs.append(e.read_file("/db/000010.sst"))
    e.write_file("/db/000020.sst", b"NEW-SST")
    obs.append((e.read_file("/db/000020.sst"),
                base.file_exists("/db/000020.sst")))
    obs.append(sorted(e.get_children("/db")))
    e.write_file("/db/CURRENT", b"MANIFEST-000009\n")
    obs.append((e.read_file("/db/CURRENT"), base.read_file("/db/CURRENT")))
    e.delete_file("/db/000010.sst")
    obs.append((e.file_exists("/db/000010.sst"),
                base.file_exists("/db/000010.sst")))
    s.raises(obs, "NotFound", e.read_file, "/db/000010.sst")
    s.raises(obs, "NotFound", e.get_file_size, "/db/000010.sst")
    s.raises(obs, "NotFound", e.delete_file, "/db/nope")
    obs.append(e.get_children("/db"))
    base.write_file("/db/000011.sst", b"B11")
    e.rename_file("/db/000011.sst", "/db/000030.sst")
    obs.append((e.read_file("/db/000030.sst"),
                e.file_exists("/db/000011.sst"),
                base.file_exists("/db/000011.sst")))
    s.raises(obs, "NotFound", e.rename_file, "/db/000011.sst", "/db/x")
    e.write_file("/db/000010.sst", b"AGAIN")     # a write lifts the whiteout
    obs.append(e.read_file("/db/000010.sst"))
    f = e.new_random_access_file("/db/000030.sst")
    obs.append((f.read(1, 2), f.size(), e.get_file_size("/db/000030.sst")))
    assert obs[0] == b"BASE-SST"
    assert obs[2] == ["000010.sst", "000020.sst", "CURRENT"]


def sc_overlay_db(s, d, obs):                       # test_utilities:1097
    src = f"{d}/primary"
    with s.DB.open(src, s.options()) as db:
        for i in range(300):
            db.put(b"k%04d" % i, b"v%04d" % i)
        db.flush()
    before = sorted(os.listdir(src))
    over = s.env.MemEnv()
    over.create_dir(src)
    e = s.overlay.OverlayEnv(s.env.PosixEnv(), over)
    db2 = s.DB.open(src, s.options(), env=e)
    obs.append(db2.get(b"k0123"))
    db2.put(b"extra", b"x")
    db2.flush()
    db2.compact_range()
    obs.append((db2.get(b"extra"), len(scan(db2))))
    db2.close()
    obs.append(sorted(os.listdir(src)) == before)
    assert obs == [b"v0123", (b"x", 301), True]


def sc_remap_db(s, d, obs):
    """A DB recorded at one path, opened through a remapped mount."""
    real = f"{d}/mnt/nfs/db"
    e = s.remap.RemapEnv(s.env.PosixEnv(), {"/data/db/": f"{d}/mnt/nfs/db",
                                            "/data": f"{d}/elsewhere"})
    obs.append((os.path.relpath(e.remap("/data/db"), d),
                os.path.relpath(e.remap("/data/db/x"), d),
                os.path.relpath(e.remap("/data/other"), d),
                e.remap("/dataX"), e.remap("/tmp/y")))
    with s.DB.open("/data/db", s.options(), env=e) as db:
        for i in range(400):
            db.put(b"r%04d" % i, b"v" * 20)
        db.flush()
        db.compact_range()
        obs.append(len(scan(db)))
        obs.append((e.file_exists("/data/db/CURRENT"),
                    e.get_file_size("/data/db/CURRENT") > 0,
                    e.get_free_space("/data/db") > 0,
                    e.now_micros() > 0))
    obs.append(os.path.exists(os.path.join(real, "CURRENT")))
    with s.DB.open(real, s.options()) as db:
        obs.append(db.get(b"r0399"))
    assert obs[0] == ("mnt/nfs/db", "mnt/nfs/db/x", "elsewhere/other",
                      "/dataX", "/tmp/y")
    assert obs[-1] == b"v" * 20


ENV_SCENARIOS = [sc_overlay_env, sc_overlay_db, sc_remap_db]


@pytest.mark.parametrize("scenario", ENV_SCENARIOS,
                         ids=[f.__name__[3:] for f in ENV_SCENARIOS])
def test_overlay_and_remap_match_reference(tmp_path, scenario):
    both(scenario, tmp_path)


def test_worker_reads_through_overlay(tmp_path):
    """The dcompact worker mount pattern: a job's inputs read through an
    OverlayEnv over the primary's dir, the outputs written into the
    overlay; the primary's dir is untouched and the entries equal the
    primary's own compaction."""
    from toplingdb_tpu_torch.compaction.compaction_job import (
        run_compaction_to_tables,
    )
    from toplingdb_tpu_torch.compaction.picker import Compaction
    from toplingdb_tpu_torch.db.db_readonly import ReadOnlyDB
    from toplingdb_tpu_torch.ops.device_compaction import (
        run_device_compaction,
    )

    s = Side(False)
    src = str(tmp_path / "primary")
    with dbm.DB.open(src, s.options(disable_auto_compactions=True)) as db:
        for i in range(3000):
            db.put(b"key%05d" % (i % 2000), b"val%06d" % i)
        db.flush()
    before = {f: os.path.getsize(os.path.join(src, f))
              for f in os.listdir(src)}
    over = port_env.MemEnv()
    over.create_dir(src)
    e = overlay.OverlayEnv(port_env.PosixEnv(), over)
    ro = ReadOnlyDB.open(src, s.options(), env=e)
    files = [f for lvl in ro.versions.cf_current(0).files for f in lvl]
    comp = Compaction(level=0, output_level=1, inputs=files,
                      bottommost=True, max_output_file_size=1 << 62)
    counter = [100]

    def alloc():
        counter[0] += 1
        return counter[0]

    outs = {}
    for tag, fn, kw in (
            ("device", run_device_compaction, dict(device_name="cpu")),
            ("host", run_compaction_to_tables, {})):
        o, _stats = fn(e, src, ro.icmp, comp, ro.table_cache,
                       ro.options.table_options, [], new_file_number=alloc,
                       creation_time=1, **kw)
        rows = []
        for m in o:
            from toplingdb_tpu_torch.table.factory import open_table

            path = f"{src}/{m.number:06d}.sst"
            it = open_table(e.new_random_access_file(path),
                            ro.icmp).new_iterator()
            it.seek_to_first()
            rows.extend(it.entries())
            assert over.file_exists(path)
        outs[tag] = rows
    ro.close()
    assert outs["device"] == outs["host"] and len(outs["host"]) == 2000
    assert {f: os.path.getsize(os.path.join(src, f))
            for f in os.listdir(src)} == before


# -- encryption -------------------------------------------------------------


def sc_encrypted_env(s, d, obs):                    # test_utilities:1380
    path = f"{d}/db"
    e = s.enc.EncryptedEnv(s.env.PosixEnv(), s.enc.CTRCipher(b"key-material-1"))
    db = s.DB.open(path, s.options(disable_auto_compactions=True), env=e)
    for i in range(500):
        db.put(b"secret%03d" % i, b"value%03d" % i)
    db.flush()
    db.compact_range()
    obs.append([db.get(b"secret%03d" % i) for i in range(0, 500, 7)])
    db.close()
    blob = b"".join(open(os.path.join(path, f), "rb").read()
                    for f in os.listdir(path)
                    if os.path.isfile(os.path.join(path, f)))
    obs.append(any(b"secret%03d" % i in blob for i in range(500)))
    db2 = s.DB.open(path, s.options(), env=s.enc.EncryptedEnv(
        s.env.PosixEnv(), s.enc.CTRCipher(b"key-material-1")))
    obs.append((db2.get(b"secret499"), len(scan(db2))))
    db2.close()
    s.raises(obs, "Corruption", s.DB.open, path, s.options(),
             env=s.enc.EncryptedEnv(s.env.PosixEnv(),
                                    s.enc.CTRCipher(b"WRONG")))
    assert obs[1:] == [False, (b"value499", 500), ("raised", "Corruption")]


def test_encrypted_env_matches_reference(tmp_path):
    both(sc_encrypted_env, tmp_path)


def test_encrypted_bytes_equal_reference(tmp_path):
    """The same key and plaintext give the same ciphertext on disk, through
    a writable appended in uneven pieces, write_file and a sequential
    read; the keystream equals the reference's at every offset."""
    rng = random.Random(5)
    for klen in (0, 1, 7, 8, 14, 31, 32, 33, 70):
        key = bytes(rng.randrange(256) for _ in range(klen))
        a, b = ref_enc.CTRCipher(key), enc.CTRCipher(key)
        for off, n in ((0, 1), (3, 29), (8, 64), (1001, 4000)):
            assert b.keystream(off, n) == a.keystream(off, n)
    plain = bytes(rng.randrange(256) for _ in range(20_000))
    files = {}
    for name, side in (("ref", Side(True)), ("port", Side(False))):
        e = side.enc.EncryptedEnv(side.env.PosixEnv(),
                                  side.enc.CTRCipher(b"k3y"))
        p1 = str(tmp_path / f"{name}.w")
        f = e.new_writable_file(p1)
        pos = 0
        for cut in (1, 7, 100, 4096, 9000):
            f.append(plain[pos:pos + cut])
            pos += cut
        f.append(plain[pos:])
        f.sync()
        f.close()
        p2 = str(tmp_path / f"{name}.f")
        e.write_file(p2, plain)
        sq = e.new_sequential_file(p1)
        back = sq.read(5) + sq.read(30_000)
        sq.close()
        ra = e.new_random_access_file(p1)
        files[name] = (open(p1, "rb").read(), open(p2, "rb").read(), back,
                       ra.read(777, 3333), ra.size(), e.read_file(p2))
        ra.close()
    assert files["port"] == files["ref"]
    assert files["port"][2] == plain and files["port"][0] != plain


def test_encrypted_db_reads_on_the_python_chain(tmp_path):
    """Over EncryptedEnv the native point read never touches a table's raw
    fd: every get of a compacted DB (its compaction on the device
    executor) is answered, each by the Python chain; no plaintext key
    reaches the disk."""
    from toplingdb_tpu_torch import native

    s = Side(False)
    path = str(tmp_path / "db")
    e = enc.EncryptedEnv(port_env.PosixEnv(), enc.CTRCipher(b"k"))
    db = dbm.DB.open(path, s.options(disable_auto_compactions=True), env=e)
    want = {}
    for i in range(2000):
        k = b"enc%05d" % ((i * 7919) % 2000)
        want[k] = b"val%05d" % i
        db.put(k, want[k])
    db.flush()
    db.compact_range()
    handled = []
    real = db._native_get

    def spy(*a, **k):
        out = real(*a, **k)
        handled.append(out[0])
        return out

    db._native_get = spy
    assert all(db.get(k) == v for k, v in want.items())
    if native.lib() is not None:
        assert handled and not any(handled), "a get read a raw fd"
    assert scan(db) == sorted(want.items())
    db.close()
    blob = b"".join(open(os.path.join(path, f), "rb").read()
                    for f in os.listdir(path)
                    if os.path.isfile(os.path.join(path, f)))
    assert not any(k in blob for k in want)


# -- the IO tracer ----------------------------------------------------------


def sc_io_tracing_env(s, d, obs):                   # test_utilities:1126
    trace = f"{d}/io.trace"
    tracer = s.iot.IOTracer(trace)
    e = s.iot.IOTracingEnv(s.env.PosixEnv(), tracer)
    path = f"{d}/db"
    # One explicit flush: a flush on memory use cuts where the skiplist's
    # process-wide height draws put it, which differ between packages.
    with s.DB.open(path, s.options(write_buffer_size=1 << 20), env=e) as db:
        for i in range(200):
            db.put(b"k%04d" % i, b"v" * 50)
        db.flush()
        obs.append(db.get(b"k0100"))
    e.write_file(f"{d}/x", b"abc")
    obs.append(e.read_file(f"{d}/x"))
    e.rename_file(f"{d}/x", f"{d}/y")
    e.delete_file(f"{d}/y")
    tracer.close()
    agg = s.iot.parse_io_trace(trace)
    obs.append(agg["append"]["count"] > 0 and agg["append"]["bytes"] > 0)
    obs.append(("sync" in agg, "read" in agg, agg["read"]["bytes"] > 0))
    recs = [json.loads(line) for line in open(trace)]
    obs.append([(r["op"], os.path.relpath(r["path"], d), r["offset"],
                 r["len"]) for r in recs
                if r["op"] not in ("read", "open_random")])
    assert obs[0] == b"v" * 50 and obs[1] == b"abc"


def test_io_tracer_records_match_reference(tmp_path):
    """The op, path, offset and length of every record (times aside) are
    the reference's, for the same DB run, apart from the reads (the port's
    native chains read fewer blocks); the parser CLI reads both traces."""
    both(sc_io_tracing_env, tmp_path)
    for name, mod in (("ref", ref_parser), ("port", parser)):
        trace = str(tmp_path / name / "io.trace")
        rep = mod.parse(trace)
        assert rep["total_records"] == sum(
            1 for line in open(trace) if line.strip())
        assert set(rep["per_op"]) >= {"append", "sync", "new_writable"}
    assert parser.main([str(tmp_path / "port" / "io.trace"), "--json"]) == 0


# -- fault injection ----------------------------------------------------------


def sc_fault_injection_env(s, d, obs):              # test_utilities:539
    fenv = s.fi.FaultInjectionEnv(s.env.PosixEnv())
    src = f"{d}/db"
    db = s.DB.open(src, s.options(), env=fenv)
    db.put(b"synced", b"1", s.WriteOptions(sync=True))
    db.put(b"unsynced", b"2")
    fenv.drop_unsynced_and_deactivate()
    s.raises(obs, "IOError_", db.put, b"x", b"y", s.WriteOptions(sync=True))
    db._closed = True
    db._compaction_scheduler.shutdown()
    fenv.reactivate_and_truncate()
    db2 = s.DB.open(src, s.options(), env=fenv)
    obs.append((db2.get(b"synced"), db2.get(b"unsynced")))
    db2.close()
    obs.append(fenv.io_counts.get("append", 0) > 0)
    # Per-op failures and the op budget.
    f2 = s.fi.FaultInjectionEnv(s.env.PosixEnv())
    f2.write_file(f"{d}/a", b"123", sync=True)
    f2.fail_ops = {"sync"}
    s.raises(obs, "IOError_", f2.write_file, f"{d}/b", b"4", sync=True)
    f2.fail_ops = set()
    obs.append(f2.read_file(f"{d}/a"))
    f2.fail_after_ops = f2.op_count + 2
    f2.rename_file(f"{d}/a", f"{d}/c")
    f2.delete_file(f"{d}/c")
    s.raises(obs, "IOError_", f2.read_file, f"{d}/b")
    obs.append(sorted(f2.io_counts.items()))
    assert obs[1] == (b"1", None)


def test_fault_injection_env_matches_reference(tmp_path):
    both(sc_fault_injection_env, tmp_path)


def test_fault_injection_counts_equal_reference(tmp_path):
    """The same DB run over both packages' FaultInjectionEnv counts the same
    opens, appends, syncs, renames and deletes (reads differ: the port's
    DB reads through fewer handles)."""
    counts = {}
    for name, side in (("ref", Side(True)), ("port", Side(False))):
        fenv = side.fi.FaultInjectionEnv(side.env.PosixEnv())
        path = str(tmp_path / name / "db")
        db = side.DB.open(path, side.options(write_buffer_size=1 << 20),
                          env=fenv)
        for i in range(300):
            db.put(b"f%04d" % i, b"v" * 30, side.WriteOptions(sync=i % 50 == 0))
        db.flush()
        db.close()
        counts[name] = {k: v for k, v in fenv.io_counts.items()
                        if k in ("open_w", "rename", "delete")}
    assert counts["port"] == counts["ref"]


# -- the CUDA probe -----------------------------------------------------------


def test_backend_probe_raises_with_evidence_without_a_card():
    import torch

    from toplingdb_tpu_torch.utils import backend_probe as bp

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    before = dict(os.environ)
    diags = []
    with pytest.raises(bp.BackendUnreachable) as ei:
        bp.ensure_reachable_backend(timeout_s=60.0, attempts=2,
                                    backoff_s=0.0, diagnostics=diags)
    assert [d["attempt"] for d in diags] == [1, 2]
    assert ei.value.diagnostics is diags
    assert all(d["ok"] is False and d["rc"] not in (0, None) for d in diags)
    assert "probe: import torch ok" in diags[0]["stderr_tail"]
    assert "probe: cuda init ok" not in diags[0]["stderr_tail"]
    assert dict(os.environ) == before          # nothing redirected
    assert not hasattr(bp, "redirect_to_cpu_backend")
    assert not hasattr(bp, "retry_redirect")


def test_backend_probe_kills_a_hung_child(monkeypatch):
    """A child that hangs is killed at the timeout with its faulthandler
    stack as the evidence."""
    from toplingdb_tpu_torch.utils import backend_probe as bp

    monkeypatch.setattr(bp, "_CHILD_GRACE_S", 1.0)
    monkeypatch.setattr(bp, "_PROBE_SRC", (
        "import faulthandler, sys, time\n"
        "faulthandler.dump_traceback_later(float(sys.argv[1]), exit=True)\n"
        "time.sleep(60)\n"))
    ok, diag = bp.probe_cuda_backend(3.0)
    assert ok is False and diag["rc"] != 0
    assert "time.sleep" in diag["stderr_tail"] or "Thread" in \
        diag["stderr_tail"]
