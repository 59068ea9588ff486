"""The op trace of toplingdb_tpu_torch (utils/trace.py, tools/
trace_analyzer.py and DB.start_trace / end_trace) against toplingdb_tpu's,
on the CPU.

- A scripted workload of every op kind (puts, deletes, single deletes,
  merges, range deletes, batches, entities, gets, key_exists, get_entity,
  multi_get, get_async, multi_get_async, iterator seeks both ways, a
  tailing iterator) runs through both packages' DBs, each recording a
  trace. The two files give equal (op, payload) sequences under either
  package's read_trace; both analyzers give equal dicts on either file;
  a trace of one package replayed into the other's DB leaves scans equal
  to the source DB's.
- Every record is taken before a native chain decides the op: with every
  plane on (the native group commit, the native get chain, the native
  multiget, the chunked scan plane, and the trie memtable's branch) the
  count of records of each kind equals the calls made, and a traced fill
  keeps its native commits (WRITE_GROUP_NATIVE_COMMITS = WRITE_GROUP_LED).
- The reference's own cases, tests/test_tools_extra.py:113-210 (records
  everything, sampling and the size cap, timing-faithful replay), on the
  port; the analyzer's CLI and its key-count files.

Tolerance: none (bytes and counts equal).
"""

import json
import os
import subprocess
import sys
import time
import types

import pytest

import toplingdb_tpu.db.db as ref_dbm
import toplingdb_tpu.options as ref_opts
from toplingdb_tpu.db.write_batch import WriteBatch as RefWriteBatch
from toplingdb_tpu.env import default_env as ref_default_env
from toplingdb_tpu.tools import trace_analyzer as ref_analyzer
from toplingdb_tpu.utils import merge_operator as ref_mo
from toplingdb_tpu.utils import trace as ref_trace

import toplingdb_tpu_torch.db.db as dbm
import toplingdb_tpu_torch.options as opts_mod
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory,
)
from toplingdb_tpu_torch.db.write_batch import WriteBatch
from toplingdb_tpu_torch.env import default_env
from toplingdb_tpu_torch.tools import trace_analyzer
from toplingdb_tpu_torch.utils import merge_operator as mo
from toplingdb_tpu_torch.utils import statistics as st
from toplingdb_tpu_torch.utils import trace
from toplingdb_tpu_torch.utils.status import InvalidArgument

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REF = types.SimpleNamespace(
    name="ref", DB=ref_dbm.DB, Options=ref_opts.Options,
    ReadOptions=ref_opts.ReadOptions, WriteBatch=RefWriteBatch,
    mo=ref_mo, trace=ref_trace, env=ref_default_env, analyzer=ref_analyzer)
PORT = types.SimpleNamespace(
    name="port", DB=dbm.DB, Options=opts_mod.Options,
    ReadOptions=opts_mod.ReadOptions, WriteBatch=WriteBatch,
    mo=mo, trace=trace, env=default_env, analyzer=trace_analyzer)


def _opts(p, **kw):
    kw.setdefault("create_if_missing", True)
    kw.setdefault("merge_operator", p.mo.StringAppendOperator())
    kw.setdefault("disable_auto_compactions", True)
    if p is PORT:
        kw.setdefault("compaction_executor_factory",
                      DeviceCompactionExecutorFactory(device="cpu"))
    return p.Options(**kw)


def _workload(p, db, rng_seed=7):
    """Every op kind the op trace records, in a fixed order."""
    import random

    rng = random.Random(rng_seed)
    for i in range(300):
        db.put(b"k%04d" % i, b"v%d-" % i + bytes([65 + i % 26]) * (i % 17))
    db.delete(b"k0007")
    db.single_delete(b"k0008")
    db.merge(b"k0009", b"m1")
    db.merge(b"m-only", b"m2")
    db.delete_range(b"k0100", b"k0110")
    b = p.WriteBatch()
    b.put(b"batch-a", b"1")
    b.delete(b"k0011")
    b.merge(b"k0012", b"x")
    db.write(b)
    db.put_entity(b"ent", {b"": b"dflt", b"c1": b"one"})
    db.flush()
    for i in range(300, 340):
        db.put(b"k%04d" % i, b"late%d" % i)
    keys = [b"k%04d" % rng.randrange(360) for _ in range(40)]
    out = []
    for k in keys[:20]:
        out.append(db.get(k))
    out.append(db.key_exists(b"k0001"))
    out.append(db.get_entity(b"ent"))
    out.append(db.multi_get(keys[20:]))
    out.append(db.get_async(b"k0005").result())
    out.append(db.multi_get_async([b"k0006", b"nope"]).result())
    it = db.new_iterator()
    it.seek(b"k0050")
    for _ in range(5):
        out.append((it.key(), it.value()))
        it.next()
    it.seek_for_prev(b"k0105")
    out.append((it.key(), it.value()))
    tail = db.new_iterator(p.ReadOptions(tailing=True))
    tail.seek(b"k0330")
    out.append(tail.key() if tail.valid() else None)
    return out


def _scan(db):
    it = db.new_iterator()
    it.seek_to_first()
    rows = []
    while it.valid():
        rows.append((it.key(), it.value()))
        it.next()
    return rows


def _record(p, root):
    """Run the workload on `p`'s DB with a trace on; returns (trace path,
    the workload's reads, the DB's scan)."""
    path = os.path.join(root, p.name)
    tpath = os.path.join(root, p.name + ".trace")
    with p.DB.open(path, _opts(p)) as db:
        db.start_trace(tpath)
        reads = _workload(p, db)
        db.end_trace()
        db.put(b"untraced", b"x")
        db.delete(b"untraced")
        scan = _scan(db)
    return tpath, reads, scan


def _ops(p, tpath):
    return [(op, [bytes(s) for s in slices])
            for op, _ts, slices in p.trace.read_trace(p.env(), tpath)]


def test_trace_files_read_alike_and_replay_across(tmp_path):
    root = str(tmp_path)
    tref, reads_ref, scan_ref = _record(REF, root)
    tport, reads_port, scan_port = _record(PORT, root)
    assert reads_port == reads_ref
    assert scan_port == scan_ref
    seqs = {(reader.name, f): _ops(reader, t)
            for reader in (REF, PORT) for f, t in (("ref", tref),
                                                   ("port", tport))}
    first = seqs[("ref", "ref")]
    assert len(first) > 80
    for key, seq in seqs.items():
        assert seq == first, key
    kinds = {op for op, _ in first}
    assert kinds == {trace.OP_WRITE_BATCH, trace.OP_GET, trace.OP_MULTIGET,
                     trace.OP_ITER_SEEK, trace.OP_ITER_SEEK_FOR_PREV}
    # The analyzers give equal dicts on either file.
    for t in (tref, tport):
        a_ref = REF.analyzer.analyze(REF.env(), t, top_k=5)
        a_port = PORT.analyzer.analyze(PORT.env(), t, top_k=5)
        assert a_port == a_ref
        assert trace.analyze_trace(default_env(), t) == \
            ref_trace.analyze_trace(ref_default_env(), t)
        assert sum(a_port["per_op"].values()) == len(first)
    # A trace replayed into the other package's DB leaves equal scans.
    for src, dst, t in ((REF, PORT, tref), (PORT, REF, tport)):
        with dst.DB.open(os.path.join(root, f"replay-{dst.name}"),
                         _opts(dst)) as db:
            n = dst.trace.Replayer(db, t).replay(fast_forward=True)
            assert n == len(first)
            assert _scan(db) == scan_ref, (src.name, dst.name)


def test_every_op_recorded_once_with_every_plane_on(tmp_path):
    """Every plane on (the port's defaults on the cspp trie memtable):
    the records of each kind equal the calls made, the gets were decided
    natively, the scan went through the chunk plane, and every fill group
    stayed a native commit."""
    stats = st.Statistics()
    tpath = str(tmp_path / "t.trace")
    n_put, n_get, n_mg, n_seek = 2000, 500, 40, 30
    with dbm.DB.open(str(tmp_path / "db"), _opts(
            PORT, statistics=stats, memtable_rep="cspp",
            merge_operator=None)) as db:
        decided = {"get": 0, "multiget": 0}
        native_get, native_mg = db._native_get, db._native_multi_get

        def spy_get(*a, **kw):
            out = native_get(*a, **kw)
            decided["get"] += bool(out[0])
            return out

        def spy_mg(*a, **kw):
            out = native_mg(*a, **kw)
            decided["multiget"] += bool(out[0])
            return out

        db._native_get, db._native_multi_get = spy_get, spy_mg
        db.start_trace(tpath)
        for i in range(0, n_put, 100):
            b = WriteBatch()
            for j in range(i, i + 100):
                b.put(b"key%08d" % j, b"val%08d" % j)
            db.write(b)
        db.flush()
        for i in range(n_get):
            assert db.get(b"key%08d" % (i * 3 % n_put)) is not None
        for i in range(n_mg):
            db.multi_get([b"key%08d" % (i * 7 + j) for j in range(32)])
        for i in range(n_seek):
            it = db.new_iterator()
            it.seek(b"key%08d" % (i * 50))
            for _ in range(10):
                it.next()
        db.end_trace()
        t = stats.tickers()
    per = trace_analyzer.analyze(default_env(), tpath)["per_op"]
    assert per == {"write_batch": n_put // 100, "get": n_get,
                   "multiget": n_mg, "iter_seek": n_seek}
    assert t[st.WRITE_GROUP_NATIVE_COMMITS] == t[st.WRITE_GROUP_LED] > 0
    assert t.get(st.WRITE_GROUP_FALLBACKS, 0) == 0
    assert t.get(st.ITER_CHUNK_FALLBACKS, 0) == 0
    assert t.get(st.ITER_CHUNK_REFILLS, 0) > 0
    assert decided == {"get": n_get, "multiget": n_mg}


def test_no_trace_costs_one_check_and_records_nothing(tmp_path):
    with dbm.DB.open(str(tmp_path / "db"), _opts(PORT)) as db:
        assert db._op_tracer is None
        db.put(b"a", b"1")
        db.start_trace(str(tmp_path / "t"))
        with pytest.raises(InvalidArgument):
            db.start_trace(str(tmp_path / "t2"))
        db.end_trace()
        db.end_trace()  # a second end is a no-op
        assert db._op_tracer is None
    assert list(trace.read_trace(default_env(), str(tmp_path / "t"))) == []


# ---------------------------------------------------------------------------
# tests/test_tools_extra.py:113-210 on the port
# ---------------------------------------------------------------------------


def test_db_start_trace_records_everything(tmp_path):                # :113
    src = str(tmp_path / "src")
    tpath = str(tmp_path / "ops.trace")
    with dbm.DB.open(src, _opts(PORT)) as db:
        db.start_trace(tpath)
        for i in range(200):
            db.put(b"k%04d" % i, b"v%d" % i)
        db.delete(b"k0007")
        db.get(b"k0005")
        db.multi_get([b"k0001", b"k0002"])
        it = db.new_iterator()
        it.seek(b"k0100")
        assert it.valid() and it.key() == b"k0100"
        db.end_trace()
        db.put(b"untraced", b"x")
    ops = list(trace.read_trace(default_env(), tpath))
    kinds = [op for op, _, _ in ops]
    assert kinds.count(trace.OP_WRITE_BATCH) == 201
    assert trace.OP_GET in kinds and trace.OP_MULTIGET in kinds
    assert trace.OP_ITER_SEEK in kinds
    assert not any(s and s[0] == b"untraced" for _, _, s in ops)
    with dbm.DB.open(str(tmp_path / "dst"), _opts(PORT)) as db2:
        n = trace.Replayer(db2, tpath).replay()
        assert n == len(ops)
        assert db2.get(b"k0005") == b"v5"
        assert db2.get(b"k0007") is None
        assert db2.get(b"untraced") is None


def test_trace_sampling_and_size_cap(tmp_path):                      # :155
    tpath = str(tmp_path / "s.trace")
    with dbm.DB.open(str(tmp_path / "db"), _opts(PORT)) as db:
        db.start_trace(tpath, trace.TraceOptions(sampling_frequency=10))
        for i in range(500):
            db.get(b"k%d" % i)
        db.end_trace()
    assert len(list(trace.read_trace(default_env(), tpath))) == 50
    cap = str(tmp_path / "cap.trace")
    with dbm.DB.open(str(tmp_path / "db2"), _opts(PORT)) as db:
        db.start_trace(cap, trace.TraceOptions(max_trace_file_size=2000))
        for i in range(5000):
            db.get(b"key%06d" % i)
        assert db._op_tracer.stopped
        db.end_trace()
    assert os.path.getsize(cap) <= 4096


def test_replay_timing_faithful_speedup(tmp_path):                   # :183
    tpath = str(tmp_path / "t.trace")
    with dbm.DB.open(str(tmp_path / "db"), _opts(PORT)) as db:
        db.start_trace(tpath)
        db.put(b"a", b"1")
        time.sleep(0.3)
        db.put(b"b", b"2")
        db.end_trace()
    with dbm.DB.open(str(tmp_path / "dst"), _opts(PORT)) as db2:
        t0 = time.time()
        trace.Replayer(db2, tpath).replay(fast_forward=False, speedup=10.0)
        assert time.time() - t0 < 0.25
        t0 = time.time()
        trace.Replayer(db2, tpath).replay(fast_forward=False, speedup=1.0)
        assert time.time() - t0 >= 0.25
        assert db2.get(b"b") == b"2"


def test_multithreaded_replay_and_wrapper_tracer(tmp_path):
    """Lookups fan out over a pool while writes stay ordered; the wrapper
    Tracer's file reads alike in both packages."""
    tpath = str(tmp_path / "w.trace")
    with dbm.DB.open(str(tmp_path / "db"), _opts(PORT)) as db:
        tr = trace.Tracer(db, tpath)
        for i in range(50):
            tr.put(b"w%03d" % i, b"%d" % i)
            tr.get(b"w%03d" % i)
        tr.merge(b"w001", b"+")
        tr.delete(b"w002")
        tr.delete_range(b"w010", b"w020")
        tr.close()
    assert _ops(PORT, tpath) == _ops(REF, tpath)
    with dbm.DB.open(str(tmp_path / "dst"), _opts(PORT)) as db2:
        assert trace.Replayer(db2, tpath).replay(threads=4) == 103
        assert db2.get(b"w001") == b"1,+"
        assert db2.get(b"w002") is None and db2.get(b"w015") is None
        assert db2.get(b"w049") == b"49"


def test_analyzer_cli_and_key_count_files(tmp_path):
    tpath = str(tmp_path / "a.trace")
    with dbm.DB.open(str(tmp_path / "db"), _opts(PORT)) as db:
        db.start_trace(tpath)
        for i in range(30):
            db.put(b"h%02d" % (i % 3), b"v")
            db.get(b"h00")
        db.end_trace()
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "toplingdb_tpu_torch.tools.trace_analyzer",
         tpath, "--json", "-k", "2", "--output-dir", str(tmp_path / "kc")],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout)
    assert rep == ref_analyzer.analyze(ref_default_env(), tpath, top_k=2)
    assert rep["per_op"] == {"write_batch": 30, "get": 30}
    assert rep["hottest_keys"][0] == {"key": "h00", "count": 30}
    assert sorted(os.listdir(tmp_path / "kc")) == [
        "get-key_counts.txt", "write_batch-key_counts.txt"]
    with open(tmp_path / "kc" / "get-key_counts.txt") as f:
        assert f.read() == "683030 30\n"
    text = subprocess.run(
        [sys.executable, "-m", "toplingdb_tpu_torch.tools.trace_analyzer",
         tpath], capture_output=True, text=True, env=env, timeout=120)
    assert text.returncode == 0 and "total ops        60" in text.stdout
