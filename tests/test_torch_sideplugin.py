"""The SidePlugin layer of toplingdb_tpu_torch (utils/config.py: the
ObjectRegistry, options_from_config / options_to_config, persist_options /
load_latest_options, SidePluginRepo with its HTTP views) against
toplingdb_tpu's single-DB half, on the CPU.

- Config: options_from_config then options_to_config give equal JSON in
  both packages for the same configs; a DB's OPTIONS file is the same
  bytes; either package's load_latest_options reads the other's file.
- /metrics: for the same scripted DB state (both DBs on their default
  host planes, time frozen, no background job), the metric names and
  label sets are equal, and so is every count-valued sample: every
  counter apart from the time-valued and thread-order-valued tickers of
  tests/test_torch_statistics.py, every summary's _count, and the
  count-valued gauges.
- The cluster, fleet and shard half: each method raises NotSupported
  naming the missing plane; each route answers 501 with the same words.
- The "device" executor factory is the port's: "cuda" unless the spec
  names "cpu", no fallback.
- The reference's own cases on the port: tests/test_integrity.py:755,
  tests/test_telemetry.py:371, tests/test_write_plane.py:376,
  tests/test_statistics_breadth.py:166, tests/test_disk_pressure.py:595,
  and tests/test_health.py:399 without its cluster and fleet legs; the
  HTML views and online options; stop_http and close_all leave no thread.

Tolerance: none.
"""

import json
import os
import re
import time
import urllib.error
import urllib.request

import pytest

import toplingdb_tpu.db.db as ref_dbm
import toplingdb_tpu.options as ref_opts
from toplingdb_tpu.utils import config as ref_config
from toplingdb_tpu.utils import statistics as ref_st

import toplingdb_tpu_torch.db.db as dbm
import toplingdb_tpu_torch.options as opts_mod
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory,
)
from toplingdb_tpu_torch.options import Options
from toplingdb_tpu_torch.utils import concurrency as ccy
from toplingdb_tpu_torch.utils import config
from toplingdb_tpu_torch.utils import slo as slomod
from toplingdb_tpu_torch.utils import statistics as st
from toplingdb_tpu_torch.utils.config import (
    ObjectRegistry,
    SidePluginRepo,
    options_from_config,
    options_to_config,
)
from toplingdb_tpu_torch.utils.statistics import Statistics
from toplingdb_tpu_torch.utils.status import InvalidArgument, NotSupported

CPU = {"class": "device", "params": {"device_name": "cpu"}}
FROZEN_TIME = 1_700_000_000.0


@pytest.fixture
def no_thread_leaks():
    before = {id(t) for t in ccy.registry.live()}
    yield
    leaked = [t.name for t in ccy.registry.live() if id(t) not in before]
    assert not leaked, f"test leaked registered threads: {leaked}"


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers["Content-Type"], r.read()


def _get_json(url):
    return json.loads(_get(url)[2])


def _post(url, body=b"{}"):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


# ---------------------------------------------------------------------------
# Config parity
# ---------------------------------------------------------------------------

CONFIGS = {
    "plain": {"write_buffer_size": 1 << 20},
    "wide": {
        "write_buffer_size": 1 << 20, "compression": "zstd",
        "merge_operator": "uint64add", "comparator": "reverse_bytewise",
        "prefix_extractor": {"class": "fixed", "params": {"length": 4}},
        "table_options": {"block_size": 8192, "filter_policy": {
            "class": "bloom", "params": {"bits_per_key": 12}}},
        "slo_specs": [{"name": "g", "kind": "latency",
                       "threshold_usec": 5000}],
        "statistics": "default",
        "dcompact": {"max_attempts": 5, "job_deadline": 60.0},
        "trace_sample_every": 10, "histogram_window_sec": 30,
        "level0_slowdown_writes_trigger": 2, "slo_eval_period_sec": 1,
        "slo_window_sec": 2},
    "plugins": {
        "merge_operator": "stringappend",
        "compaction_filter": "remove_empty_value",
        "prefix_extractor": "noop", "comparator": "u64ts_bytewise",
        "table_options": {"filter_policy": None, "format": "block",
                          "index_type": "two_level"},
        "full_history_ts_low": 7, "enable_blob_files": True,
        "min_blob_size": 64, "protection_bytes_per_key": 8,
        "file_checksum": "crc32c", "unordered_write": True},
    "defaults_named": {"statistics": "default", "histogram_window_sec": 60.0,
                       "table_options": {"filter_policy": {
                           "class": "bloom", "params": {"bits_per_key": 10}}}},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_round_trip_matches_reference(name):
    cfg = CONFIGS[name]
    ref = ref_config.options_to_config(ref_config.options_from_config(cfg))
    port = options_to_config(options_from_config(cfg))
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)
    # and the round trip is a fixed point
    assert options_to_config(options_from_config(port)) == port


def test_unknown_option_and_factory_refused():
    with pytest.raises(InvalidArgument, match="unknown option"):
        options_from_config({"no_such_option": 1})
    with pytest.raises(InvalidArgument, match="no merge_operator factory"):
        options_from_config({"merge_operator": "nope"})
    assert "device" in ObjectRegistry.default().names(
        "compaction_executor_factory")


def test_options_file_bytes_and_cross_reads(tmp_path):
    cfg = CONFIGS["wide"]
    ref_o = ref_config.options_from_config(cfg)
    ref_o.create_if_missing = True
    ref_o.slo_eval_period_sec = 0
    port_o = options_from_config(cfg)
    port_o.create_if_missing = True
    port_o.slo_eval_period_sec = 0
    port_o.compaction_executor_factory = DeviceCompactionExecutorFactory(
        device="cpu")
    with ref_dbm.DB.open(str(tmp_path / "r"), ref_o):
        pass
    with dbm.DB.open(str(tmp_path / "p"), port_o):
        pass

    def opts_file(d):
        (n,) = [n for n in os.listdir(d) if n.startswith("OPTIONS-")]
        with open(os.path.join(d, n), "rb") as f:
            return f.read()

    assert opts_file(tmp_path / "p") == opts_file(tmp_path / "r")
    a = config.load_latest_options(str(tmp_path / "r"))
    b = ref_config.load_latest_options(str(tmp_path / "p"))
    assert options_to_config(a) == ref_config.options_to_config(b)
    os.makedirs(tmp_path / "none")
    assert config.load_latest_options(str(tmp_path / "none")) is None


# ---------------------------------------------------------------------------
# The device factory and the left-out half
# ---------------------------------------------------------------------------


def test_device_factory_is_the_port_s_on_cuda():
    reg = ObjectRegistry.default()
    f = reg.create("compaction_executor_factory", "device")
    assert isinstance(f, DeviceCompactionExecutorFactory)
    assert f.device == "cuda"
    assert reg.create("compaction_executor_factory", CPU).device == "cpu"
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        reg.create("compaction_executor_factory", {
            "class": "device", "params": {"device_name": "tpu"}})
    for params in ({"allow_fallback": True}, {"min_input_bytes": 1 << 20}):
        with pytest.raises(NotSupported, match="no fallback"):
            reg.create("compaction_executor_factory",
                       {"class": "device", "params": params})
    opts = options_from_config({"compaction_executor_factory": "device"})
    assert opts.compaction_executor_factory.device == "cuda"


def test_left_out_half_raises_and_answers_501(tmp_path, no_thread_leaks):
    repo = SidePluginRepo()
    for call, plane in ((lambda: repo.attach_cluster("c", object()),
                         "sharding"),
                        (lambda: repo.attach_fleet_supervisor("f", object()),
                         "fleet"),
                        (lambda: repo.attach_fleet_member("m", "http://x"),
                         "fleet"),
                        (lambda: repo._cluster_health(), "fleet"),
                        (lambda: repo._fleet_gauges(), "fleet"),
                        (lambda: repo._shard_action("c", "split", {}),
                         "sharding"),
                        (lambda: config._prometheus_cluster_gauges("c", None),
                         "sharding")):
        with pytest.raises(NotSupported, match=f"the {plane} plane"):
            call()
    repo.open_db({"path": str(tmp_path / "db"), "options": {
        "create_if_missing": True, "compaction_executor_factory": CPU}},
        name="d")
    port = repo.start_http()
    base = f"http://127.0.0.1:{port}"
    try:
        for path, method, plane in (("shards", "GET", "sharding"),
                                    ("shards/c", "GET", "sharding"),
                                    ("fleet", "GET", "fleet"),
                                    ("fleet/f", "GET", "fleet"),
                                    ("cluster/health", "GET", "fleet"),
                                    ("shards/c/split", "POST", "sharding")):
            req = urllib.request.Request(
                f"{base}/{path}", method=method,
                data=b"{}" if method == "POST" else None)
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=10)
            assert ei.value.code == 501, path
            body = json.loads(ei.value.read())
            assert f"the {plane} plane" in body["error"], path
        assert _get_json(f"{base}/dbs") == {"dbs": ["d"]}
    finally:
        repo.close_all()


# ---------------------------------------------------------------------------
# /metrics against the reference
# ---------------------------------------------------------------------------

# Tickers whose values are times or depend on thread order
# (tests/test_torch_statistics.py's EXCLUDED).
TIME_VALUED = {"stall.micros", "write.group.followers",
               "write.done.by.other"}
COUNT_GAUGES = {"level_files", "last_sequence", "immutable_memtables",
                "write_stall_state", "write_stall_l0_files",
                "write_stall_micros_total", "slo_health", "slo_firing",
                "trace_ring_retained", "traces_started_total"}
_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$")


def _metrics(text):
    """{(name, labels): value} and {name: type} of an exposition."""
    samples, types = {}, {}
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            types[name] = kind
            continue
        m = _SAMPLE.match(line)
        assert m, f"bad exposition line: {line!r}"
        samples[(m.group(1), m.group(2) or "")] = m.group(3)
    return samples, types


def _scripted(repo_cls, db_mod, opts_mod, path, extra):
    repo = repo_cls()
    o = opts_mod.Options(create_if_missing=True, disable_auto_compactions=True,
                         write_buffer_size=1 << 20, trace_sample_every=1,
                         slo_specs=({"name": "get-p99", "kind": "latency",
                                     "threshold_usec": 10_000},),
                         statistics=(ref_st if db_mod is ref_dbm
                                     else st).Statistics(), **extra)
    db = db_mod.DB.open(path, o)
    repo.attach_db("main", db)
    try:
        for i in range(300):
            db.put(b"key%06d" % i, b"v%d" % i)
        db.flush()
        for i in range(100, 200):
            db.put(b"key%06d" % i, b"w%d" % i)
        for i in range(0, 300, 3):
            db.get(b"key%06d" % i)
        db.multi_get([b"key%06d" % i for i in range(20)])
        it = db.new_iterator()
        it.seek(b"key000050")
        for _ in range(10):
            it.next()
        db.slo_engine.evaluate()
        port = repo.start_http()
        try:
            _s, ctype, body = _get(f"http://127.0.0.1:{port}/metrics")
        finally:
            repo.stop_http()
    finally:
        db.close()
    assert ctype.startswith("text/plain")
    return _metrics(body.decode())


def test_metrics_names_labels_and_counts_match_reference(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(time, "time", lambda: FROZEN_TIME)
    ref_s, ref_t = _scripted(ref_config.SidePluginRepo, ref_dbm, ref_opts,
                             str(tmp_path / "r"), {})
    port_s, port_t = _scripted(
        SidePluginRepo, dbm, opts_mod, str(tmp_path / "p"),
        {"compaction_executor_factory": DeviceCompactionExecutorFactory(
            device="cpu")})
    assert sorted(port_s) == sorted(ref_s)
    assert port_t == ref_t
    compared = 0
    for (name, labels), v in port_s.items():
        kind = port_t.get(name) or port_t.get(
            name.rsplit("_", 1)[0]) or port_t.get(name[:-len("_count")])
        ticker = name[len("tpulsm_"):].replace("_", ".")
        count_valued = (
            (kind == "counter" and not any(
                ticker == t.replace("_", ".") for t in TIME_VALUED))
            or name.endswith("_count")
            or name[len("tpulsm_"):] in COUNT_GAUGES)
        if count_valued:
            assert v == ref_s[(name, labels)], (name, labels)
            compared += 1
    assert compared > 40
    assert port_s[('tpulsm_number_keys_written', '{db="main"}')] == "400"
    assert port_s[('tpulsm_level_files', '{db="main",level="0"}')] == "1"
    assert port_s[('tpulsm_slo_firing', '{db="main",slo="get-p99"}')] == "0"


# ---------------------------------------------------------------------------
# The reference's own cases on the port
# ---------------------------------------------------------------------------


def test_http_integrity_view_and_scrub_trigger(tmp_path,
                                               no_thread_leaks):  # integrity:755
    repo = SidePluginRepo()
    db = repo.open_db({"path": str(tmp_path / "db"),
                       "options": {"create_if_missing": True,
                                   "protection_bytes_per_key": 8,
                                   "write_buffer_size": 16384,
                                   "compaction_executor_factory": CPU}},
                      name="main")
    port = repo.start_http()
    base = f"http://127.0.0.1:{port}"
    try:
        for i in range(600):
            db.put(b"k%05d" % (i * 7919 % 600), b"v" * 40)
        db.flush()
        body = _post(f"{base}/scrub/main")
        assert body["ok"] and body["report"]["files_scanned"] >= 1
        view = _get_json(f"{base}/integrity/main")
        assert view["protection_bytes_per_key"] == 8
        assert view["passes"] >= 1
        assert view["quarantined_files"] == []
    finally:
        repo.close_all()


def test_http_metrics_traces_stats_history(tmp_path,
                                           no_thread_leaks):      # telemetry:371
    repo = SidePluginRepo()
    db = repo.open_db({"path": str(tmp_path / "db"),
                       "options": {"create_if_missing": True,
                                   "trace_sample_every": 1,
                                   "write_buffer_size": 1 << 20,
                                   "compaction_executor_factory": CPU}},
                      name="main")
    port = repo.start_http()
    base = f"http://127.0.0.1:{port}"
    try:
        for i in range(300):
            db.put(b"key%06d" % i, b"v%d" % i)
        db.get(b"key000001")
        db.flush()
        db.persist_stats()
        _s, ctype, text = _get(f"{base}/metrics")
        assert ctype.startswith("text/plain")
        samples, _t = _metrics(text.decode())
        joined = "\n".join(n + lab for n, lab in samples)
        assert 'tpulsm_bytes_written{db="main"}' in joined
        assert 'tpulsm_level_files{db="main",level="0"}' in joined
        assert 'tpulsm_last_sequence{db="main"}' in joined
        assert "tpulsm_trace_ring_retained" in joined
        assert "tpulsm_db_write_micros_count" in joined
        body = _get_json(f"{base}/traces/main")
        assert body["tracer"]["sample_every"] == 1 and body["traces"]
        tid = body["traces"][0]["trace_id"]
        assert _get_json(f"{base}/traces/main/{tid}")["traceEvents"]
        html = _get(f"{base}/view/traces/main")[2].decode()
        assert "traces: main" in html
        hist = _get_json(f"{base}/stats_history/main?window=3600")
        assert hist["n_samples"] >= 1
        assert any("number.keys.written" in s["tickers"]
                   for s in hist["samples"])
    finally:
        repo.close_all()


def test_db_http_view_write_plane(tmp_path, no_thread_leaks):   # write_plane:376
    repo = SidePluginRepo()
    db = repo.open_db({"path": str(tmp_path / "h"),
                       "options": {"statistics": "default",
                                   "compaction_executor_factory": CPU}})
    name = list(repo._dbs)[0]
    for i in range(50):
        db.put(b"h%04d" % i, b"v")
    view = repo._route(["db", name])
    assert view is not None
    t = view["tickers"]
    for key in (st.WAL_BYTES, st.WRITE_GROUP_LED,
                st.WRITE_GROUP_NATIVE_COMMITS, st.WRITE_GROUP_FALLBACKS,
                st.WRITE_GROUP_FSYNCS_COALESCED):
        assert key in t
    assert t[st.WRITE_GROUP_LED] > 0
    assert t[st.WRITE_GROUP_NATIVE_COMMITS] == t[st.WRITE_GROUP_LED]
    assert view["write_plane_enabled"] and view["write_plane_resolved"]
    assert view["write_group_bytes"]["count"] > 0
    repo.close_all()


def test_prometheus_metrics_endpoint(tmp_path,
                                     no_thread_leaks):    # statistics_breadth:166
    stats = Statistics()
    db = dbm.DB.open(str(tmp_path / "db"), Options(
        create_if_missing=True, statistics=stats,
        compaction_executor_factory=DeviceCompactionExecutorFactory(
            device="cpu")))
    try:
        for i in range(50):
            db.put(b"k%02d" % i, b"v")
        repo = SidePluginRepo()
        repo._dbs["main"] = db
        port = repo.start_http()
        body = _get(f"http://127.0.0.1:{port}/metrics")[2].decode()
        repo.stop_http()
        assert "# TYPE tpulsm_number_keys_written counter" in body
        assert 'tpulsm_number_keys_written{db="main"} 50' in body
        assert "tpulsm_db_write_micros_count" in body
        assert 'quantile="0.99"' in body
    finally:
        db.close()


def test_metrics_scrape_has_disk_gauges(tmp_path,
                                        no_thread_leaks):    # disk_pressure:595
    stats = Statistics()
    db = dbm.DB.open(str(tmp_path / "d"), Options(
        create_if_missing=True, statistics=stats,
        max_allowed_space_usage=1 << 30,
        slo_specs=({"name": "disk-ok", "kind": "disk_pressure",
                    "objective": 0.9},),
        compaction_executor_factory=DeviceCompactionExecutorFactory(
            device="cpu")))
    repo = SidePluginRepo()
    repo.attach_db("d", db)
    port = repo.start_http()
    try:
        db.put(b"k", b"v")
        db.flush()
        db._sfm.poll()
        text = _get(f"http://127.0.0.1:{port}/metrics")[2].decode()
        assert 'tpulsm_disk_pressure_state{db="d"} 0' in text
        assert 'tpulsm_disk_budget_bytes{db="d"}' in text
        assert 'tpulsm_disk_tracked_bytes{db="d"}' in text
        assert 'tpulsm_disk_free_bytes{db="d"}' in text
        doc = _get_json(f"http://127.0.0.1:{port}/slo/d?evaluate=1")
        assert "disk-ok" in doc["specs"]
    finally:
        repo.stop_http()
        db.close()


def test_http_slo_and_health(tmp_path, no_thread_leaks):             # health:399
    """tests/test_health.py:399 without its cluster and fleet legs (the
    fleet plane is not in the port: /cluster/health answers 501)."""
    stats = Statistics(histogram_window_sec=60.0)
    db = dbm.DB.open(str(tmp_path / "d"), Options(
        create_if_missing=True, write_buffer_size=1 << 20, statistics=stats,
        slo_specs=({"name": "get-p99", "kind": "latency",
                    "histogram": st.DB_GET_MICROS, "objective": 0.99,
                    "threshold_usec": 10_000},),
        compaction_executor_factory=DeviceCompactionExecutorFactory(
            device="cpu")))
    repo = SidePluginRepo()
    repo.attach_db("d", db)
    port = repo.start_http()
    base = f"http://127.0.0.1:{port}"
    try:
        db.put(b"k", b"v")
        for _ in range(20):
            db.get(b"k")
        out = _get_json(f"{base}/slo/d?evaluate=1")
        assert out["health"] == slomod.HEALTH_GREEN
        assert out["specs"]["get-p99"]["burn_rate_fast"] >= 0.0
        doc = _get_json(f"{base}/health/d")
        assert doc["name"] == "d" and doc["role"] == "primary"
        row = doc["histograms"][st.DB_GET_MICROS]
        assert row["cumulative"]["count"] == 20 and "recent" in row
        text = _get(f"{base}/metrics")[2].decode()
        assert 'tpulsm_slo_firing{db="d",slo="get-p99"} 0' in text
        assert 'tpulsm_slo_health{db="d"} 0' in text
        assert "_recent" in text
        assert _get_json(f"{base}/replication/d")["role"] == \
            "primary-unshipped"
        assert _get_json(f"{base}/store/d") == {"enabled": False}
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/slo/nope", timeout=10)
        assert ei.value.code == 404
    finally:
        repo.stop_http()
        db.close()


def test_views_and_online_options(tmp_path, no_thread_leaks):
    repo = SidePluginRepo()
    cfg = {"path": str(tmp_path / "db"), "options": {
        "create_if_missing": True, "write_buffer_size": 1 << 20,
        "compaction_executor_factory": CPU}}
    db = repo.open_db(json.dumps(cfg), name="v")
    assert repo.get_db("v") is db and repo.get_db("x") is None
    port = repo.start_http()
    base = f"http://127.0.0.1:{port}"
    try:
        for i in range(100):
            db.put(b"k%03d" % i, b"v")
        db.flush()
        html = _get(f"{base}/view")[2].decode()
        assert '<a href="/view/v">v</a>' in html
        page = _get(f"{base}/view/v")[2].decode()
        assert "<h2>Levels</h2>" in page and "1 files" in page
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/view/nope", timeout=10)
        assert ei.value.code == 404
        out = _post(f"{base}/setoptions/v",
                    json.dumps({"write_buffer_size": 4 << 20}).encode())
        assert out == {"ok": True, "applied": {"write_buffer_size": 4 << 20}}
        assert db.options.write_buffer_size == 4 << 20
        assert config.load_latest_options(db.dbname).write_buffer_size == \
            4 << 20
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"{base}/setoptions/v", b'{"num_levels": 3}')
        assert ei.value.code == 400
        assert _get_json(f"{base}/config/v") == cfg
        lv = _get_json(f"{base}/levels/v")
        assert [f["entries"] for f in lv["L0"]] == [100]
        stats = _get_json(f"{base}/stats/v")
        assert "L0: 1 files" in stats["levelstats"]
    finally:
        repo.close_all()
    assert ccy.registry.check_leaks(owner=repo) == []
    assert ccy.registry.check_leaks(owner=db) == []
