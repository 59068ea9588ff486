"""JSON-driven configuration + object registry + HTTP introspection
(copied from toplingdb_tpu/utils/config.py, its single-DB half).

The SidePlugin layer (ToplingDB's SidePlugin, rockside's JSON config and
WebView, RocksDB's utilities/object_registry.cc):

  ObjectRegistry      (category, name) -> factory; objects created from JSON
                      specs {"class": name, "params": {...}} or plain names.
                      The "device" compaction executor factory is the
                      port's, on "cuda" unless the spec names "cpu"; it has
                      no fallback.
  SidePluginRepo      named objects + DBs opened from one JSON document;
                      an embedded HTTP server exposing stats / levels /
                      config / SLO / health / metrics views (the WebView
                      analogue).

The replication half runs: /replication/<name> serves a LogShipper's or a
FollowerDB's status, and POST /promote/<name> promotes a registered
FollowerDB. toplingdb_tpu's cluster, fleet and shard half waits for the
planes the port lacks (sharding/, tools/fleet_health): its methods raise
NotSupported naming the missing plane, and its routes answer 501 with the
same words.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from toplingdb_tpu_torch.utils import concurrency as ccy
from toplingdb_tpu_torch.utils import errors as _errors
from toplingdb_tpu_torch.utils.status import InvalidArgument, NotSupported

# The parts of toplingdb_tpu's SidePluginRepo that wait for a plane the
# port lacks, each with the words its NotSupported and its 501 carry.
_SHARDING = ("the sharding plane (toplingdb_tpu's sharding/: ShardRouter "
             "and its shard actions) is not in the port")
_FLEET = ("the fleet plane (toplingdb_tpu's sharding.FleetSupervisor and "
          "tools/fleet_health) is not in the port")
_LEFT_OUT_ROUTES = {"shards": _SHARDING, "fleet": _FLEET}


class ObjectRegistry:
    _global: "ObjectRegistry | None" = None

    def __init__(self):
        self._factories: dict[tuple[str, str], object] = {}

    @classmethod
    def default(cls) -> "ObjectRegistry":
        if cls._global is None:
            cls._global = cls()
            _register_builtins(cls._global)
        return cls._global

    def register(self, category: str, name: str, factory) -> None:
        self._factories[(category, name)] = factory

    def create(self, category: str, spec):
        """spec: name string, or {"class": name, "params": {...}}."""
        if spec is None:
            return None
        if isinstance(spec, str):
            name, params = spec, {}
        elif isinstance(spec, dict):
            name = spec.get("class") or spec.get("name")
            params = spec.get("params", {})
        else:
            return spec  # already an object
        f = self._factories.get((category, name))
        if f is None:
            raise InvalidArgument(f"no {category} factory named {name!r}")
        return f(**params)

    def names(self, category: str) -> list[str]:
        return sorted(n for c, n in self._factories if c == category)


def _device_factory(device_name: str = "cuda", min_input_bytes: int = 0,
                    allow_fallback: bool = False):
    """The port's DeviceCompactionExecutorFactory from a JSON spec, on
    `device_name` ("cuda" or "cpu"). Every job runs on it: a spec asking
    for toplingdb_tpu's local route or fallback (min_input_bytes,
    allow_fallback) is refused."""
    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )

    if min_input_bytes or allow_fallback:
        raise NotSupported(
            "the port's device executor runs every job on its device, with "
            "no fallback (min_input_bytes / allow_fallback)")
    return DeviceCompactionExecutorFactory(device=device_name)


def _register_builtins(reg: ObjectRegistry) -> None:
    from toplingdb_tpu_torch.compaction.executor import (
        SubprocessCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.db import dbformat
    from toplingdb_tpu_torch.table.filter import BloomFilterPolicy
    from toplingdb_tpu_torch.utils.compaction_filter import (
        RemoveEmptyValueCompactionFilter,
    )
    from toplingdb_tpu_torch.utils.merge_operator import (
        AggMergeOperator,
        BytesXOROperator,
        CassandraValueMergeOperator,
        MaxOperator,
        PutOperator,
        SortListOperator,
        StringAppendOperator,
        UInt64AddOperator,
    )
    from toplingdb_tpu_torch.utils.slice_transform import (
        CappedPrefixTransform,
        FixedPrefixTransform,
        NoopTransform,
    )
    from toplingdb_tpu_torch.utils.statistics import Statistics

    reg.register("comparator", "bytewise", lambda: dbformat.BYTEWISE)
    reg.register("comparator", "reverse_bytewise",
                 lambda: dbformat.REVERSE_BYTEWISE)
    reg.register("comparator", "u64ts_bytewise",
                 lambda: dbformat.U64_TS_BYTEWISE)
    reg.register("merge_operator", "put", PutOperator)
    reg.register("merge_operator", "uint64add", UInt64AddOperator)
    reg.register("merge_operator", "stringappend", StringAppendOperator)
    reg.register("merge_operator", "max", MaxOperator)
    reg.register("merge_operator", "bytesxor", BytesXOROperator)
    reg.register("merge_operator", "sortlist", SortListOperator)
    reg.register("merge_operator", "aggmerge", AggMergeOperator)
    reg.register("merge_operator", "cassandra", CassandraValueMergeOperator)
    reg.register("compaction_filter", "remove_empty_value",
                 RemoveEmptyValueCompactionFilter)
    reg.register("filter_policy", "bloom",
                 lambda bits_per_key=10.0: BloomFilterPolicy(bits_per_key))
    reg.register("compaction_executor_factory", "device", _device_factory)
    reg.register("compaction_executor_factory", "subprocess",
                 SubprocessCompactionExecutorFactory)

    def _http_factory(worker_urls=(), **kw):
        from toplingdb_tpu_torch.compaction.dcompact_service import (
            HttpCompactionExecutorFactory,
        )

        return HttpCompactionExecutorFactory(list(worker_urls), **kw)

    reg.register("compaction_executor_factory", "http", _http_factory)
    reg.register("statistics", "default", Statistics)
    reg.register("prefix_extractor", "fixed",
                 lambda length=8: FixedPrefixTransform(length))
    reg.register("prefix_extractor", "capped",
                 lambda length=8: CappedPrefixTransform(length))
    reg.register("prefix_extractor", "noop", NoopTransform)


_SIMPLE_OPTION_KEYS = {
    "create_if_missing", "error_if_exists", "paranoid_checks",
    "write_buffer_size", "max_write_buffer_number", "wal_enabled",
    "num_levels", "level0_file_num_compaction_trigger",
    "level0_slowdown_writes_trigger", "level0_stop_writes_trigger",
    "max_bytes_for_level_base", "max_bytes_for_level_multiplier",
    "target_file_size_base", "target_file_size_multiplier",
    "max_compaction_bytes", "compaction_style", "max_background_jobs",
    "max_subcompactions", "disable_auto_compactions",
    "universal_size_ratio", "universal_min_merge_width",
    "universal_max_merge_width",
    "universal_max_size_amplification_percent",
    "fifo_max_table_files_size", "fifo_ttl_seconds",
    "periodic_compaction_seconds",
    "full_history_ts_low",
    "enable_blob_files", "min_blob_size",
    "enable_blob_garbage_collection", "blob_garbage_collection_age_cutoff",
    "stats_persist_period_sec", "stats_dump_period_sec",
    "trace_sample_every", "trace_slow_usec", "trace_ring",
    "seqno_time_sample_period_sec",
    "read_only", "memtable_rep", "db_write_buffer_size",
    "allow_concurrent_memtable_write", "enable_pipelined_write",
    "unordered_write", "preclude_last_level_data_seconds",
    "compression", "bottommost_compression", "bottommost_format",
    "recycle_log_file_num", "wal_ttl_seconds",
    "protection_bytes_per_key", "file_checksum",
    "integrity_scrub_period_sec", "integrity_scrub_bytes_per_sec",
    "enable_async_wal", "async_wal_ring_size",
    "histogram_window_sec", "slo_eval_period_sec", "slo_window_sec",
}

# MergeOperator.name() → registry key, for options_to_config round-trips.
_MERGE_OP_NAMES = {
    "PutOperator": "put", "UInt64AddOperator": "uint64add",
    "StringAppendOperator": "stringappend", "MaxOperator": "max",
    "BytesXOROperator": "bytesxor", "MergeSortOperator": "sortlist",
    "AggMergeOperator.v1": "aggmerge",
    "CassandraValueMergeOperator": "cassandra",
}

_SIMPLE_TABLE_KEYS = (
    "format", "block_size", "restart_interval", "index_restart_interval",
    "compression", "whole_key_filtering", "verify_checksums", "index_type",
    "metadata_block_size", "hash_index", "auto_sort",
)


def options_from_config(cfg: dict):
    """Build Options from a JSON-style dict (the SidePlugin config shape)."""
    from toplingdb_tpu_torch.options import Options
    from toplingdb_tpu_torch.table.builder import TableOptions

    reg = ObjectRegistry.default()
    opts = Options()
    for k, v in cfg.items():
        if k in _SIMPLE_OPTION_KEYS:
            setattr(opts, k, v)
        elif k == "comparator":
            opts.comparator = reg.create("comparator", v)
        elif k == "merge_operator":
            opts.merge_operator = reg.create("merge_operator", v)
        elif k == "compaction_filter":
            opts.compaction_filter = reg.create("compaction_filter", v)
        elif k == "prefix_extractor":
            opts.prefix_extractor = reg.create("prefix_extractor", v)
        elif k == "compaction_executor_factory":
            opts.compaction_executor_factory = reg.create(
                "compaction_executor_factory", v
            )
        elif k == "shared_store":
            # A string spec (store root path or http:// URL) rides the
            # JSON config; live store objects are code-only.
            opts.shared_store = v
        elif k == "dcompact":
            from toplingdb_tpu_torch.compaction.resilience import DcompactOptions

            opts.dcompact = DcompactOptions.from_config(v)
        elif k == "statistics":
            opts.statistics = reg.create("statistics", v)
        elif k == "slo_specs":
            # Plain dicts straight from JSON; utils/slo.SLOEngine
            # normalizes them into SLOSpec at engine construction.
            opts.slo_specs = tuple(v)
        elif k == "table_options":
            t = TableOptions()
            for tk, tv in v.items():
                if tk == "filter_policy":
                    t.filter_policy = reg.create("filter_policy", tv)
                else:
                    setattr(t, tk, tv)
            opts.table_options = t
        else:
            raise InvalidArgument(f"unknown option {k!r}")
    return opts


def options_to_config(opts) -> dict:
    """Serialize Options to the same JSON-style dict options_from_config
    reads — the OPTIONS-NNNN persistence format (RocksDB's
    options/options_parser.cc PersistRocksDBOptions). Non-default simple
    fields plus registry-known plugin objects; unregistered plugin objects
    (custom user classes) are skipped, as RocksDB skips unknown
    customizables."""
    from toplingdb_tpu_torch.options import Options

    base = Options()
    out: dict = {}
    for k in sorted(_SIMPLE_OPTION_KEYS):
        v = getattr(opts, k)
        if v != getattr(base, k):
            out[k] = v
    if isinstance(getattr(opts, "shared_store", None), str) \
            and opts.shared_store:
        out["shared_store"] = opts.shared_store
    if opts.comparator.name() == "tpulsm.ReverseBytewiseComparator":
        out["comparator"] = "reverse_bytewise"
    elif opts.comparator.name() == "tpulsm.BytewiseComparator.u64ts":
        out["comparator"] = "u64ts_bytewise"
    # (any other non-bytewise comparator is an unregistered custom object —
    # skipped, as RocksDB skips unknown customizables)
    if opts.merge_operator is not None:
        key = _MERGE_OP_NAMES.get(opts.merge_operator.name())
        if key is not None:
            out["merge_operator"] = key
    if (opts.compaction_filter is not None
            and opts.compaction_filter.name()
            == "RemoveEmptyValueCompactionFilter"):
        out["compaction_filter"] = "remove_empty_value"
    if opts.statistics is not None:
        out["statistics"] = "default"
    if getattr(opts, "slo_specs", ()):
        from dataclasses import asdict, is_dataclass

        out["slo_specs"] = [
            asdict(s) if is_dataclass(s) else dict(s)
            for s in opts.slo_specs
        ]
    if opts.dcompact is not None:
        dc = opts.dcompact.to_config()
        if dc:
            out["dcompact"] = dc
    pe = opts.prefix_extractor
    if pe is not None:
        pname = pe.name()
        if pname.startswith("tpulsm.FixedPrefix."):
            out["prefix_extractor"] = {
                "class": "fixed", "params": {"length": pe.n},
            }
        elif pname.startswith("tpulsm.CappedPrefix."):
            out["prefix_extractor"] = {
                "class": "capped", "params": {"length": pe.n},
            }
        elif pname == "tpulsm.Noop":
            out["prefix_extractor"] = "noop"
    t = opts.table_options
    from toplingdb_tpu_torch.table.builder import TableOptions

    tbase = TableOptions()
    tout: dict = {}
    for k in _SIMPLE_TABLE_KEYS:
        v = getattr(t, k)
        if v != getattr(tbase, k):
            tout[k] = v
    if t.filter_policy is None:
        tout["filter_policy"] = None
    elif t.filter_policy.name().startswith("tpulsm.BloomFilter"):
        bits = getattr(t.filter_policy, "bits_per_key", 10.0)
        if bits != 10.0:
            tout["filter_policy"] = {
                "class": "bloom", "params": {"bits_per_key": bits},
            }
    if tout:
        out["table_options"] = tout
    return out


def persist_options(db) -> None:
    """Write OPTIONS-NNNN next to the DB (RocksDB's PersistRocksDBOptions on
    every successful open); older OPTIONS files become obsolete."""
    import json as _json

    from toplingdb_tpu_torch.db import filename as _fn

    num = db.versions.new_file_number()
    db.env.write_file(
        _fn.options_file_name(db.dbname, num),
        _json.dumps(options_to_config(db.options), indent=1).encode(),
    )
    db._options_file_number = num


def load_latest_options(dbname: str, env=None):
    """Rebuild Options from the newest OPTIONS-NNNN file (RocksDB's
    LoadLatestOptions). Returns None if no OPTIONS file exists."""
    import json as _json

    from toplingdb_tpu_torch.db import filename as _fn

    if env is None:
        from toplingdb_tpu_torch.env import default_env

        env = default_env()
    nums = [
        num for child in env.get_children(dbname)
        for t, num in [_fn.parse_file_name(child)]
        if t == _fn.FileType.OPTIONS
    ]
    if not nums:
        return None
    data = env.read_file(_fn.options_file_name(dbname, max(nums)))
    return options_from_config(_json.loads(data.decode()))


_BREAKER_STATE_NUM = {"closed": 0, "half_open": 1, "open": 2}


def _prometheus_gauges(name: str, db) -> str:
    """Point-in-time gauges beside the ticker/histogram exposition:
    memtable bytes, per-level file counts/bytes, async-WAL ring depth,
    replication status numbers, dcompact breaker states, and tracer ring
    occupancy. Best-effort: a half-closed DB yields what it can."""
    lines = []
    lab = f'{{db="{name}"}}'

    def g(metric, value, labels=None):
        m = f"tpulsm_{metric}"
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m}{labels or lab} {value}")

    try:
        cfs = getattr(db, "_cfs", None)
        if cfs:
            g("memtable_bytes", sum(
                c.mem.approximate_memory_usage()
                + sum(m.approximate_memory_usage() for m in c.imm)
                for c in cfs.values()))
            g("immutable_memtables", sum(len(c.imm) for c in cfs.values()))
    except Exception as e:
        _errors.swallow(reason="prom-gauge-memtable", exc=e)
    try:
        v = db.versions.current
        for lvl in range(v.num_levels):
            files = v.files[lvl]
            if files:
                ll = f'{{db="{name}",level="{lvl}"}}'
                g("level_files", len(files), ll)
                g("level_bytes", sum(f.file_size for f in files), ll)
        g("last_sequence", db.versions.last_sequence)
    except Exception as e:
        _errors.swallow(reason="prom-gauge-levels", exc=e)
    try:
        ring = getattr(db, "_wal_ring", None)
        if ring is not None:
            g("async_wal_ring_depth", len(ring._q))
    except Exception as e:
        _errors.swallow(reason="prom-gauge-wal-ring", exc=e)
    try:
        provider = getattr(db, "_repl_status_provider", None)
        if provider is not None:
            for k, val in provider().items():
                if isinstance(val, bool) or not isinstance(val,
                                                           (int, float)):
                    continue
                g(f"replication_{k}", val)
    except Exception as e:
        _errors.swallow(reason="prom-gauge-replication", exc=e)
    try:
        health = getattr(
            getattr(db.options, "compaction_executor_factory", None),
            "health", None)
        breakers = getattr(health, "_breakers", None)
        if breakers:
            for url, b in sorted(breakers.items()):
                ul = f'{{db="{name}",url="{url}"}}'
                g("dcompaction_breaker_state",
                  _BREAKER_STATE_NUM.get(b.state, -1), ul)
    except Exception as e:
        _errors.swallow(reason="prom-gauge-dcompact-breaker", exc=e)
    try:
        tracer = getattr(db, "tracer", None)
        if tracer is not None:
            st = tracer.status()
            g("trace_ring_retained", st["traces_retained"])
            g("traces_started_total", st["traces_started"])
    except Exception as e:
        _errors.swallow(reason="prom-gauge-tracer", exc=e)
    try:
        stall_fn = getattr(db, "write_stall_state", None)
        if stall_fn is not None:
            stall = stall_fn()
            g("write_stall_state",
              {"none": 0, "delayed": 1, "stopped": 2}.get(
                  stall.get("state"), -1))
            g("write_stall_l0_files", stall.get("l0_files", 0))
            g("write_stall_micros_total", stall.get("stall_micros", 0))
    except Exception as e:
        _errors.swallow(reason="prom-gauge-write-stall", exc=e)
    try:
        engine = getattr(db, "slo_engine", None)
        if engine is not None:
            from toplingdb_tpu_torch.utils.slo import health_num

            s = engine.status()
            g("slo_health", health_num(s["health"]))
            for sname, row in sorted(s["specs"].items()):
                sl = f'{{db="{name}",slo="{sname}"}}'
                g("slo_burn_rate_fast", row["burn_rate_fast"], sl)
                g("slo_burn_rate_slow", row["burn_rate_slow"], sl)
                g("slo_firing", int(row["firing"]), sl)
    except Exception as e:
        _errors.swallow(reason="prom-gauge-slo", exc=e)
    try:
        sfm = getattr(db, "_sfm", None)
        if sfm is not None:
            g("disk_free_bytes", sfm.free_space())
            g("disk_tracked_bytes", sfm.total_size())
            g("disk_trash_bytes", sfm.trash_size())
            g("disk_pressure_state",
              {"ok": 0, "amber": 1, "red": 2}.get(sfm.pressure(), -1))
            g("disk_budget_bytes", sfm.max_allowed_space_usage)
            g("disk_reserved_bytes", sfm.reserved_bytes())
    except Exception as e:
        _errors.swallow(reason="prom-gauge-disk", exc=e)
    return "\n".join(lines) + "\n" if lines else ""


def _prometheus_cluster_gauges(name: str, router) -> str:
    """toplingdb_tpu's per-shard gauges for a registered ShardRouter."""
    raise NotSupported(_SHARDING)


class SidePluginRepo:
    """Open DBs from one JSON document; serve introspection over HTTP
    (ToplingDB's SidePluginRepo and rockside's WebView)."""

    def __init__(self):
        self._dbs: dict[str, object] = {}
        self._configs: dict[str, dict] = {}
        self._server: ThreadingHTTPServer | None = None
        self._http_thread = None

    def attach_db(self, name: str, db, config: dict | None = None) -> None:
        """Register an externally-opened DB (a FollowerDB, a router's
        primary) so the HTTP layer serves its stats//replication views."""
        self._dbs[name] = db
        self._configs[name] = config or {}

    def attach_cluster(self, name: str, router) -> None:
        """toplingdb_tpu's ShardRouter registration (/shards/<name>)."""
        raise NotSupported(_SHARDING)

    def attach_fleet_supervisor(self, name: str, supervisor) -> None:
        """toplingdb_tpu's FleetSupervisor registration (/fleet/<name>)."""
        raise NotSupported(_FLEET)

    def attach_fleet_member(self, name: str, url: str) -> None:
        """toplingdb_tpu's remote member for /cluster/health."""
        raise NotSupported(_FLEET)

    def open_db(self, config, name: str | None = None):
        """config: dict or JSON string: {"path": ..., "options": {...}}."""
        from toplingdb_tpu_torch.db.db import DB

        if isinstance(config, str):
            config = json.loads(config)
        path = config["path"]
        name = name or config.get("name") or path
        cfg_opts = dict(config.get("options", {}))
        # The rockside role always exposes live metrics: repo-opened DBs
        # get a Statistics sink unless the config explicitly disables it
        # ({"statistics": false}).
        if cfg_opts.get("statistics", True) is False:
            cfg_opts.pop("statistics", None)
        else:
            cfg_opts.setdefault("statistics", "default")
        opts = options_from_config(cfg_opts)
        db = DB.open(path, opts)
        self._dbs[name] = db
        self._configs[name] = config
        return db

    def get_db(self, name: str):
        return self._dbs.get(name)

    def close_all(self) -> None:
        self.stop_http()
        for db in self._dbs.values():
            db.close()
        self._dbs.clear()

    # -- HTTP introspection --------------------------------------------

    def start_http(self, port: int = 0) -> int:
        """Serves /dbs, /stats/<name>, /levels/<name>, /config/<name>,
        /db/<name> (write-plane view: WAL_* + WRITE_GROUP_* counters,
        write.group.bytes histogram, async-WAL ring state),
        /replication/<name> (a shipper's or a follower's status, else a
        standalone DB's role), /integrity/<name> (scrub progress,
        quarantined files, mismatch counters — the integrity plane's
        view), /store/<name> (the shared SST store's references, cache
        tier, backend status and store.* tickers; {"enabled": false} on a
        plain env), /traces/<name>, /stats_history/<name>,
        /slo/<name>, /health/<name>, /view (HTML) and /metrics
        (Prometheus text format over every registered DB's Statistics —
        the rockside Prometheus role). POST /scrub/<name> runs one
        integrity-scrub pass and returns its report; POST
        /setoptions/<name> changes options online; POST /promote/<name>
        promotes a follower. /shards, /fleet, /cluster/health and POST
        /shards answer 501.
        Returns the bound port."""
        repo = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send_json(self, code: int, body) -> None:
                data = json.dumps(body, indent=1, default=str).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                from urllib.parse import parse_qs, urlsplit

                split = urlsplit(self.path)
                query = {k: v[-1] for k, v in
                         parse_qs(split.query).items()}
                parts = [p for p in split.path.split("/") if p]
                if parts and parts[0] == "view":
                    # The rockside WebView role: a human-readable HTML
                    # dashboard over the same introspection routes.
                    try:
                        html = repo._render_view("/".join(parts[1:]))
                        code = 200 if html is not None else 404
                        data = (html or "<h1>not found</h1>").encode()
                    except Exception as e:
                        code, data = 500, repr(e).encode()
                    self.send_response(code)
                    self.send_header("Content-Type",
                                     "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                if parts and parts[0] == "metrics":
                    try:
                        out = []
                        for name, db in sorted(repo._dbs.items()):
                            if db.stats is not None:
                                out.append(db.stats.to_prometheus(
                                    labels=f'db="{name}"'))
                            out.append(_prometheus_gauges(name, db))
                        from toplingdb_tpu_torch.utils import errors as _errs

                        out.append(
                            "# TYPE tpulsm_bg_error_swallowed_total gauge\n"
                            "tpulsm_bg_error_swallowed_total "
                            f"{_errs.swallowed_total()}\n")
                        data = "".join(out).encode()
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "text/plain; version=0.0.4")
                        self.send_header("Content-Length", str(len(data)))
                        self.end_headers()
                        self.wfile.write(data)
                    except Exception as e:
                        self._send_json(500, {"error": repr(e)})
                    return
                try:
                    body = repo._route(parts, query)
                    code = 200 if body is not None else 404
                    body = body if body is not None else {"error": "not found"}
                except NotSupported as e:  # a plane the port lacks
                    code, body = 501, {"error": str(e)}
                except Exception as e:  # introspection must not crash
                    code, body = 500, {"error": repr(e)}
                self._send_json(code, body)

            def do_POST(self):
                # Online option change (the rockside online-config role):
                # POST /setoptions/<name> {"write_buffer_size": ...}
                parts = [p for p in self.path.split("/") if p]
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    if parts and parts[0] == "setoptions":
                        db = repo._dbs.get("/".join(parts[1:]))
                        if db is None:
                            code, body = 404, {"error": "no such db"}
                        else:
                            db.set_options(payload)
                            code, body = 200, {"ok": True, "applied": payload}
                    elif parts and parts[0] == "promote":
                        code, body = repo._promote("/".join(parts[1:]))
                    elif parts and parts[0] == "shards" \
                            and len(parts) >= 3:
                        code, body = repo._shard_action(
                            "/".join(parts[1:-1]), parts[-1], payload)
                    elif parts and parts[0] == "scrub":
                        # Trigger one synchronous integrity-scrub pass:
                        # POST /scrub/<name> [{"deep": true}]
                        db = repo._dbs.get("/".join(parts[1:]))
                        if db is None:
                            code, body = 404, {"error": "no such db"}
                        else:
                            rep = db.scrub(
                                deep=bool(payload.get("deep", False)))
                            code, body = 200, {"ok": True, "report": rep}
                    else:
                        code, body = 404, {"error": "not found"}
                except NotSupported as e:  # a plane the port lacks
                    code, body = 501, {"error": str(e)}
                except (InvalidArgument, ValueError) as e:  # client's fault
                    code, body = 400, {"error": repr(e)}
                except Exception as e:  # server-side failure
                    code, body = 500, {"error": repr(e)}
                self._send_json(code, body)

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._http_thread = ccy.spawn(
            "tpt-sideplugin-http", self._server.serve_forever, owner=self,
            stop=self.stop_http)
        return self._server.server_address[1]

    def stop_http(self) -> None:
        """Stop the server and join its thread (no thread of the repo
        outlives this call), then close its socket."""
        srv = self._server
        if srv is not None:
            self._server = None
            srv.shutdown()
            self._http_thread.join()
            srv.server_close()

    def _render_view(self, name: str):
        """HTML dashboard (the rockside WebView role): / lists DBs;
        /view/<name> shows stats, levels, and the live config with an
        online-options form posting to /setoptions/<name>."""
        import html as _html

        def esc(x):
            return _html.escape(str(x))

        if not name:
            rows = "".join(
                f'<li><a href="/view/{esc(n)}">{esc(n)}</a> '
                f'(<a href="/view/traces/{esc(n)}">traces</a>)</li>'
                for n in sorted(self._dbs))
            return (f"<html><head><title>toplingdb_tpu</title></head>"
                    f"<body><h1>toplingdb_tpu repo</h1><ul>{rows}</ul>"
                    f'<p><a href="/metrics">/metrics</a> (Prometheus) · '
                    f'<a href="/dbs">/dbs</a> (JSON)</p></body></html>')
        if name.startswith("traces/"):
            return self._render_traces_view(name[len("traces/"):])
        db = self._dbs.get(name)
        if db is None:
            return None
        levels = self._route(["levels", name]) or {}
        cfg = self._configs.get(name, {})
        stats_rows = ""
        if db.stats is not None:
            tickers = db.stats.tickers()
            top = sorted(tickers.items(), key=lambda kv: -kv[1])[:30]
            stats_rows = "".join(
                f"<tr><td>{esc(k)}</td><td>{v}</td></tr>"
                for k, v in top if v)
        lvl_rows = "".join(
            f"<tr><td>{esc(lv)}</td>"
            f"<td>{len(files)} files, "
            f"{sum(f['size'] for f in files)} bytes</td></tr>"
            for lv, files in sorted(levels.items()))
        return (
            f"<html><head><title>{esc(name)}</title></head><body>"
            f"<h1>{esc(name)}</h1>"
            f"<h2>Levels</h2><table border=1>{lvl_rows}</table>"
            f"<h2>Top tickers</h2><table border=1>{stats_rows}</table>"
            f"<h2>Config</h2><pre>{esc(json.dumps(cfg, indent=1, default=str))}"
            f"</pre>"
            f"<h2>Online options</h2>"
            f"<form onsubmit=\"fetch('/setoptions/{esc(name)}',"
            f"{{method:'POST',body:this.body.value}})"
            f".then(r=>r.json()).then(j=>alert(JSON.stringify(j)));"
            f"return false\">"
            f'<textarea name="body" rows="4" cols="60">'
            f'{{"write_buffer_size": 67108864}}</textarea><br>'
            f'<input type="submit" value="Apply"></form>'
            f'<p><a href="/view">&larr; all dbs</a></p></body></html>')

    def _render_traces_view(self, name: str):
        """Waterfall rendering of recent traces (slow first): one block per
        trace, one proportional bar per span, remote spans tinted — the
        human half of the /traces JSON routes."""
        import html as _html

        db = self._dbs.get(name)
        tracer = getattr(db, "tracer", None) if db is not None else None
        if db is None or tracer is None:
            return None

        def esc(x):
            return _html.escape(str(x))

        blocks = []
        traces = tracer.finished(limit=32)
        traces.sort(key=lambda t: (not t.slow, -t.dur_us))
        for t in traces:
            total = max(1, t.dur_us,
                        max((s.start_us + s.dur_us for s in t.spans),
                            default=1))
            bars = []
            for s in t.spans:
                left = 100.0 * s.start_us / total
                width = max(0.5, 100.0 * max(1, s.dur_us) / total)
                color = "#4a90d9" if s.proc == tracer.proc else "#d98a4a"
                label = (f"{esc(s.name)} [{esc(s.proc)}] "
                         f"{s.dur_us}µs {esc(s.tags) if s.tags else ''}")
                bars.append(
                    f'<div style="position:relative;height:14px;'
                    f'margin:1px 0;font-size:10px">'
                    f'<div title="{label}" style="position:absolute;'
                    f'left:{left:.2f}%;width:{width:.2f}%;height:12px;'
                    f'background:{color}"></div>'
                    f'<span style="position:absolute;left:0">{esc(s.name)}'
                    f'</span></div>')
            slow = " ⚠ slow" if t.slow else ""
            blocks.append(
                f'<div style="border:1px solid #ccc;margin:6px;padding:4px">'
                f'<b>{esc(t.name)}</b>{slow} — {t.dur_us}µs, '
                f'{len(t.spans)} spans, procs={esc(",".join(sorted({s.proc for s in t.spans})))} '
                f'(<a href="/traces/{esc(name)}/{esc(t.trace_id)}">json</a>)'
                f'{"".join(bars)}</div>')
        st = tracer.status()
        return (
            f"<html><head><title>traces: {esc(name)}</title></head><body>"
            f"<h1>traces: {esc(name)}</h1>"
            f"<p>sample 1-in-{st['sample_every'] or '∞'}, "
            f"slow ≥ {st['slow_usec']}µs, "
            f"{st['traces_retained']} retained / "
            f"{st['traces_started']} started</p>"
            f'{"".join(blocks) or "<p>no finished traces yet</p>"}'
            f'<p><a href="/view/{esc(name)}">&larr; {esc(name)}</a>'
            f"</p></body></html>")

    def _route(self, parts: list[str], query: dict | None = None):
        query = query or {}
        if not parts or parts == ["dbs"]:
            return {"dbs": sorted(self._dbs)}
        kind, name = parts[0], "/".join(parts[1:])
        if kind in _LEFT_OUT_ROUTES:
            # /shards and /fleet: toplingdb_tpu's shard and fleet views
            # (answered 501).
            raise NotSupported(_LEFT_OUT_ROUTES[kind])
        if kind == "cluster" and name == "health":
            return self._cluster_health()
        if kind == "traces":
            # /traces/<name> (recent traces; ?slow=1 filters),
            # /traces/<name>/<trace_id> (one trace as Chrome trace JSON).
            trace_id = None
            if len(parts) >= 3:
                name, trace_id = "/".join(parts[1:-1]), parts[-1]
                if self._dbs.get(name) is None:
                    name, trace_id = "/".join(parts[1:]), None
            db = self._dbs.get(name)
            tracer = getattr(db, "tracer", None) if db is not None else None
            if db is None or tracer is None:
                return None
            if trace_id is not None:
                return tracer.chrome_trace(trace_id)
            slow_only = query.get("slow") in ("1", "true")
            return {
                "tracer": tracer.status(),
                "traces": [t.summary()
                           for t in tracer.finished(slow_only=slow_only)],
            }
        if kind == "stats_history":
            # /stats_history/<name>?window=SECONDS (0/absent = everything
            # retained in the ring).
            db = self._dbs.get(name)
            if db is None or getattr(db, "stats_history", None) is None:
                return None
            import time as _time

            start = 0
            try:
                window = int(query.get("window", 0))
            except ValueError:
                window = 0
            if window > 0:
                start = int(_time.time()) - window
            samples = db.stats_history.series(start_time=start)
            return {
                "window_sec": window or None,
                "n_samples": len(samples),
                "samples": samples,
            }
        if kind == "slo":
            # /slo/<name>: the SLO engine's burn-rate rows;
            # ?evaluate=1 forces one evaluation pass first (ops/tests).
            db = self._dbs.get(name)
            engine = getattr(db, "slo_engine", None) \
                if db is not None else None
            if engine is None:
                return None
            if query.get("evaluate") in ("1", "true"):
                engine.evaluate()
            return engine.status()
        if kind == "health":
            # /health/<name>: this member's aggregator health doc — what
            # a sibling repo's /cluster/health scrapes.
            db = self._dbs.get(name)
            if db is None:
                return None
            from toplingdb_tpu_torch.utils.slo import health_doc

            return health_doc(db, name, role=self._role_of(db))
        db = self._dbs.get(name)
        if db is None:
            return None
        if kind == "stats":
            out = {"levelstats": db.get_property("tpulsm.stats")}
            if db.stats is not None:
                out["statistics"] = db.stats.to_string().split("\n")
            return out
        if kind == "levels":
            v = db.versions.current
            return {
                f"L{lvl}": [
                    {"file": f.number, "size": f.file_size,
                     "entries": f.num_entries}
                    for f in v.files[lvl]
                ]
                for lvl in range(v.num_levels) if v.files[lvl]
            }
        if kind == "config":
            return self._configs.get(name)
        if kind == "replication":
            provider = getattr(db, "_repl_status_provider", None)
            if provider is not None:
                out = dict(provider())
            else:
                out = {
                    "role": ("standalone-readonly"
                             if getattr(db.options, "read_only", False)
                             else "primary-unshipped"),
                }
            out.setdefault("last_sequence", db.versions.last_sequence)
            return out
        if kind == "db":
            # Write-plane view: WAL_* counters with the WRITE_GROUP_*
            # family beside them (groups led, followers merged, native
            # plane commits vs fallbacks, coalesced fsyncs) plus the
            # write.group.bytes histogram and the plane's live config.
            out = {
                "write_plane_enabled": bool(
                    getattr(db, "_write_plane_knob", False)),
                "write_plane_resolved": bool(
                    getattr(db, "_write_plane", None)),
                "async_wal": getattr(db, "_wal_ring", None) is not None,
                "last_sequence": db.versions.last_sequence,
            }
            ring = getattr(db, "_wal_ring", None)
            if ring is not None:
                out["async_wal_ring"] = {
                    "appends": ring.appends, "syncs": ring.syncs,
                    "fsyncs": ring.fsyncs,
                    "fsyncs_coalesced": ring.fsyncs_coalesced,
                }
            if db.stats is not None:
                from toplingdb_tpu_torch.utils import statistics as _st

                t = db.stats.tickers()
                out["tickers"] = {
                    k: t.get(k, 0)
                    for k in (_st.WAL_BYTES, _st.WAL_SYNCS,
                              _st.WRITE_WITH_WAL,
                              _st.WRITE_GROUP_LED,
                              _st.WRITE_GROUP_FOLLOWERS,
                              _st.WRITE_GROUP_NATIVE_COMMITS,
                              _st.WRITE_GROUP_FALLBACKS,
                              _st.WRITE_GROUP_FSYNCS_COALESCED)
                }
                h = db.stats.get_histogram(_st.WRITE_GROUP_BYTES)
                out["write_group_bytes"] = {
                    "count": h.count, "avg": round(h.average, 1),
                    "p99": h.percentile(99),
                }
            return out
        if kind == "integrity":
            # Scrub progress + quarantine + mismatch counters (mirrors the
            # /replication view pattern; POST /scrub/<name> runs a pass).
            out = dict(db.scrub_status())
            out["protection_bytes_per_key"] = getattr(
                db.options, "protection_bytes_per_key", 0)
            out["file_checksum"] = getattr(db.options, "file_checksum",
                                           None)
            if db.stats is not None:
                from toplingdb_tpu_torch.utils import statistics as _st

                t = db.stats.tickers()
                out["tickers"] = {
                    k: t.get(k, 0)
                    for k in (_st.INTEGRITY_SCRUB_PASSES,
                              _st.INTEGRITY_BYTES_VERIFIED,
                              _st.INTEGRITY_CORRUPTIONS_DETECTED,
                              _st.INTEGRITY_PROTECTION_MISMATCHES)
                }
            return out
        if kind == "store":
            # Disaggregated-SST-storage view (toplingdb_tpu/storage/):
            # per-directory reference counts, cache-tier stats, backend
            # status, and the store.* ticker block.
            if not hasattr(db.env, "publish_sst"):
                return {"enabled": False}
            out = {"enabled": True}
            out.update(db.env.status())
            if db.stats is not None:
                from toplingdb_tpu_torch.utils import statistics as _st

                t = db.stats.tickers()
                out["tickers"] = {
                    k: t.get(k, 0)
                    for k in (_st.STORE_HITS, _st.STORE_MISSES,
                              _st.STORE_PUBLISHES,
                              _st.STORE_BYTES_FETCHED,
                              _st.STORE_GC_SWEPT,
                              _st.STORE_FETCH_RETRIES)
                }
            return out
        return None

    @staticmethod
    def _role_of(db) -> str:
        """Role for a local DB's health doc: whatever the replication
        plane reports, else primary/readonly."""
        provider = getattr(db, "_repl_status_provider", None)
        if provider is not None:
            try:
                return str(provider().get("role", "primary"))
            except Exception as e:
                _errors.swallow(reason="repl-role-probe", exc=e)
        return ("standalone-readonly"
                if getattr(db.options, "read_only", False) else "primary")

    # -- toplingdb_tpu's cluster, fleet and shard half -------------------

    def _fleet_gauges(self) -> str:
        raise NotSupported(_FLEET)

    def _cluster_health(self) -> dict:
        raise NotSupported(_FLEET)

    def _shard_action(self, name: str, action: str, payload: dict):
        raise NotSupported(_SHARDING)

    def _promote(self, name: str):
        """Promote a registered FollowerDB: detach it from the (dead)
        primary and reopen its directory read-write under the same name,
        on its env (the failover half of the replication plane). The
        options come from the follower's registered config without
        read_only."""
        db = self._dbs.get(name)
        if db is None:
            return 404, {"error": "no such db"}
        promote = getattr(db, "promote", None)
        if promote is None:
            return 400, {"error": f"{name} is not a follower"}
        from toplingdb_tpu_torch.db.db import DB
        from toplingdb_tpu_torch.options import Options
        from toplingdb_tpu_torch.utilities.checkpoint import _untapped

        path = promote()  # final catch-up + close; returns the directory
        opts_cfg = dict(self._configs.get(name, {}).get("options", {}))
        opts_cfg.pop("read_only", None)
        opts = options_from_config(opts_cfg) if opts_cfg else Options()
        opts.create_if_missing = False
        opts.read_only = False
        new_db = DB.open(path, opts, env=_untapped(db.env))
        self._dbs[name] = new_db
        new_db.event_logger.log("promote_finished", name=name, path=path,
                                last_sequence=new_db.versions.last_sequence)
        return 200, {"promoted": name, "path": path,
                     "last_sequence": new_db.versions.last_sequence}
