"""Primary-side WAL shipping: sequence-tagged, CRC-framed batch transport
(copied from toplingdb_tpu/replication/log_shipper.py).

The data being shipped is exactly what the primary's group commit wrote to
the WAL — WriteBatch reps, each carrying its own first sequence and count —
so followers apply bit-identical mutations at identical sequence numbers.
The shipper tails the retained WAL set (live + archived) through
db/log.py's TailingLogReader, which distinguishes a torn in-flight append
(retry next poll) from real corruption (raise), and serves any follower
from any acknowledged sequence as long as the covering WALs are retained.
When they are not, the follower gets WalRetentionGone and bootstraps from a
checkpoint (utilities/checkpoint.py), mirroring how the reference's
secondary instances fall back to a full re-open.

Frames also carry the primary's MANIFEST epoch — (manifest_file_number,
edit_seq) packed into 64 bits — so a follower sharing the directory knows
the instant it must re-read the MANIFEST (flush/compaction installed a new
version) instead of polling it.

Transport layers, smallest to largest:

  LocalTransport   direct function calls (tests; same-process replicas)
  HttpTransport    pulls frames from a ReplicationServer over HTTP with
                   the same control-plane/shared-data-plane split as
                   compaction/dcompact_service.py
  FaultyTransport  chaos wrapper driven by env/fault_injection.py's
                   ShipFaultInjector (drop/delay/truncate)
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from toplingdb_tpu_torch.db.log import TailingLogReader
from toplingdb_tpu_torch.db.write_batch import WriteBatch
from toplingdb_tpu_torch.utils import coding, crc32c
from toplingdb_tpu_torch.utils import concurrency as ccy
from toplingdb_tpu_torch.utils import errors as _errors
from toplingdb_tpu_torch.utils import statistics as stats_mod
from toplingdb_tpu_torch.utils.status import Corruption, IOError_, NotFound

FRAME_MAGIC = b"TSHP"
FRAME_VERSION = 1
# magic(4) version(1) reserved(1) epoch(8) first(8) last(8) shipped_us(8)
# n_batches(4) payload_len(4) masked_crc(4)
FRAME_HEADER_SIZE = 50


class WalRetentionGone(Exception):
    """The requested sequence range is no longer covered by retained WALs:
    the follower must bootstrap from a checkpoint (or, sharing the
    directory, re-read the MANIFEST whose SSTs cover the gap)."""


@dataclasses.dataclass
class ShipFrame:
    """One shipped unit: consecutive WriteBatch reps covering
    [first_seq, last_seq], CRC-framed as a whole so a truncated or bitflipped
    transport payload is detected before ANY batch applies."""

    epoch: int
    first_seq: int
    last_seq: int
    shipped_unix_us: int
    batches: list[bytes]

    def encode(self) -> bytes:
        payload = b"".join(
            coding.encode_fixed32(len(b)) + b for b in self.batches
        )
        crc = crc32c.mask(crc32c.value(payload))
        return (
            FRAME_MAGIC
            + bytes([FRAME_VERSION, 0])
            + coding.encode_fixed64(self.epoch)
            + coding.encode_fixed64(self.first_seq)
            + coding.encode_fixed64(self.last_seq)
            + coding.encode_fixed64(self.shipped_unix_us)
            + coding.encode_fixed32(len(self.batches))
            + coding.encode_fixed32(len(payload))
            + coding.encode_fixed32(crc)
            + payload
        )

    @staticmethod
    def decode(buf: bytes) -> "ShipFrame":
        if len(buf) < FRAME_HEADER_SIZE:
            raise Corruption(
                f"ship frame shorter than header ({len(buf)} bytes)"
            )
        if buf[:4] != FRAME_MAGIC:
            raise Corruption("ship frame bad magic")
        if buf[4] != FRAME_VERSION:
            raise Corruption(f"ship frame unknown version {buf[4]}")
        epoch = coding.decode_fixed64(buf, 6)
        first = coding.decode_fixed64(buf, 14)
        last = coding.decode_fixed64(buf, 22)
        shipped = coding.decode_fixed64(buf, 30)
        n_batches = coding.decode_fixed32(buf, 38)
        payload_len = coding.decode_fixed32(buf, 42)
        stored_crc = coding.decode_fixed32(buf, 46)
        payload = buf[FRAME_HEADER_SIZE : FRAME_HEADER_SIZE + payload_len]
        if len(payload) != payload_len:
            raise Corruption("ship frame truncated payload")
        if crc32c.unmask(stored_crc) != crc32c.value(payload):
            raise Corruption("ship frame checksum mismatch")
        batches: list[bytes] = []
        off = 0
        for _ in range(n_batches):
            if off + 4 > payload_len:
                raise Corruption("ship frame batch count overruns payload")
            ln = coding.decode_fixed32(payload, off)
            off += 4
            if off + ln > payload_len:
                raise Corruption("ship frame batch length overruns payload")
            batches.append(bytes(payload[off : off + ln]))
            off += ln
        return ShipFrame(epoch=epoch, first_seq=first, last_seq=last,
                         shipped_unix_us=shipped, batches=batches)


def pack_epoch(manifest_file_number: int, edit_seq: int) -> int:
    return ((manifest_file_number & 0xFFFFFFFF) << 32) | (
        edit_seq & 0xFFFFFFFF)


class LogShipper:
    """Tails the primary's retained WALs into an in-order cache of
    (first_seq, last_seq, rep) batch records and cuts ShipFrames from it.
    The cache holds only records whose source WAL is still retained, so
    its memory is bounded by WAL retention — and so `frames_since` fails
    with WalRetentionGone exactly when the WALs could no longer serve the
    request either."""

    def __init__(self, db, statistics=None, max_frame_bytes: int = 1 << 20):
        self.db = db
        self.stats = statistics if statistics is not None else db.stats
        self.max_frame_bytes = max_frame_bytes
        self._mu = ccy.Lock("log_shipper.LogShipper._mu")
        self._tails: dict[int, TailingLogReader] = {}
        # (first_seq, last_seq, rep, wal_number), ascending by sequence.
        self._records: list[tuple[int, int, bytes, int]] = []
        self.frames_shipped = 0
        self.bytes_shipped = 0
        db._repl_status_provider = self.status

    # -- epoch ----------------------------------------------------------

    def epoch(self) -> int:
        vs = self.db.versions
        return pack_epoch(vs.manifest_file_number,
                          getattr(vs, "edit_seq", 0))

    def state(self) -> dict:
        return {
            "epoch": self.epoch(),
            "last_sequence": self.db.versions.last_sequence,
            "wal_floor_seq": self._records[0][0] if self._records else None,
        }

    # -- WAL tailing ----------------------------------------------------

    def _poll_wals(self) -> None:
        wals = self.db.get_wal_files()  # (number, path, archived), sorted
        live = {num for num, _, _ in wals}
        for num in list(self._tails):
            if num not in live:
                del self._tails[num]
        if self._records and any(r[3] not in live for r in self._records):
            self._records = [r for r in self._records if r[3] in live]
        newest = max(live) if live else None
        last_cached = self._records[-1][1] if self._records else 0
        for num, path, archived in wals:
            tr = self._tails.get(num)
            if tr is None:
                tr = TailingLogReader(self.db.env, path, log_number=num)
                self._tails[num] = tr
            # A WAL below the newest number (or archived) will never grow:
            # a torn tail there is a dead tail, not an in-flight append.
            final = archived or num != newest
            try:
                recs = tr.poll(final=final)
            except NotFound:
                self._tails.pop(num, None)  # GC'd mid-poll: drop the tail
                continue
            for rec in recs:
                b = WriteBatch(rec)
                cnt = b.count()
                if cnt == 0:
                    continue
                s0 = b.sequence()
                s1 = s0 + cnt - 1
                if s1 <= last_cached:
                    continue  # duplicate coverage (recycled-file residue)
                self._records.append((s0, s1, rec, num))
                last_cached = s1

    # -- frame service ---------------------------------------------------

    def frames_since(self, since_seq: int | None,
                     max_bytes: int = 1 << 22) -> tuple[list[ShipFrame], dict]:
        """Frames covering every retained batch with last_seq > since_seq
        (bounded by max_bytes), plus the primary state. `since_seq=None`
        means 'from the oldest retained record' — the follower just
        reloaded the MANIFEST, whose SSTs cover everything older.
        Raises WalRetentionGone when sequences after since_seq have been
        GC'd from the WAL set."""
        with self._mu:
            self._poll_wals()
            state = self.state()
            recs = self._records
            if since_seq is None:
                start = 0
            else:
                lo, hi = 0, len(recs)
                while lo < hi:  # first record with last_seq > since_seq
                    mid = (lo + hi) // 2
                    if recs[mid][1] <= since_seq:
                        lo = mid + 1
                    else:
                        hi = mid
                start = lo
                if start == len(recs):
                    if since_seq < state["last_sequence"] and not recs:
                        # Everything newer was flushed AND its WALs GC'd.
                        raise WalRetentionGone(
                            f"no retained WAL covers seq > {since_seq}"
                        )
                    return [], state
                if recs[start][0] > since_seq + 1:
                    raise WalRetentionGone(
                        f"WAL retention starts at seq {recs[start][0]}, "
                        f"follower needs {since_seq + 1}"
                    )
            frames: list[ShipFrame] = []
            shipped_us = int(time.time() * 1e6)
            batches: list[bytes] = []
            first = last = None
            size = 0
            total = 0

            def cut() -> None:
                nonlocal batches, first, last, size
                if batches:
                    frames.append(ShipFrame(
                        epoch=state["epoch"], first_seq=first, last_seq=last,
                        shipped_unix_us=shipped_us, batches=batches))
                    batches, first, last, size = [], None, None, 0

            for s0, s1, rep, _num in recs[start:]:
                if total + len(rep) > max_bytes and total > 0:
                    break
                if size + len(rep) > self.max_frame_bytes and batches:
                    cut()
                if first is None:
                    first = s0
                last = s1
                batches.append(rep)
                size += len(rep)
                total += len(rep)
            cut()
            if frames:
                self.frames_shipped += len(frames)
                self.bytes_shipped += total
                if self.stats is not None:
                    self.stats.record_tick(
                        stats_mod.REPLICATION_FRAMES_SHIPPED, len(frames))
                    self.stats.record_tick(
                        stats_mod.REPLICATION_BYTES_SHIPPED, total)
                tracer = getattr(self.db, "tracer", None)
                if tracer is not None:
                    # Telemetry propagation: contexts of sampled writes
                    # covered by these frames ride the pull state, so the
                    # follower can record its apply spans under them.
                    ctxs = tracer.ctxs_in_range(frames[0].first_seq,
                                                frames[-1].last_seq)
                    if ctxs:
                        state["trace_ctxs"] = ctxs
            return frames, state

    def accept_spans(self, spans) -> int:
        """Follower-ack half of the telemetry plane: finished follower
        span dicts arriving with a later pull stitch into the primary's
        originating traces. Unknown/evicted trace ids drop silently."""
        tracer = getattr(self.db, "tracer", None)
        if tracer is None or not spans:
            return 0
        return tracer.attach_remote(spans)

    def status(self) -> dict:
        return {
            "role": "primary",
            "last_sequence": self.db.versions.last_sequence,
            "epoch": self.epoch(),
            "frames_shipped": self.frames_shipped,
            "bytes_shipped": self.bytes_shipped,
            "retained_records": len(self._records),
            "wal_floor_seq": self._records[0][0] if self._records else None,
        }


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------


class ReplicationTransport:
    """Follower-side view of a primary: pull frames, ask for checkpoints.
    `span_export` carries the follower's finished telemetry spans back to
    the primary piggybacked on the pull (the ship-frame ack channel) —
    fire-and-forget: a dropped pull drops the spans with it."""

    def pull(self, since_seq: int | None, max_bytes: int = 1 << 22,
             span_export=None) -> tuple[list[ShipFrame], dict]:
        raise NotImplementedError

    def request_checkpoint(self, dest: str) -> str:
        raise NotImplementedError


class LocalTransport(ReplicationTransport):
    """Same-process primary (tests; co-located replicas on shared fs)."""

    def __init__(self, shipper: LogShipper):
        self.shipper = shipper

    def pull(self, since_seq, max_bytes: int = 1 << 22, span_export=None):
        if span_export:
            self.shipper.accept_spans(span_export)
        return self.shipper.frames_since(since_seq, max_bytes=max_bytes)

    def request_checkpoint(self, dest: str) -> str:
        from toplingdb_tpu_torch.utilities.checkpoint import create_checkpoint

        create_checkpoint(self.shipper.db, dest)
        return dest


class HttpTransport(ReplicationTransport):
    """Pulls frames from a ReplicationServer. Control plane over HTTP,
    bulk data (checkpoints) over the shared filesystem — the same split as
    the dcompact service.

    Failure policy reuses the dcompact boundary's (resilience.py): every
    request carries a per-attempt timeout (a hung peer can no longer wedge
    the calling router thread indefinitely), network-level failures get a
    bounded exponential-backoff retry, and a per-URL CircuitBreaker makes
    a dead primary fail FAST after `breaker_failure_threshold` strikes
    instead of paying the timeout on every pull. HTTP-level answers are
    authoritative (the peer is alive): 410 maps to WalRetentionGone, other
    codes to IOError_ — neither is retried here."""

    def __init__(self, url: str, timeout: float = 30.0, options=None):
        from toplingdb_tpu_torch.compaction.resilience import (
            CircuitBreaker,
            DcompactOptions,
        )

        self.url = url.rstrip("/")
        self.timeout = timeout
        self.options = options or DcompactOptions(
            max_attempts=3, backoff_base=0.05, attempt_timeout=timeout,
            breaker_reset_timeout=5.0)
        self.breaker = CircuitBreaker(
            failure_threshold=self.options.breaker_failure_threshold,
            reset_timeout=self.options.breaker_reset_timeout)

    def _post(self, path: str, body: dict) -> dict:
        data = json.dumps(body).encode()
        last_err: Exception | None = None
        for attempt in range(1, self.options.max_attempts + 1):
            if not self.breaker.allow():
                raise IOError_(
                    f"replication peer {self.url} circuit open "
                    f"(consecutive failures "
                    f">= {self.breaker.failure_threshold})")
            req = urllib.request.Request(
                self.url + path, data=data,
                headers={"Content-Type": "application/json"},
                method="POST")
            try:
                with urllib.request.urlopen(
                        req, timeout=min(self.timeout,
                                         self.options.attempt_timeout)) as r:
                    out = json.loads(r.read())
                self.breaker.on_success()
                return out
            except urllib.error.HTTPError as e:
                # The peer ANSWERED: it is alive (breaker success), and the
                # answer is deterministic — retrying cannot change it.
                self.breaker.on_success()
                try:
                    payload = json.loads(e.read())
                except Exception as e2:
                    _errors.swallow(reason="http-error-body-parse", exc=e2)
                    payload = {}
                if e.code == 410 or \
                        payload.get("error") == "wal_retention_gone":
                    raise WalRetentionGone(payload.get("detail", "")) from e
                raise IOError_(
                    f"replication POST {path} to {self.url}: HTTP {e.code}"
                ) from e
            except OSError as e:
                # Network-level (refused / reset / timeout): the retryable
                # class — back off and try again, up to the bound.
                self.breaker.on_failure()
                last_err = e
                if attempt < self.options.max_attempts:
                    time.sleep(self.options.backoff_delay(attempt))
        raise IOError_(
            f"replication POST {path} to {self.url} failed after "
            f"{self.options.max_attempts} attempts: {last_err}"
        ) from last_err

    def pull(self, since_seq, max_bytes: int = 1 << 22, span_export=None):
        req = {"since_seq": since_seq, "max_bytes": max_bytes}
        if span_export:
            req["spans"] = span_export
        body = self._post("/replication/pull", req)
        frames = [ShipFrame.decode(base64.b64decode(f))
                  for f in body.get("frames_b64", [])]
        return frames, body.get("state", {})

    def request_checkpoint(self, dest: str) -> str:
        body = self._post("/replication/checkpoint", {"dest": dest})
        return body.get("dest", dest)


class FaultyTransport(ReplicationTransport):
    """Chaos wrapper: injects drop/delay/truncate on pulled frames via an
    env/fault_injection.py ShipFaultInjector. Truncation is applied to the
    encoded frame bytes and re-decoded so the follower's CRC/short-frame
    detection path is what gets exercised — exactly what a flaky network
    or a crashed relay would produce."""

    def __init__(self, inner: ReplicationTransport, injector):
        self.inner = inner
        self.injector = injector

    def pull(self, since_seq, max_bytes: int = 1 << 22, span_export=None):
        plan = self.injector.plan()
        if plan == "delay":
            time.sleep(self.injector.delay_sec)
        if plan == "drop":
            # The whole exchange is lost — the ack's span export with it
            # (the primary keeps a primary-only trace; no error, no leak).
            span_export = None
        frames, state = self.inner.pull(since_seq, max_bytes=max_bytes,
                                        span_export=span_export)
        if plan == "drop":
            return [], state
        if plan == "truncate" and frames:
            mangled = self.injector.truncate_bytes(frames[0].encode())
            # Decode raises Corruption — the follower counts it and
            # re-pulls; no half-applied batch can exist.
            frames = [ShipFrame.decode(mangled)] + frames[1:]
        return frames, state

    def request_checkpoint(self, dest: str) -> str:
        return self.inner.request_checkpoint(dest)


# ---------------------------------------------------------------------------
# Primary-side HTTP service
# ---------------------------------------------------------------------------


class ReplicationServer:
    """Embeds a LogShipper behind HTTP (the dcompact_service transport
    shape): POST /replication/pull {"since_seq": N|null, "max_bytes": M} →
    {"frames_b64": [...], "state": {...}}; 410 when WAL retention can no
    longer serve the range. POST /replication/checkpoint {"dest": path}
    creates a bootstrap checkpoint on the shared filesystem. GET
    /replication/status for introspection; GET /replication/health for
    the fleet aggregator's health doc and GET /metrics for Prometheus
    text — the health plane's per-member scrape points."""

    def __init__(self, db, shipper: LogShipper | None = None):
        self.db = db
        self.shipper = shipper or LogShipper(db)
        self._server: ThreadingHTTPServer | None = None

    def _label(self) -> str:
        """Member identity for /metrics labels and the health doc: the DB
        directory's basename (the full path would bloat every series)."""
        return os.path.basename(
            str(getattr(self.db, "dbname", "")).rstrip("/")) or "primary"

    def start(self, port: int = 0, host: str = "127.0.0.1") -> int:
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code: int, body: dict):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/replication/status":
                    self._reply(200, srv.shipper.status())
                elif self.path == "/replication/health":
                    from toplingdb_tpu_torch.utils.slo import health_doc

                    try:
                        doc = health_doc(srv.db, srv._label(),
                                         role="primary")
                        doc["replication"] = srv.shipper.status()
                        self._reply(200, doc)
                    except Exception as e:
                        self._reply(500, {"error": repr(e)[:300]})
                elif self.path == "/metrics":
                    stats = getattr(srv.db, "stats", None)
                    text = stats.to_prometheus(
                        labels=f'db="{srv._label()}"'
                    ) if stats is not None else ""
                    data = text.encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    self._reply(400, {"error": "bad json"})
                    return
                try:
                    if self.path == "/replication/pull":
                        if req.get("spans"):
                            srv.shipper.accept_spans(req["spans"])
                        frames, state = srv.shipper.frames_since(
                            req.get("since_seq"),
                            max_bytes=int(req.get("max_bytes", 1 << 22)))
                        self._reply(200, {
                            "frames_b64": [
                                base64.b64encode(f.encode()).decode()
                                for f in frames
                            ],
                            "state": state,
                        })
                    elif self.path == "/replication/checkpoint":
                        from toplingdb_tpu_torch.utilities.checkpoint import (
                            create_checkpoint,
                        )

                        dest = req["dest"]
                        create_checkpoint(srv.db, dest)
                        self._reply(200, {"dest": dest})
                    else:
                        self._reply(404, {"error": "not found"})
                except WalRetentionGone as e:
                    self._reply(410, {"error": "wal_retention_gone",
                                      "detail": str(e)})
                except Exception as e:  # transport must answer, not die
                    self._reply(500, {"error": repr(e)[:300]})

        self._server = ThreadingHTTPServer((host, port), Handler)
        ccy.spawn("tpt-replication-server", self._server.serve_forever,
                  owner=self, stop=self.stop)
        return self._server.server_address[1]

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server = None
