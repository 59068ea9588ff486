"""dcompact worker service: HTTP job submission over shared storage (copied
from toplingdb_tpu/compaction/dcompact_service.py).

The transport shape of ToplingDB's distributed compaction (a curl control
plane and an NFS data plane; CompactionExecutorFactory::JobUrl in
compaction_executor.h): a worker host runs `DcompactWorkerService`, one
process per card, and the DB side's `HttpCompactionExecutorFactory` POSTs
{"job_dir": ...} to /dcompact and waits for the CompactionResults. Bulk
data (input SSTs, output SSTs, params and results JSON) moves through the
shared filesystem. A DB on a shared SST store (Options.shared_store)
submits store-mode jobs: their params carry `store_spec` and
`input_addrs` through the service unchanged, the worker fetches the
inputs from the store and publishes the outputs back, and the job dir
holds only the params and results JSON.

Worker:  python -m toplingdb_tpu_torch.compaction.dcompact_service \
             --port 8080 [--host H] [--device cuda] [--workers 1] [--chips N]

The service runs each job with `worker.run_job` on its device: "cuda"
(the default; the card, raising without one), "cpu-jax" (the kernels'
plain versions) or "cpu" (the per-entry CompactionIterator). It prints
the port it bound, so `--port 0` takes a free one.

Multi-card packing (`--chips N`): the host owns N cards, each a failure
domain behind its own circuit breaker (the DB side's
WorkerHealthRegistry, keyed "chip:<i>"). A job is admitted with as many
healthy free cards as the pool can grant and runs the mesh route over
them (`run_job(mesh_devices=...)`; the reference exports its grant
through os.environ); a wedged card demotes later jobs to fewer cards,
down to one, instead of stalling the queue. Per-card queue depths ride
/metrics and /stats.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from toplingdb_tpu_torch.compaction.executor import (
    CompactionExecutorFactory,
    SubprocessCompactionExecutor,
    _check_remote_device,
)
import time

from toplingdb_tpu_torch.utils.status import IOError_
from toplingdb_tpu_torch.utils import concurrency as ccy


class ChipPool:
    """Per-card work queues and card-count-aware job admission for one
    worker host. `admit()` targets the least-loaded healthy cards and
    gang-waits for them; a card that wedges while a job queues is dropped
    from the grant (fewer-card demotion), and a grant that times out takes
    the subset that is free now, so a dead card degrades throughput, never
    progress. Card health is the breaker machinery the DB side uses for
    worker URLs, keyed "chip:<i>"."""

    def __init__(self, chips: int, policy=None):
        from toplingdb_tpu_torch.compaction.resilience import (
            DcompactOptions,
            WorkerHealthRegistry,
        )

        self.chips = ["chip:%d" % i for i in range(max(1, chips))]
        self.health = WorkerHealthRegistry(policy or DcompactOptions())
        self._cv = ccy.Condition("dcompact_service.ChipPool._cv")
        self._busy: set[str] = set()
        # Granted-but-unreleased plus queued-targeting counts per card:
        # the /metrics queue-depth gauge.
        self._depth = {c: 0 for c in self.chips}

    def _healthy(self) -> list[str]:
        return [c for c in self.chips if self.health.breaker(c).allow()]

    def _pick_targets(self, want: int) -> list[str]:
        healthy = self._healthy()
        healthy.sort(key=lambda c: self._depth[c])
        return healthy[: max(0, want)]

    def admit(self, want: int | None = None,
              timeout: float = 30.0) -> list[str]:
        """Block until the targeted cards are free; returns the granted
        list (possibly smaller than `want`: demotion), or [] when no
        healthy card exists (the job runs on one device)."""
        want = len(self.chips) if want is None else max(1, want)
        deadline = time.monotonic() + max(0.0, timeout)
        with self._cv:
            target = self._pick_targets(want)
            for c in target:
                self._depth[c] += 1
            while True:
                healthy = set(self._healthy())
                alive = [c for c in target if c in healthy]
                if len(alive) < len(target):
                    # Wedged while queued: demote to the survivors.
                    for c in set(target) - set(alive):
                        self._depth[c] -= 1
                    target = alive
                if not target:
                    return []
                free = [c for c in target if c not in self._busy]
                if len(free) == len(target):
                    self._busy.update(target)
                    return list(target)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    # Take what is free now rather than stall the job.
                    for c in set(target) - set(free):
                        self._depth[c] -= 1
                    self._busy.update(free)
                    return list(free)
                self._cv.wait(min(0.05, remaining))

    def release(self, grant: list[str], ok: bool = True,
                failed_chips=()) -> None:
        with self._cv:
            for c in grant:
                self._busy.discard(c)
                self._depth[c] -= 1
            self._cv.notify_all()
        # Health updates outside the pool lock (the breaker locks rank
        # below the pool's).
        for c in grant:
            if ok and c not in failed_chips:
                self.health.record_success(c)
            else:
                self.health.record_failure(c)

    def queue_depths(self) -> dict[str, int]:
        with self._cv:
            return dict(self._depth)

    def snapshot(self) -> dict:
        with self._cv:
            depths = dict(self._depth)
            busy = set(self._busy)
        health = self.health.snapshot()
        return {
            c: {"queue_depth": depths[c], "busy": c in busy,
                "state": health.get(c, {}).get("state", "closed")}
            for c in self.chips
        }


class DcompactWorkerService:
    """Hosts job execution: POST /dcompact {"job_dir": ...} runs the job in
    this process (which owns the card) and returns the results JSON.
    GET /stats, /health and /metrics for introspection."""

    def __init__(self, device: str = "cuda", max_workers: int = 1,
                 chips: int = 0):
        _check_remote_device(device)
        self.device = device
        self._sem = threading.Semaphore(max_workers)
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._counter_mu = ccy.Lock(
            "dcompact_service.DcompactWorkerService._counter_mu")
        self.jobs_done = 0
        self.jobs_failed = 0
        # Multi-card packing: chips > 0 builds the per-card admission pool;
        # 0 keeps one process per card.
        self.pool = ChipPool(chips) if chips > 0 else None

    def grant_devices(self, grant: list[str]) -> list[str] | None:
        """A grant's mesh device list: "chip:<i>" → "cuda:<i>" on the card
        ("cpu" for a "cpu-jax" service, the plain versions); None for 0 or
        1 cards (one device, never half a mesh)."""
        if len(grant) < 2:
            return None
        if self.device == "cpu-jax":
            return ["cpu"] * len(grant)
        return [f"cuda:{c.split(':')[1]}" for c in grant]

    def _run_with_chips(self, run):
        """Admit cards for one job, run it with the grant as its mesh
        device list (`run(mesh_devices)`), and feed the outcome back into
        the cards' breakers."""
        if self.pool is None:
            return run(None)
        grant = self.pool.admit()
        ok = False
        try:
            rc = run(self.grant_devices(grant))
            ok = True
            return rc
        finally:
            self.pool.release(grant, ok=ok)

    def _count(self, ok: bool) -> None:
        with self._counter_mu:
            if ok:
                self.jobs_done += 1
            else:
                self.jobs_failed += 1

    def _run(self, job_dir: str, trace_header: str | None) -> dict:
        from toplingdb_tpu_torch.compaction import worker

        with self._sem:  # one job per card at a time
            os.makedirs(job_dir, exist_ok=True)
            # The worker owns the device: override the submitted params'
            # device with this service's.
            ppath = os.path.join(job_dir, "params.json")
            with open(ppath) as pf:
                params = json.load(pf)
            dirty = False
            if params.get("device") != self.device:
                params["device"] = self.device
                dirty = True
            if trace_header and not params.get("trace"):
                # Header-carried trace context (the submitter wrote the
                # params before sampling): fold it into the job.
                try:
                    params["trace"] = json.loads(trace_header)
                    dirty = True
                except ValueError:
                    pass
            if dirty:
                with open(ppath, "w") as pf:
                    json.dump(params, pf, indent=1)
            self._run_with_chips(
                lambda mesh: worker.run_job(job_dir, mesh_devices=mesh))
        with open(os.path.join(job_dir, "results.json")) as f:
            return json.load(f)

    def _metrics(self) -> bytes:
        """Minimal Prometheus exposition of the job counters and, with a
        card pool, each card's queue depth, busy flag and breaker."""
        lines = []
        for metric, v in (("dcompact_jobs_done", self.jobs_done),
                          ("dcompact_jobs_failed", self.jobs_failed)):
            m = f"tpulsm_{metric}"
            lines.append(f"# TYPE {m} gauge")
            lines.append(f'{m}{{device="{self.device}"}} {v}')
        if self.pool is not None:
            snap = self.pool.snapshot()
            for metric, val in (
                ("dcompact_chip_queue_depth", lambda s: s["queue_depth"]),
                ("dcompact_chip_busy", lambda s: int(s["busy"])),
                ("dcompact_chip_wedged",
                 lambda s: int(s["state"] != "closed")),
            ):
                m = f"tpulsm_{metric}"
                lines.append(f"# TYPE {m} gauge")
                for chip, s in snap.items():
                    lines.append(f'{m}{{chip="{chip}"}} {val(s)}')
        return ("\n".join(lines) + "\n").encode()

    def start(self, port: int = 0, host: str = "127.0.0.1") -> int:
        svc = self

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
                if self.path == "/stats":
                    body = {
                        "device": svc.device, "jobs_done": svc.jobs_done,
                        "jobs_failed": svc.jobs_failed,
                    }
                    if svc.pool is not None:
                        body["chips"] = svc.pool.snapshot()
                    self._reply(200, body)
                elif self.path == "/health":
                    # Liveness probe for the DB side's health registry.
                    self._reply(200, {"ok": True, "device": svc.device})
                elif self.path == "/metrics":
                    data = svc._metrics()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/dcompact":
                    self._reply(404, {"error": "not found"})
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(n))
                    results = svc._run(req["job_dir"],
                                       self.headers.get("X-Tpulsm-Trace"))
                except Exception as e:  # noqa: BLE001 - a job failure is
                    # reported to the submitter as a structured error
                    svc._count(ok=False)
                    self._reply(500, {"status": f"{type(e).__name__}: {e}",
                                      "output_files": [], "stats": {}})
                    return
                svc._count(ok=True)
                self._reply(200, results)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread = ccy.spawn("tpt-dcompact-http",
                                 self._server.serve_forever, owner=self,
                                 stop=self.stop)
        return self._server.server_address[1]

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join()
            self._thread = None


class HttpCompactionExecutorFactory(CompactionExecutorFactory):
    """DB-side factory: jobs go to worker URLs round-robin through a
    per-URL circuit breaker (compaction/resilience.py): consecutive
    failures open a worker's breaker, picks skip open circuits, and a
    half-open probe re-admits a recovered worker. new_executor returns
    None when EVERY circuit is open, and the retry driver then raises at
    once. A job whose attempts all fail raises; nothing runs it locally.

    device: what the params carry ("cuda" by default; the service
    overrides it with its own)."""

    def __init__(self, worker_urls: list[str], device: str = "cuda",
                 job_root: str | None = None, timeout: float | None = None,
                 policy=None, fault_injector=None):
        from toplingdb_tpu_torch.compaction.resilience import (
            DcompactOptions,
            WorkerHealthRegistry,
        )

        _check_remote_device(device)
        self.worker_urls = list(worker_urls)
        self.device = device
        self.job_root = job_root
        self.policy = policy or DcompactOptions()
        # An explicit timeout overrides the policy's per-attempt transport
        # timeout.
        self.timeout = timeout if timeout is not None \
            else self.policy.attempt_timeout
        self.health = WorkerHealthRegistry(self.policy)
        self.fault_injector = fault_injector

    def job_url(self, job_id: int, attempt: int) -> str:
        return self.worker_urls[(job_id + attempt) % len(self.worker_urls)]

    def new_executor(self, compaction):
        url = self.health.pick(self.worker_urls)
        if url is None:
            return None  # every circuit open: the retry driver raises

        def spawn(job_dir: str, device: str) -> None:
            headers = {"Content-Type": "application/json"}
            try:
                # Cross-process trace propagation rides the control plane
                # as a header (the params.json copy serves the other
                # transports); the service folds it back into the params.
                with open(os.path.join(job_dir, "params.json")) as pf:
                    ctx = json.load(pf).get("trace")
                if ctx:
                    headers["X-Tpulsm-Trace"] = json.dumps(ctx)
            except (OSError, ValueError):
                pass
            req = urllib.request.Request(
                url + "/dcompact",
                data=json.dumps({"job_dir": job_dir}).encode(),
                headers=headers,
                method="POST",
            )
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    if r.status != 200:
                        raise IOError_(f"worker {url} HTTP {r.status}")
                    r.read()  # results also land in job_dir/results.json
            except OSError as e:
                raise IOError_(f"dcompact POST to {url} failed: {e}") from e

        ex = SubprocessCompactionExecutor(
            self.device, self.job_root, spawn=spawn, policy=self.policy,
            fault_injector=self.fault_injector,
        )
        ex.url = url
        return ex


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Serve dcompact jobs over HTTP on one device.")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--host", default="0.0.0.0",
                    help="bind address (cross-host deployments need a "
                         "non-loopback one)")
    ap.add_argument("--device", default="cuda",
                    choices=("cuda", "cpu-jax", "cpu"))
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--chips", type=int, default=0,
                    help="cards this host owns; > 0 enables multi-card "
                         "packing (per-card queues, mesh-sized jobs)")
    args = ap.parse_args(argv)
    svc = DcompactWorkerService(args.device, args.workers, chips=args.chips)
    port = svc.start(args.port, args.host)
    print(f"dcompact worker listening on {args.host}:{port} "
          f"(device={svc.device}, chips={args.chips})", flush=True)
    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    try:
        done.wait()
    except KeyboardInterrupt:
        pass
    svc.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
