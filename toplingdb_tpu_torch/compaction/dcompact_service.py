"""dcompact worker service: HTTP job submission over shared storage (copied
from toplingdb_tpu/compaction/dcompact_service.py, without the multi-chip
pool).

The transport shape of ToplingDB's distributed compaction (a curl control
plane and an NFS data plane; CompactionExecutorFactory::JobUrl in
compaction_executor.h): a worker host runs `DcompactWorkerService`, one
process per card, and the DB side's `HttpCompactionExecutorFactory` POSTs
{"job_dir": ...} to /dcompact and waits for the CompactionResults. Bulk
data (input SSTs, output SSTs, params and results JSON) moves through the
shared filesystem.

Worker:  python -m toplingdb_tpu_torch.compaction.dcompact_service \
             --port 8080 [--host H] [--device cuda] [--workers 1]

The service runs each job in its own process with `worker.run_job` on its
device: "cuda" (the default; the card, raising without one), "cpu-jax"
(the kernels' plain versions) or "cpu" (the per-entry CompactionIterator).
It prints the port it bound, so `--port 0` takes a free one.
Multi-chip packing (toplingdb_tpu's `ChipPool`, `--chips N`) is not
ported yet: `ChipPool` and `--chips` above 1 raise NotSupported (ROADMAP
A7, the mesh).
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
from toplingdb_tpu_torch.utils.status import IOError_, NotSupported
from toplingdb_tpu_torch.utils import concurrency as ccy

_CHIPS_REFUSED = ("multi-chip packing (ChipPool, --chips > 1) is not "
                  "ported yet: ROADMAP A7, the mesh")


class ChipPool:
    """toplingdb_tpu's per-chip admission pool for one worker host; it
    sizes the mesh plane to its grant, which the port does not have yet."""

    def __init__(self, chips: int, policy=None):
        raise NotSupported(_CHIPS_REFUSED)


class DcompactWorkerService:
    """Hosts job execution: POST /dcompact {"job_dir": ...} runs the job in
    this process (which owns the card) and returns the results JSON.
    GET /stats, /health and /metrics for introspection."""

    def __init__(self, device: str = "cuda", max_workers: int = 1,
                 chips: int = 0):
        _check_remote_device(device)
        if chips > 1:
            raise NotSupported(_CHIPS_REFUSED)
        self.device = device
        self._sem = threading.Semaphore(max_workers)
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._counter_mu = ccy.Lock(
            "dcompact_service.DcompactWorkerService._counter_mu")
        self.jobs_done = 0
        self.jobs_failed = 0

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
            worker.run_job(job_dir)
        with open(os.path.join(job_dir, "results.json")) as f:
            return json.load(f)

    def _metrics(self) -> bytes:
        """Minimal Prometheus exposition of the job counters."""
        lines = []
        for metric, v in (("dcompact_jobs_done", self.jobs_done),
                          ("dcompact_jobs_failed", self.jobs_failed)):
            m = f"tpulsm_{metric}"
            lines.append(f"# TYPE {m} gauge")
            lines.append(f'{m}{{device="{self.device}"}} {v}')
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
                    self._reply(200, {
                        "device": svc.device, "jobs_done": svc.jobs_done,
                        "jobs_failed": svc.jobs_failed,
                    })
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
                    help="chips this host owns; above 1 is refused "
                         "(multi-chip packing is not ported yet)")
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
