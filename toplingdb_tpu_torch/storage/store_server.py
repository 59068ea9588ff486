"""HTTP backend for the shared SST object store (copied from
toplingdb_tpu/storage/store_server.py).

`StoreServer` fronts a LocalObjectStore (GET/POST /store/*, raw payload
bodies — the dcompact/fleet transport shape: JSON control, bytes data).
`StoreClient` speaks the same interface as LocalObjectStore so
SharedSstEnv, the dcompact worker, and the GC take either interchangeably.

The client reuses the dcompact resilience stack (compaction/resilience.py):
per-request timeouts, bounded retry with exponential backoff + jitter
(DcompactOptions), and a CircuitBreaker so a dead store fails fast instead
of stacking timeouts under every table open. Every store operation is
idempotent under content addressing — a replayed put stores the same bytes
under the same name — so unlike the lease client every verb is
retry-safe."""

from __future__ import annotations

import http.client
import json
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from toplingdb_tpu_torch.compaction.resilience import (
    CircuitBreaker,
    DcompactOptions,
)
from toplingdb_tpu_torch.storage.object_store import LocalObjectStore
from toplingdb_tpu_torch.utils import concurrency as ccy
from toplingdb_tpu_torch.utils.status import (
    Corruption,
    InvalidArgument,
    IOError_,
    NotFound,
)


class StoreServer:
    """One process's store front door. Raw object bodies ride the HTTP
    payload; control verbs answer JSON. 404 means "object not present"
    (an answer, never retried by the client); 422 means the payload
    failed address verification (the uploader's bytes are wrong)."""

    def __init__(self, store: LocalObjectStore):
        self.store = store
        self._server: ThreadingHTTPServer | None = None

    def start(self, port: int = 0, host: str = "127.0.0.1") -> int:
        store = self.store

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply_json(self, code: int, body: dict):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _reply_raw(self, payload: bytes):
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/octet-stream")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                path = urllib.parse.unquote(self.path)
                try:
                    if path.startswith("/store/obj/"):
                        addr = path[len("/store/obj/"):]
                        self._reply_raw(store.fetch(addr))
                    elif path.startswith("/store/has/"):
                        addr = path[len("/store/has/"):]
                        self._reply_json(200, {
                            "present": store.contains(addr),
                            "mtime": store.object_mtime(addr),
                        })
                    elif path == "/store/list":
                        self._reply_json(
                            200, {"addresses": store.list_addresses()})
                    elif path == "/store/pins":
                        self._reply_json(
                            200, {"pinned": sorted(store.pinned())})
                    elif path == "/store/status":
                        self._reply_json(200, store.status())
                    elif path == "/health":
                        self._reply_json(200, {"ok": True, "role": "store"})
                    else:
                        self._reply_json(404, {"error": "not found"})
                except NotFound as e:
                    self._reply_json(404, {"error": str(e)})
                except Exception as e:  # transport must answer, not die
                    self._reply_json(500, {"error": repr(e)[:300]})

            def do_POST(self):
                path = urllib.parse.unquote(self.path)
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n) if n else b""
                try:
                    if path.startswith("/store/obj/"):
                        addr = path[len("/store/obj/"):]
                        self._reply_json(
                            200, {"stored": store.put(addr, body)})
                        return
                    req = json.loads(body or b"{}")
                    if path == "/store/pin":
                        store.pin(req["addr"], req.get("holder", "?"),
                                  req.get("ttl"))
                        self._reply_json(200, {"ok": True})
                    elif path == "/store/unpin":
                        store.unpin(req["addr"], req.get("holder"))
                        self._reply_json(200, {"ok": True})
                    elif path == "/store/delete":
                        self._reply_json(
                            200, {"deleted": store.delete(req["addr"])})
                    else:
                        self._reply_json(404, {"error": "not found"})
                except (Corruption, InvalidArgument) as e:
                    self._reply_json(422, {"error": str(e)})
                except ValueError:
                    self._reply_json(400, {"error": "bad json"})
                except Exception as e:
                    self._reply_json(500, {"error": repr(e)[:300]})

        self._server = ThreadingHTTPServer((host, port), Handler)
        ccy.spawn("tpt-store-server", self._server.serve_forever,
                  owner=self, stop=self.stop)
        return self._server.server_address[1]

    @property
    def port(self) -> int:
        return self._server.server_address[1] if self._server else 0

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server = None


class StoreClient:
    """LocalObjectStore-shaped client for a StoreServer URL. 404 maps to
    NotFound, 422 to Corruption (both answers, never retried); transport
    errors retry with DcompactOptions backoff behind a CircuitBreaker."""

    def __init__(self, url: str, timeout: float = 5.0,
                 options: DcompactOptions | None = None,
                 breaker: CircuitBreaker | None = None):
        self.url = url.rstrip("/")
        self.timeout = timeout
        self.options = options or DcompactOptions(
            max_attempts=3, backoff_base=0.05, attempt_timeout=timeout)
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=self.options.breaker_failure_threshold,
            reset_timeout=self.options.breaker_reset_timeout)

    def _call(self, method: str, path: str, body: bytes | None = None,
              json_body: dict | None = None) -> tuple[int, bytes]:
        import time as _t

        if not self.breaker.allow():
            raise IOError_(f"store {self.url}: circuit breaker open")
        if json_body is not None:
            body = json.dumps(json_body).encode()
        last: Exception | None = None
        for attempt in range(1, self.options.max_attempts + 1):
            if attempt > 1:
                _t.sleep(self.options.backoff_delay(attempt - 1))
            try:
                req = urllib.request.Request(
                    self.url + urllib.parse.quote(path), data=body,
                    method=method)
                with urllib.request.urlopen(req,
                                            timeout=self.timeout) as r:
                    payload = r.read()
                self.breaker.on_success()
                return r.status, payload
            except urllib.error.HTTPError as e:
                # An HTTP status is an ANSWER from a live server: the
                # breaker records success and the caller maps the code.
                payload = e.read()
                self.breaker.on_success()
                if e.code == 404:
                    raise NotFound(self._err(payload)) from e
                if e.code == 422:
                    raise Corruption(self._err(payload)) from e
                raise IOError_(
                    f"store {path}: HTTP {e.code} "
                    f"{self._err(payload)}") from e
            except (OSError, http.client.HTTPException) as e:
                last = e
        self.breaker.on_failure()
        raise IOError_(
            f"store {self.url}{path} unreachable after "
            f"{self.options.max_attempts} attempts: {last}") from last

    @staticmethod
    def _err(payload: bytes) -> str:
        try:
            return json.loads(payload).get("error", "")
        except (ValueError, AttributeError):
            return payload[:200].decode(errors="replace")

    # -- the LocalObjectStore interface --------------------------------

    def contains(self, addr: str) -> bool:
        _, payload = self._call("GET", f"/store/has/{addr}")
        return bool(json.loads(payload)["present"])

    def object_mtime(self, addr: str) -> float | None:
        _, payload = self._call("GET", f"/store/has/{addr}")
        return json.loads(payload).get("mtime")

    def fetch(self, addr: str) -> bytes:
        _, payload = self._call("GET", f"/store/obj/{addr}")
        return payload

    def put(self, addr: str, payload: bytes) -> bool:
        _, resp = self._call("POST", f"/store/obj/{addr}", body=payload)
        return bool(json.loads(resp)["stored"])

    def publish_file(self, src_path: str, addr: str, src_env=None) -> bool:
        if src_env is None:
            from toplingdb_tpu_torch.env import default_env

            src_env = default_env()
        if self.contains(addr):
            return False
        return self.put(addr, src_env.read_file(src_path))

    def delete(self, addr: str) -> bool:
        _, payload = self._call("POST", "/store/delete",
                                json_body={"addr": addr})
        return bool(json.loads(payload)["deleted"])

    def list_addresses(self) -> list[str]:
        _, payload = self._call("GET", "/store/list")
        return list(json.loads(payload)["addresses"])

    def pin(self, addr: str, holder: str, ttl: float | None = None) -> None:
        self._call("POST", "/store/pin",
                   json_body={"addr": addr, "holder": holder, "ttl": ttl})

    def unpin(self, addr: str, holder: str | None = None) -> None:
        self._call("POST", "/store/unpin",
                   json_body={"addr": addr, "holder": holder})

    def pinned(self) -> set[str]:
        _, payload = self._call("GET", "/store/pins")
        return set(json.loads(payload)["pinned"])

    def status(self) -> dict:
        _, payload = self._call("GET", "/store/status")
        doc = json.loads(payload)
        doc["backend"] = "http"
        doc["url"] = self.url
        return doc
