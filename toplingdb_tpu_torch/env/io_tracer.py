"""IO tracing Env wrapper (copied from toplingdb_tpu/env/io_tracer.py).

The role of RocksDB's IO tracer (trace_replay/io_tracer.cc and
env/file_system_tracer.{h,cc}, parsed by tools/io_tracer_parser_tool.cc):
every file operation through the wrapped Env is recorded as a JSONL line
{ts_us, op, path, offset, len, latency_us}, in the reference's format.
Thread-safe; records go to a plain local file (the trace must not recurse
through the traced Env). `tools/io_tracer_parser.py` aggregates a trace.
"""

from __future__ import annotations

import json
import time

from toplingdb_tpu_torch.env.env import Env
from toplingdb_tpu_torch.utils import concurrency as ccy


class IOTracer:
    def __init__(self, trace_path: str):
        self._f = open(trace_path, "a", buffering=1)
        self._mu = ccy.Lock("io_tracer.IOTracer._mu")
        self.num_records = 0

    def record(self, op: str, path: str, offset: int = 0, length: int = 0,
               latency_us: int = 0) -> None:
        line = json.dumps({
            "ts_us": int(time.time() * 1e6), "op": op, "path": path,
            "offset": offset, "len": length, "latency_us": latency_us,
        })
        with self._mu:
            self._f.write(line + "\n")
            self.num_records += 1

    def close(self) -> None:
        with self._mu:
            self._f.close()


def parse_io_trace(trace_path: str) -> dict:
    """Aggregate an IO trace (the io_tracer_parser role): per-op counts,
    bytes, and latency totals. Delegates to the CLI parser so there is
    exactly ONE parse loop (tools/io_tracer_parser.py)."""
    from toplingdb_tpu_torch.tools.io_tracer_parser import parse

    return parse(trace_path)["per_op"]


class _TracedWritable:
    def __init__(self, f, path: str, tracer: IOTracer):
        self._f = f
        self._path = path
        self._t = tracer

    def append(self, data: bytes) -> None:
        t0 = time.time()
        self._f.append(data)
        self._t.record("append", self._path, self._f.file_size() - len(data),
                       len(data), int((time.time() - t0) * 1e6))

    def flush(self) -> None:
        self._f.flush()

    def sync(self) -> None:
        t0 = time.time()
        self._f.sync()
        self._t.record("sync", self._path, 0, 0,
                       int((time.time() - t0) * 1e6))

    def close(self) -> None:
        self._f.close()
        self._t.record("close", self._path)

    def file_size(self) -> int:
        return self._f.file_size()


class _TracedRandomAccess:
    def __init__(self, f, path: str, tracer: IOTracer):
        self._f = f
        self._path = path
        self._t = tracer

    def read(self, offset: int, n: int) -> bytes:
        t0 = time.time()
        out = self._f.read(offset, n)
        self._t.record("read", self._path, offset, len(out),
                       int((time.time() - t0) * 1e6))
        return out

    def size(self) -> int:
        return self._f.size()

    def close(self) -> None:
        self._f.close()


class IOTracingEnv(Env):
    """Wraps any Env; file handles record their IO into the tracer."""

    def __init__(self, base: Env, tracer: IOTracer):
        self.base = base
        self.tracer = tracer

    def new_writable_file(self, path: str):
        self.tracer.record("new_writable", path)
        return _TracedWritable(self.base.new_writable_file(path), path,
                               self.tracer)

    def new_random_access_file(self, path: str):
        self.tracer.record("open_random", path)
        return _TracedRandomAccess(
            self.base.new_random_access_file(path), path, self.tracer
        )

    def new_sequential_file(self, path: str):
        self.tracer.record("open_sequential", path)
        return self.base.new_sequential_file(path)

    def file_exists(self, path: str) -> bool:
        return self.base.file_exists(path)

    def get_free_space(self, path: str) -> int:
        return self.base.get_free_space(path)

    def get_file_size(self, path: str) -> int:
        return self.base.get_file_size(path)

    def delete_file(self, path: str) -> None:
        self.tracer.record("delete", path)
        self.base.delete_file(path)

    def rename_file(self, src: str, dst: str) -> None:
        self.tracer.record("rename", src)
        self.base.rename_file(src, dst)

    def create_dir(self, path: str) -> None:
        self.base.create_dir(path)

    def get_children(self, path: str) -> list[str]:
        return self.base.get_children(path)

    def read_file(self, path: str) -> bytes:
        t0 = time.time()
        out = self.base.read_file(path)
        self.tracer.record("read_file", path, 0, len(out),
                           int((time.time() - t0) * 1e6))
        return out

    def write_file(self, path: str, data: bytes, sync: bool = False) -> None:
        self.tracer.record("write_file", path, 0, len(data))
        self.base.write_file(path, data, sync=sync)
