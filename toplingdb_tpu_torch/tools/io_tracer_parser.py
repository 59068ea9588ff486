"""IO-trace parser CLI (copied from toplingdb_tpu/tools/io_tracer_parser.py;
the role of RocksDB's tools/io_tracer_parser_tool.cc).

Reads the JSONL IO trace written by env.io_tracer.IOTracer and reports
per-op and per-file aggregates (counts, bytes, latency).

Usage:
  python -m toplingdb_tpu_torch.tools.io_tracer_parser TRACE [--json] [-n TOPN]
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict


def parse(trace_path: str) -> dict:
    per_op: dict[str, dict] = defaultdict(
        lambda: {"count": 0, "bytes": 0, "latency_us": 0}
    )
    per_file: dict[str, dict] = defaultdict(
        lambda: {"count": 0, "bytes": 0, "latency_us": 0}
    )
    total = 0
    with open(trace_path) as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            total += 1
            for agg in (per_op[rec["op"]],
                        per_file[rec.get("path", "?")]):
                agg["count"] += 1
                agg["bytes"] += rec.get("len", 0)
                agg["latency_us"] += rec.get("latency_us", 0)
    return {
        "total_records": total,
        "per_op": dict(per_op),
        "per_file": dict(per_file),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="io_tracer_parser",
        description="Parse a toplingdb_tpu_torch IO trace",
    )
    ap.add_argument("trace")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("-n", "--top-n", type=int, default=10,
                    help="files shown, by bytes desc")
    args = ap.parse_args(argv)
    report = parse(args.trace)
    if args.json:
        print(json.dumps(report, indent=1))
        return 0
    print(f"records          {report['total_records']}")
    for op, agg in sorted(report["per_op"].items(),
                          key=lambda kv: -kv[1]["bytes"]):
        print(f"  {op:<12} count {agg['count']:>8}  bytes {agg['bytes']:>12}"
              f"  latency {agg['latency_us']}us")
    print("top files by bytes:")
    files = sorted(report["per_file"].items(),
                   key=lambda kv: -kv[1]["bytes"])[: args.top_n]
    for path, agg in files:
        print(f"  {agg['bytes']:>12}B {agg['count']:>7} ops  {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
