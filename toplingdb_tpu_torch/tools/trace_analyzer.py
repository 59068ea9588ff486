"""Workload-trace analyzer CLI (copied from
toplingdb_tpu/tools/trace_analyzer.py, whole; RocksDB's
tools/trace_analyzer_tool.cc).

Reads a trace produced by utils.trace.Tracer and reports per-op counts,
throughput over time, key/value size distributions, and the hottest keys;
optionally writes per-op key-access-count files (RocksDB's analyzer's
-output_dir artifacts for downstream modeling).

Usage:
  python -m toplingdb_tpu_torch.tools.trace_analyzer TRACE [-k TOPK]
      [--output-dir DIR] [--json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter, defaultdict

from toplingdb_tpu_torch.utils.trace import _OP_NAMES, read_trace


def _analyze_full(env, trace_path: str, top_k: int = 10):
    """(json-clean report, per-op key Counters). The single aggregation
    loop behind both the CLI and utils.trace.analyze_trace."""
    ops = Counter()
    key_hits: dict[str, Counter] = defaultdict(Counter)
    key_sizes = Counter()
    value_sizes = Counter()
    per_second = Counter()
    first_ts = last_ts = None
    total = 0
    for op, ts, slices in read_trace(env, trace_path):
        name = _OP_NAMES.get(op, str(op))
        ops[name] += 1
        total += 1
        if first_ts is None:
            first_ts = ts
        last_ts = ts
        per_second[ts // 1_000_000] += 1
        if slices:
            key_hits[name][bytes(slices[0])] += 1
            key_sizes[len(slices[0])] += 1
            if len(slices) > 1 and name in ("put", "merge"):
                value_sizes[len(slices[1])] += 1
    all_keys = Counter()
    for c in key_hits.values():
        all_keys.update(c)
    span_s = ((last_ts - first_ts) / 1e6) if total and last_ts != first_ts else 0.0
    qps = sorted(per_second.values())
    report = {
        "total_ops": total,
        "per_op": dict(ops),
        "unique_keys": len(all_keys),
        "time_span_s": round(span_s, 6),
        "avg_qps": round(total / span_s, 1) if span_s else float(total),
        "peak_qps": qps[-1] if qps else 0,
        "key_size_dist": _dist(key_sizes),
        "value_size_dist": _dist(value_sizes),
        "hottest_keys": [
            {"key": k.decode(errors="replace"), "count": c}
            for k, c in all_keys.most_common(top_k)
        ],
    }
    return report, key_hits


def analyze(env, trace_path: str, top_k: int = 10) -> dict:
    """JSON-serializable trace report."""
    return _analyze_full(env, trace_path, top_k)[0]


def _dist(c: Counter) -> dict:
    """Percentiles straight from the (size, count) pairs — O(distinct
    sizes) memory, never materializing one element per observation."""
    if not c:
        return {}
    items = sorted(c.items())
    n = sum(c.values())
    def pct(rank):  # value at 0-based rank
        cum = 0
        for size, cnt in items:
            cum += cnt
            if cum > rank:
                return size
        return items[-1][0]
    return {
        "count": n,
        "min": items[0][0],
        "p50": pct(n // 2),
        "p99": pct(min(n - 1, (n * 99) // 100)),
        "max": items[-1][0],
        "avg": round(sum(s * cnt for s, cnt in items) / n, 1),
    }


def write_key_counts(key_hits: dict, output_dir: str) -> list[str]:
    """Per-op '<op>-key_counts.txt' files: 'hex_key count' per line sorted
    by count desc (RocksDB's analyzer's key-space artifacts)."""
    os.makedirs(output_dir, exist_ok=True)
    written = []
    for op, counts in key_hits.items():
        path = os.path.join(output_dir, f"{op}-key_counts.txt")
        with open(path, "w") as f:
            for k, c in counts.most_common():
                f.write(f"{k.hex()} {c}\n")
        written.append(path)
    return written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="trace_analyzer",
        description="Analyze a toplingdb_tpu_torch workload trace",
    )
    ap.add_argument("trace")
    ap.add_argument("-k", "--top-k", type=int, default=10)
    ap.add_argument("--output-dir", default=None)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    from toplingdb_tpu_torch.env import default_env

    report, key_hits = _analyze_full(default_env(), args.trace, args.top_k)
    if args.output_dir:
        for p in write_key_counts(key_hits, args.output_dir):
            print(f"wrote {p}", file=sys.stderr)
    if args.json:
        print(json.dumps(report, indent=1))
        return 0
    print(f"total ops        {report['total_ops']}")
    print(f"unique keys      {report['unique_keys']}")
    print(f"time span        {report['time_span_s']:.3f}s "
          f"(avg {report['avg_qps']} qps, peak {report['peak_qps']})")
    for op, n in sorted(report["per_op"].items(), key=lambda kv: -kv[1]):
        print(f"  {op:<14} {n}")
    if report["key_size_dist"]:
        d = report["key_size_dist"]
        print(f"key sizes        min {d['min']} p50 {d['p50']} "
              f"p99 {d['p99']} max {d['max']}")
    if report["value_size_dist"]:
        d = report["value_size_dist"]
        print(f"value sizes      min {d['min']} p50 {d['p50']} "
              f"p99 {d['p99']} max {d['max']}")
    print("hottest keys:")
    for e in report["hottest_keys"]:
        print(f"  {e['count']:>8}  {e['key']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
