"""Block-cache trace analyzer CLI (copied from
toplingdb_tpu/tools/block_cache_analyzer.py; RocksDB's
tools/block_cache_analyzer/block_cache_trace_analyzer.cc).

Reads the JSONL access trace written by utils.cache.BlockCacheTracer and
reports hit ratio, reuse distribution (how many blocks are accessed once /
twice / more), the hottest blocks, and a per-second miss-ratio timeline.

Usage:
  python -m toplingdb_tpu_torch.tools.block_cache_analyzer TRACE [--json]
      [-n TOPN]
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter


def analyze(trace_path: str, top_n: int | None = 10) -> dict:
    """top_n=None returns EVERY block in hottest_blocks (callers that
    need full coverage, e.g. the legacy aggregate wrapper)."""
    hits = misses = 0
    per_key = Counter()
    key_misses = Counter()
    timeline: dict[int, list[int]] = {}
    with open(trace_path) as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            k = rec["key"]
            per_key[k] += 1
            sec = rec.get("ts_us", 0) // 1_000_000
            bucket = timeline.setdefault(sec, [0, 0])  # [hits, misses]
            if rec["hit"]:
                hits += 1
                bucket[0] += 1
            else:
                misses += 1
                key_misses[k] += 1
                bucket[1] += 1
    total = hits + misses
    reuse = Counter(per_key.values())
    return {
        "accesses": total,
        "hits": hits,
        "misses": misses,
        "hit_ratio": round(hits / total, 4) if total else 0.0,
        "unique_blocks": len(per_key),
        "accessed_once": reuse.get(1, 0),
        "accessed_2_to_10": sum(c for n, c in reuse.items() if 2 <= n <= 10),
        "accessed_over_10": sum(c for n, c in reuse.items() if n > 10),
        "hottest_blocks": [
            {"key": k, "accesses": c, "misses": key_misses.get(k, 0)}
            for k, c in per_key.most_common(top_n)
        ],  # most_common(None) = all, count-sorted
        "miss_ratio_timeline": [
            {"second": s, "accesses": h + m,
             "miss_ratio": round(m / (h + m), 4) if h + m else 0.0}
            for s, (h, m) in sorted(timeline.items())
        ],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="block_cache_analyzer",
        description="Analyze a toplingdb_tpu block-cache access trace",
    )
    ap.add_argument("trace")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("-n", "--top-n", type=int, default=10)
    args = ap.parse_args(argv)
    report = analyze(args.trace, args.top_n)
    if args.json:
        print(json.dumps(report, indent=1))
        return 0
    print(f"accesses         {report['accesses']}")
    print(f"hit ratio        {report['hit_ratio']:.2%} "
          f"({report['hits']} hits / {report['misses']} misses)")
    print(f"unique blocks    {report['unique_blocks']} "
          f"(once {report['accessed_once']}, 2-10 "
          f"{report['accessed_2_to_10']}, >10 {report['accessed_over_10']})")
    print("hottest blocks:")
    for e in report["hottest_blocks"]:
        print(f"  {e['accesses']:>7} accesses ({e['misses']} misses)  "
              f"{e['key'][:48]}")
    if len(report["miss_ratio_timeline"]) > 1:
        print("miss ratio timeline:")
        for b in report["miss_ratio_timeline"][:20]:
            print(f"  t={b['second']} accesses={b['accesses']} "
                  f"miss_ratio={b['miss_ratio']:.2%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
