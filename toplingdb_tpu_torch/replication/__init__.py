"""Replication plane: WAL shipping, follower DBs, bounded-staleness routing
(copied from toplingdb_tpu/replication/).

The serving-scale counterpart of distributed compaction (ROADMAP north
star): dcompact moves compaction work OFF the primary; this package moves
read traffic off it. Three pieces:

  log_shipper   primary side — tails the live WAL(s) into sequence-tagged,
                CRC-framed batches; serves them to followers over a local
                call or the dcompact-style HTTP control plane; tracks the
                MANIFEST epoch so followers know when to re-read it.
  follower      FollowerDB(SecondaryDB) — continuous tail/apply loop with
                version swap on primary flush/compaction and automatic
                checkpoint bootstrap when lag outruns WAL retention.
  router        ReplicaRouter — fans get/multi_get/iterators across
                followers under read-your-writes staleness tokens, with
                breaker/health-aware replica selection reusing
                compaction/resilience.py primitives.
"""

from toplingdb_tpu_torch.replication.follower import FollowerDB
from toplingdb_tpu_torch.replication.log_shipper import (
    FaultyTransport,
    HttpTransport,
    LocalTransport,
    LogShipper,
    ReplicationServer,
    ShipFrame,
    WalRetentionGone,
)
from toplingdb_tpu_torch.replication.router import (
    ReplicaRouter,
    RouterOptions,
    StalenessToken,
)

__all__ = [
    "FaultyTransport",
    "FollowerDB",
    "HttpTransport",
    "LocalTransport",
    "LogShipper",
    "ReplicaRouter",
    "ReplicationServer",
    "RouterOptions",
    "ShipFrame",
    "StalenessToken",
    "WalRetentionGone",
]
