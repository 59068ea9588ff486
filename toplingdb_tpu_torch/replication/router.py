"""ReplicaRouter: bounded-staleness read fan-out over follower DBs (copied
from toplingdb_tpu/replication/router.py).

Read-your-writes without synchronous replication: every write through the
router returns a staleness token (the batch's last published sequence —
DB.write's return value); a token-carrying read is served only by replicas
whose applied sequence has reached the token, falling back to the primary
when none has. Token-less reads accept any healthy follower, optionally
bounded by `max_lag_seq` behind the primary.

Replica health reuses the dcompact resilience primitives
(compaction/resilience.py): one CircuitBreaker per follower via a
WorkerHealthRegistry — a follower that throws on reads trips its breaker
after `breaker_failure_threshold` consecutive failures, gets skipped until
the reset timeout, and is re-admitted through a half-open probe read.
"""

from __future__ import annotations

import dataclasses

from toplingdb_tpu_torch.compaction.resilience import (
    DcompactOptions,
    WorkerHealthRegistry,
)
from toplingdb_tpu_torch.options import ReadOptions, WriteOptions
from toplingdb_tpu_torch.utils import concurrency as ccy
from toplingdb_tpu_torch.utils import errors as _errors
from toplingdb_tpu_torch.utils import statistics as stats_mod

_DEFAULT_READ = ReadOptions()
_DEFAULT_WRITE = WriteOptions()


@dataclasses.dataclass
class RouterOptions:
    # Token-less reads skip followers more than this many sequences behind
    # the primary (None = any applied watermark is acceptable).
    max_lag_seq: int | None = None
    # Breaker policy for follower read errors.
    breaker_failure_threshold: int = 3
    breaker_reset_timeout: float = 5.0


@dataclasses.dataclass(frozen=True)
class StalenessToken:
    """Read-your-writes token: the write's last published sequence plus the
    epoch of the replica set that produced it. A token whose epoch no
    longer matches the router's current epoch is REJECTED — the read is
    re-routed to the primary — never silently served by a follower whose
    applied watermark happens to satisfy the (now meaningless) sequence.
    The sharding plane stamps shard epochs here, so a split/merge/migration
    invalidates every outstanding token for the moved range cleanly."""

    seq: int
    epoch: int = 0


class ReplicaRouter:
    """Fans reads across followers; writes go to the primary and return
    staleness tokens. Pass the token back into get/multi_get/new_iterator
    for read-your-writes. `epoch_provider` (a callable returning the
    replica set's current epoch) arms the StalenessToken epoch check; when
    None, bare integer sequence tokens keep their original meaning."""

    def __init__(self, primary, followers=(), options: RouterOptions | None
                 = None, statistics=None, epoch_provider=None):
        self.primary = primary
        self.options = options or RouterOptions()
        self.stats = statistics if statistics is not None else primary.stats
        self._mu = ccy.Lock("router.ReplicaRouter._mu")
        self._followers: list = list(followers)
        self._rr = 0
        self._epoch_provider = epoch_provider
        self.health = WorkerHealthRegistry(DcompactOptions(
            breaker_failure_threshold=self.options.breaker_failure_threshold,
            breaker_reset_timeout=self.options.breaker_reset_timeout,
        ))

    # -- membership ------------------------------------------------------

    def add_follower(self, follower) -> None:
        with self._mu:
            self._followers.append(follower)

    def remove_follower(self, follower) -> None:
        with self._mu:
            self._followers = [f for f in self._followers
                               if f is not follower]

    def _label(self, follower) -> str:
        return f"replica-{id(follower):x}"

    # -- write path (primary) -------------------------------------------

    def put(self, key: bytes, value: bytes,
            opts: WriteOptions = _DEFAULT_WRITE, cf=None) -> int:
        return self.primary.put(key, value, opts, cf=cf)

    def delete(self, key: bytes, opts: WriteOptions = _DEFAULT_WRITE,
               cf=None) -> int:
        return self.primary.delete(key, opts, cf=cf)

    def merge(self, key: bytes, value: bytes,
              opts: WriteOptions = _DEFAULT_WRITE, cf=None) -> int:
        return self.primary.merge(key, value, opts, cf=cf)

    def write(self, batch, opts: WriteOptions = _DEFAULT_WRITE) -> int:
        return self.primary.write(batch, opts)

    def latest_token(self) -> int:
        return self.primary.latest_sequence_number()

    def current_epoch(self) -> int:
        ep = self._epoch_provider
        return int(ep()) if ep is not None else 0

    def token(self, seq: int) -> StalenessToken:
        """Epoch-stamp a write's returned sequence into a StalenessToken."""
        return StalenessToken(seq=seq, epoch=self.current_epoch())

    # -- replica selection ----------------------------------------------

    def _tick(self, name, n=1):
        if self.stats is not None:
            self.stats.record_tick(name, n)

    def _candidates(self, token):
        """Breaker- and staleness-filtered followers, round-robin order.
        `token` is an int sequence, a StalenessToken, or None. An
        epoch-mismatched StalenessToken yields NO followers (the caller
        then re-routes to the primary, which is never stale)."""
        if isinstance(token, StalenessToken):
            if token.epoch != self.current_epoch():
                self._tick(stats_mod.ROUTER_EPOCH_REJECTS)
                return
            token = token.seq
        with self._mu:
            followers = list(self._followers)
            start = self._rr
            self._rr += 1
        n = len(followers)
        max_lag = self.options.max_lag_seq
        primary_seq = (self.primary.versions.last_sequence
                       if max_lag is not None else 0)
        for i in range(n):
            f = followers[(start + i) % n]
            applied = f.applied_sequence()
            if token is not None and applied < token:
                self._tick(stats_mod.ROUTER_STALE_SKIPS)
                continue
            if max_lag is not None and primary_seq - applied > max_lag:
                self._tick(stats_mod.ROUTER_STALE_SKIPS)
                continue
            label = self._label(f)
            if not self.health.breaker(label).allow():
                self._tick(stats_mod.ROUTER_BREAKER_SKIPS)
                continue
            yield f, label

    # -- read path -------------------------------------------------------

    def get(self, key: bytes, opts: ReadOptions = _DEFAULT_READ,
            cf=None, token=None):
        for f, label in self._candidates(token):
            try:
                v = f.get(key, opts, cf=cf)
            except Exception as e:
                _errors.swallow(reason="replica-get-failover", exc=e)
                self.health.record_failure(label)
                continue
            self.health.record_success(label)
            self._tick(stats_mod.ROUTER_FOLLOWER_READS)
            return v
        self._tick(stats_mod.ROUTER_PRIMARY_READS)
        return self.primary.get(key, opts, cf=cf)

    def multi_get(self, keys, opts: ReadOptions = _DEFAULT_READ,
                  cf=None, token=None):
        for f, label in self._candidates(token):
            try:
                out = f.multi_get(keys, opts, cf=cf)
            except Exception as e:
                _errors.swallow(reason="replica-multiget-failover", exc=e)
                self.health.record_failure(label)
                continue
            self.health.record_success(label)
            self._tick(stats_mod.ROUTER_FOLLOWER_READS, len(keys))
            return out
        self._tick(stats_mod.ROUTER_PRIMARY_READS, len(keys))
        return self.primary.multi_get(keys, opts, cf=cf)

    def multi_get_async(self, keys, opts: ReadOptions = _DEFAULT_READ,
                        cf=None, token=None):
        """Future-returning multi_get: the whole replica-routed walk
        (candidate failover + health accounting) runs on the primary DB's
        async-read executor, so a shard front door can fan sub-batches
        across many shards concurrently (env/async_reads.py)."""
        keys = list(keys)
        return self.primary._submit_async(
            lambda: self.multi_get(keys, opts, cf=cf, token=token))

    def new_iterator(self, opts: ReadOptions = _DEFAULT_READ,
                     cf=None, token=None):
        """An iterator over one token-eligible replica (an iterator is a
        point-in-time view, so it binds to a single DB). Creation errors
        trip the replica's breaker; the primary always serves as backstop."""
        for f, label in self._candidates(token):
            try:
                it = f.new_iterator(opts, cf=cf)
            except Exception as e:
                _errors.swallow(reason="replica-iter-failover", exc=e)
                self.health.record_failure(label)
                continue
            self.health.record_success(label)
            self._tick(stats_mod.ROUTER_FOLLOWER_READS)
            return it
        self._tick(stats_mod.ROUTER_PRIMARY_READS)
        return self.primary.new_iterator(opts, cf=cf)

    # -- introspection ---------------------------------------------------

    def status(self) -> dict:
        with self._mu:
            followers = list(self._followers)
        primary_seq = self.primary.versions.last_sequence
        return {
            "role": "router",
            "primary_sequence": primary_seq,
            "followers": [
                {
                    "label": self._label(f),
                    "applied_sequence": f.applied_sequence(),
                    "lag_seq": max(0, primary_seq - f.applied_sequence()),
                }
                for f in followers
            ],
            "health": self.health.snapshot(),
        }
