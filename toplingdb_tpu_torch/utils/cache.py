"""Block cache (copied from toplingdb_tpu/utils/cache.py): a sharded LRU
(RocksDB's cache/lru_cache.cc, cache/sharded_cache.h), a CLOCK cache, a
compressed in-RAM secondary tier, a capacity simulator and an access
tracer. A primary with a secondary tier (`secondary=`: a
CompressedSecondaryCache or a utils.persistent_cache.PersistentCache)
spills evicted byte values to it and promotes its hits back on a miss.
Plugged into the table readers via TableCache(block_cache=...), and into
BlobSource as the blob value cache."""

from __future__ import annotations


from collections import OrderedDict
from toplingdb_tpu_torch.utils import concurrency as ccy


class BlockCacheTracer:
    """Access-trace hook (RocksDB's trace_replay/block_cache_tracer.cc +
    tools/block_cache_analyzer): JSONL records of every cache lookup."""

    def __init__(self, trace_path: str):
        import json
        import time

        self._json = json
        self._time = time
        self._f = open(trace_path, "a", buffering=1)
        self._mu = ccy.Lock("cache.BlockCacheTracer._mu")

    def record_access(self, key: bytes, hit: bool) -> None:
        line = self._json.dumps({
            "ts_us": int(self._time.time() * 1e6),
            "key": key.hex(), "hit": hit,
        })
        with self._mu:
            self._f.write(line + "\n")

    def close(self) -> None:
        self._f.close()


def analyze_block_cache_trace(trace_path: str) -> dict:
    """Aggregate hit/miss counts + per-key-prefix reuse (the
    block_cache_analyzer role). Delegates to the CLI analyzer so there is
    exactly ONE aggregation loop (tools/block_cache_analyzer.py)."""
    from toplingdb_tpu_torch.tools.block_cache_analyzer import analyze

    r = analyze(trace_path, top_n=None)
    per_file: dict[str, int] = {}
    for e in r["hottest_blocks"]:
        per_file[e["key"][:32]] = per_file.get(e["key"][:32], 0) + e["accesses"]
    return {"hits": r["hits"], "misses": r["misses"],
            "hit_ratio": r["hit_ratio"],
            "accesses_per_file_prefix": per_file}


def _spill_fn(secondary):
    """Adapt secondary.insert to the (key, value, charge) spill callback:
    charge-aware secondaries record the primary's charge; legacy 2-arg
    tiers just drop it."""
    import inspect

    ins = secondary.insert
    try:
        takes_charge = len(inspect.signature(ins).parameters) >= 3
    except (TypeError, ValueError):
        takes_charge = False
    if takes_charge:
        return ins
    return lambda k, v, c: ins(k, v)


def _secondary_hit(secondary, key):
    """(value, charge) from the secondary, or None. The charge is the
    secondary's RECORDED charge when it tracks one (lookup_with_charge);
    otherwise len(value) for raw bytes, and None for non-bytes values —
    promotion with an unknown charge would under-account the shard
    budget, so those are served without promoting."""
    lw = getattr(secondary, "lookup_with_charge", None)
    if lw is not None:
        return lw(key)
    v = secondary.lookup(key)
    if v is None:
        return None
    charge = len(v) if isinstance(v, (bytes, bytearray, memoryview)) else None
    return v, charge


class LRUCache:
    def __init__(self, capacity_bytes: int, num_shards: int = 16,
                 secondary=None, tracer: BlockCacheTracer | None = None):
        self._shards = [
            _Shard(max(1, capacity_bytes // num_shards),
                   spill=_spill_fn(secondary) if secondary is not None
                   else None)
            for _ in range(num_shards)
        ]
        self._n = num_shards
        self.capacity = capacity_bytes
        self.secondary = secondary
        self.tracer = tracer

    def _shard(self, key: bytes) -> "_Shard":
        return self._shards[hash(key) % self._n]

    def lookup(self, key: bytes):
        v = self._shard(key).lookup(key)
        if v is None and self.secondary is not None:
            hit = _secondary_hit(self.secondary, key)
            if hit is not None:
                v, charge = hit
                if charge is not None:
                    self._shard(key).insert(key, v, charge)  # promote
        if self.tracer is not None:
            self.tracer.record_access(key, v is not None)
        return v

    def insert(self, key: bytes, value, charge: int) -> None:
        self._shard(key).insert(key, value, charge)

    def erase(self, key: bytes) -> None:
        self._shard(key).erase(key)
        if self.secondary is not None:
            erase = getattr(self.secondary, "erase", None)
            if erase is not None:
                erase(key)  # or the secondary would resurrect the entry

    def usage(self) -> int:
        return sum(s.usage for s in self._shards)

    def hit_rate(self) -> float:
        hits = sum(s.hits for s in self._shards)
        total = hits + sum(s.misses for s in self._shards)
        return hits / total if total else 0.0


class ClockCache:
    """CLOCK-eviction cache (RocksDB's cache/clock_cache.cc HyperClockCache
    role): a ring of slots with reference bits — lookups only SET a bit (no
    list reordering, far less lock work than LRU), eviction sweeps the clock
    hand clearing bits until it finds a cold slot. Same surface as LRUCache
    (lookup/insert/erase/usage/hit_rate + optional secondary tier)."""

    def __init__(self, capacity_bytes: int, secondary=None, tracer=None):
        self._cap = capacity_bytes
        self._slots: dict[bytes, list] = {}  # key -> [value, charge, refbit]
        self._ring: list[bytes] = []
        self._hand = 0
        self._usage = 0
        self._mu = ccy.Lock("cache.ClockCache._mu")
        self.hits = 0
        self.misses = 0
        self.secondary = secondary
        self._spill = _spill_fn(secondary) if secondary is not None else None
        self.tracer = tracer

    def lookup(self, key: bytes):
        slot = self._slots.get(key)
        if slot is not None:
            slot[2] = 1  # reference bit: no lock, no reordering
            self.hits += 1
            if self.tracer is not None:
                self.tracer.record_access(key, True)
            return slot[0]
        self.misses += 1
        v = None
        if self.secondary is not None:
            hit = _secondary_hit(self.secondary, key)
            if hit is not None:
                v, charge = hit
                if charge is not None:
                    self.insert(key, v, charge)  # promote
        if self.tracer is not None:
            self.tracer.record_access(key, v is not None)
        return v

    def insert(self, key: bytes, value, charge: int) -> None:
        evicted = []
        with self._mu:
            old = self._slots.get(key)
            if old is not None:
                self._usage += charge - old[1]
                old[0], old[1], old[2] = value, charge, 1
            else:
                self._slots[key] = [value, charge, 1]
                self._ring.append(key)
                self._usage += charge
            # CLOCK sweep: clear ref bits until cold slots free the budget.
            # Bound captured ONCE — recomputing against the shrinking ring
            # could stop the sweep while cold evictable slots remain.
            spins = 0
            limit = 2 * len(self._ring) + 2
            while self._usage > self._cap and self._ring and spins < limit:
                if self._hand >= len(self._ring):
                    self._hand = 0
                k = self._ring[self._hand]
                slot = self._slots.get(k)
                if slot is None:  # lazily drop erased keys from the ring
                    self._ring.pop(self._hand)
                    continue
                if slot[2]:
                    slot[2] = 0
                    self._hand += 1
                elif k == key:
                    self._hand += 1  # never evict the entry being inserted
                else:
                    self._ring.pop(self._hand)
                    del self._slots[k]
                    self._usage -= slot[1]
                    evicted.append((k, slot[0], slot[1]))
                spins += 1
        if self._spill is not None:
            for k, v, c in evicted:
                self._spill(k, v, c)

    def erase(self, key: bytes) -> None:
        with self._mu:
            slot = self._slots.pop(key, None)
            if slot is not None:
                self._usage -= slot[1]
                try:
                    # Eager purge: lazy cleanup only runs during eviction
                    # sweeps, so under-capacity erase/re-insert churn would
                    # grow the ring without bound.
                    self._ring.remove(key)
                except ValueError:
                    pass
        if self.secondary is not None:
            erase = getattr(self.secondary, "erase", None)
            if erase is not None:
                erase(key)

    def usage(self) -> int:
        return self._usage

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class CompressedSecondaryCache:
    """In-RAM compressed tier (RocksDB's cache/compressed_secondary_cache.cc):
    evicted uncompressed blocks are zlib-compressed and kept in a bounded
    FIFO dict; hits decompress and promote back to the primary."""

    def __init__(self, capacity_bytes: int = 64 << 20, level: int = 1):
        import zlib

        self._zlib = zlib
        self._cap = capacity_bytes
        self._level = level
        # key -> (compressed, original primary charge): the recorded
        # charge rides along so promotion re-inserts with the SAME
        # accounting the primary evicted with (a charge > len(value)
        # would otherwise under-account the shard budget).
        self._items: "OrderedDict[bytes, tuple[bytes, int]]" = OrderedDict()
        self._usage = 0
        self._mu = ccy.Lock("cache.CompressedSecondaryCache._mu")
        self.hits = 0
        self.misses = 0

    def insert(self, key: bytes, value, charge: int | None = None) -> None:
        if not isinstance(value, (bytes, bytearray)):
            return
        c = self._zlib.compress(bytes(value), self._level)
        rec = (c, charge if charge is not None else len(value))
        with self._mu:
            old = self._items.pop(key, None)
            if old is not None:
                self._usage -= len(old[0])  # REPLACE: no stale bytes
            self._items[key] = rec
            self._usage += len(c)
            while self._usage > self._cap and self._items:
                _, (dropped, _ch) = self._items.popitem(last=False)
                self._usage -= len(dropped)

    def lookup_with_charge(self, key: bytes):
        """(value, recorded charge) — hit = ownership transfer: the entry
        is POPPED (the caller promotes it to the primary, as the
        RocksDB secondary cache hands its value over)."""
        with self._mu:
            rec = self._items.pop(key, None)
            if rec is not None:
                self._usage -= len(rec[0])
        if rec is None:
            self.misses += 1
            return None
        self.hits += 1
        return self._zlib.decompress(rec[0]), rec[1]

    def lookup(self, key: bytes):
        hit = self.lookup_with_charge(key)
        return None if hit is None else hit[0]

    def erase(self, key: bytes) -> None:
        with self._mu:
            rec = self._items.pop(key, None)
            if rec is not None:
                self._usage -= len(rec[0])

    def usage(self) -> int:
        return self._usage


class SimCache:
    """Cache simulator (RocksDB's utilities/simulator_cache/sim_cache.cc):
    wraps a real cache and ALSO tracks what the hit rate WOULD be at a
    different capacity — key-only ghost LRU, no values stored — so capacity
    planning doesn't need a second deployment."""

    def __init__(self, real_cache, sim_capacity_bytes: int):
        self.real = real_cache
        # Key-only ghost reuses the LRU shard (correct charge replacement
        # on re-insert, one eviction implementation) — RocksDB wraps a
        # key-only cache object the same way.
        self._ghost = _Shard(sim_capacity_bytes)
        self.sim_hits = 0
        self.sim_misses = 0

    def lookup(self, key: bytes):
        v = self.real.lookup(key)
        if self._ghost.lookup(key) is not None:
            self.sim_hits += 1
        else:
            self.sim_misses += 1
            if isinstance(v, (bytes, bytearray)):
                # Real hit the ghost had evicted: re-admit with the TRUE
                # charge. Real misses admit via the follow-up insert().
                self._ghost.insert(key, True, len(v))
        return v

    def insert(self, key: bytes, value, charge: int) -> None:
        self.real.insert(key, value, charge)
        self._ghost.insert(key, True, charge)

    def erase(self, key: bytes) -> None:
        self.real.erase(key)
        self._ghost.erase(key)

    def usage(self) -> int:
        return self.real.usage()

    def sim_hit_rate(self) -> float:
        total = self.sim_hits + self.sim_misses
        return self.sim_hits / total if total else 0.0

    def hit_rate(self) -> float:
        return self.real.hit_rate()


class _Shard:
    def __init__(self, capacity: int, spill=None):
        self._cap = capacity
        self._items: OrderedDict[bytes, tuple[object, int]] = OrderedDict()
        self.usage = 0
        self.hits = 0
        self.misses = 0
        self._mu = ccy.Lock("cache._Shard._mu")
        self._spill = spill  # spill(key, value, charge) on eviction

    def lookup(self, key: bytes):
        with self._mu:
            v = self._items.get(key)
            if v is None:
                self.misses += 1
                return None
            self._items.move_to_end(key)
            self.hits += 1
            return v[0]

    def insert(self, key: bytes, value, charge: int) -> None:
        with self._mu:
            old = self._items.pop(key, None)
            if old is not None:
                self.usage -= old[1]
            self._items[key] = (value, charge)
            self.usage += charge
            evicted = []
            while self.usage > self._cap and self._items:
                k, (v, c) = self._items.popitem(last=False)
                self.usage -= c
                evicted.append((k, v, c))
        if self._spill is not None:
            for k, v, c in evicted:
                self._spill(k, v, c)

    def erase(self, key: bytes) -> None:
        with self._mu:
            old = self._items.pop(key, None)
            if old is not None:
                self.usage -= old[1]
