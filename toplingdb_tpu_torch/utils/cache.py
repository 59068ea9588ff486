"""A sharded LRU cache (copied from toplingdb_tpu/utils/cache.py:
LRUCache and its shard, which BlobSource's value cache takes; RocksDB's
cache/lru_cache.cc, cache/sharded_cache.h). The secondary tier, the block
cache in the readers, ClockCache, SimCache and the access tracer come
with a later slice."""

from __future__ import annotations

import threading
from collections import OrderedDict


class LRUCache:
    def __init__(self, capacity_bytes: int, num_shards: int = 16):
        self._shards = [_Shard(max(1, capacity_bytes // num_shards))
                        for _ in range(num_shards)]
        self._n = num_shards
        self.capacity = capacity_bytes

    def _shard(self, key: bytes) -> "_Shard":
        return self._shards[hash(key) % self._n]

    def lookup(self, key: bytes):
        return self._shard(key).lookup(key)

    def insert(self, key: bytes, value, charge: int) -> None:
        self._shard(key).insert(key, value, charge)

    def erase(self, key: bytes) -> None:
        self._shard(key).erase(key)

    def usage(self) -> int:
        return sum(s.usage for s in self._shards)

    def hit_rate(self) -> float:
        hits = sum(s.hits for s in self._shards)
        total = hits + sum(s.misses for s in self._shards)
        return hits / total if total else 0.0


class _Shard:
    def __init__(self, capacity: int):
        self._cap = capacity
        self._items: OrderedDict[bytes, tuple[object, int]] = OrderedDict()
        self.usage = 0
        self.hits = 0
        self.misses = 0
        self._mu = threading.Lock()

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
            while self.usage > self._cap and self._items:
                _, (_, c) = self._items.popitem(last=False)
                self.usage -= c

    def erase(self, key: bytes) -> None:
        with self._mu:
            old = self._items.pop(key, None)
            if old is not None:
                self.usage -= old[1]
