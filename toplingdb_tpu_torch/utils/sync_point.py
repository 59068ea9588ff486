"""SyncPoint (copied from toplingdb_tpu/utils/sync_point.py, whole): named
test markers with runtime callbacks and dependency edges, the
concurrency-interleaving test mechanism (RocksDB's
test_util/sync_point.h).

Production code calls sync_point("Name") / sync_point_callback("Name", arg)
at interesting spots; tests load dependencies ("A" must happen before "B")
and callbacks, then enable processing. Disabled (the default), a marker is a
dict lookup + None check — negligible.
"""

from __future__ import annotations

from toplingdb_tpu_torch.utils import concurrency as ccy


class _SyncPointRegistry:
    def __init__(self):
        self._enabled = False
        self._mu = ccy.Lock("sync_point._SyncPointRegistry._mu")
        self._cv = ccy.Condition(lock=self._mu)
        self._callbacks: dict[str, object] = {}
        self._successors: dict[str, list[str]] = {}   # A → [B]: A before B
        self._predecessors: dict[str, list[str]] = {}
        self._cleared: set[str] = set()

    def load_dependency(self, edges: list[tuple[str, str]]) -> None:
        """edges: [(before, after), ...]."""
        with self._mu:
            self._successors.clear()
            self._predecessors.clear()
            self._cleared.clear()
            for a, b in edges:
                self._successors.setdefault(a, []).append(b)
                self._predecessors.setdefault(b, []).append(a)

    def set_callback(self, name: str, fn) -> None:
        with self._mu:
            self._callbacks[name] = fn

    def clear_callback(self, name: str) -> None:
        with self._mu:
            self._callbacks.pop(name, None)

    def enable_processing(self) -> None:
        self._enabled = True

    def disable_processing(self) -> None:
        self._enabled = False
        with self._cv:
            self._cv.notify_all()

    def clear_all(self) -> None:
        self.disable_processing()
        with self._mu:
            self._callbacks.clear()
            self._successors.clear()
            self._predecessors.clear()
            self._cleared.clear()

    def process(self, name: str, arg=None) -> None:
        if not self._enabled:
            return
        # Wait for predecessors FIRST, then run the callback (reference
        # sync_point_impl.cc: PredecessorsAllCleared gates the callback), so
        # a callback on "B" with dependency A→B observes post-A state.
        with self._cv:
            preds = self._predecessors.get(name)
            if preds:
                while self._enabled and not all(
                    p in self._cleared for p in preds
                ):
                    self._cv.wait(timeout=5.0)
        cb = self._callbacks.get(name)
        if cb is not None:
            cb(arg)
        with self._cv:
            self._cleared.add(name)
            self._cv.notify_all()


_registry = _SyncPointRegistry()


def sync_point(name: str) -> None:
    _registry.process(name)


def sync_point_callback(name: str, arg) -> None:
    _registry.process(name, arg)


def get_sync_point_registry() -> _SyncPointRegistry:
    return _registry
