"""MergingIterator: the k-way merge over child iterators (copied from
toplingdb_tpu/table/merging_iterator.py).

The role of RocksDB's MergingIterator (table/merging_iterator.cc): children
expose the standard iterator protocol (valid/key/value/seek/seek_to_first/
seek_to_last/next/prev); the merger presents their union in internal-key
order through a binary heap of valid children. The device compaction route
replaces it with the device merge, for which it is the CPU reference.
"""

from __future__ import annotations

import heapq


class _HeapItem:
    __slots__ = ("key", "idx", "cmp", "reverse")

    def __init__(self, key, idx, cmp, reverse):
        self.key = key
        self.idx = idx
        self.cmp = cmp
        self.reverse = reverse

    def __lt__(self, other):
        r = self.cmp(self.key, other.key)
        if r == 0:
            # Stable tie-break: earlier child = newer source wins first.
            r = self.idx - other.idx
        return r > 0 if self.reverse else r < 0


class MergingIterator:
    def __init__(self, cmp, children: list):
        self._cmp = cmp
        self._children = children
        self._heap: list[_HeapItem] = []
        self._direction_forward = True
        self._current = None  # child index

    # ------------------------------------------------------------------

    def _rebuild_heap(self, forward: bool) -> None:
        self._direction_forward = forward
        self._heap = [
            _HeapItem(c.key(), i, self._cmp, not forward)
            for i, c in enumerate(self._children)
            if c.valid()
        ]
        heapq.heapify(self._heap)
        self._current = self._heap[0].idx if self._heap else None

    def valid(self) -> bool:
        return self._current is not None

    def key(self):
        return self._children[self._current].key()

    def value(self):
        return self._children[self._current].value()

    def prefetch_counts(self) -> tuple[int, int]:
        """Summed FilePrefetchBuffer (hits, misses) of every child that
        has one; DBIter banks the deltas into the PREFETCH_* tickers."""
        h = m = 0
        for c in self._children:
            pc = getattr(c, "prefetch_counts", None)
            if pc is not None:
                ch, cm = pc()
                h += ch
                m += cm
        return h, m

    def seek_to_first(self) -> None:
        for c in self._children:
            c.seek_to_first()
        self._rebuild_heap(forward=True)

    def seek_to_last(self) -> None:
        for c in self._children:
            c.seek_to_last()
        self._rebuild_heap(forward=False)

    def seek(self, target) -> None:
        for c in self._children:
            c.seek(target)
        self._rebuild_heap(forward=True)

    def seek_for_prev(self, target) -> None:
        for c in self._children:
            c.seek_for_prev(target)
        self._rebuild_heap(forward=False)

    def next(self) -> None:
        assert self.valid()
        if not self._direction_forward:
            # Direction switch: re-seek all other children after current key.
            key = self.key()
            for i, c in enumerate(self._children):
                if i != self._current:
                    c.seek(key)
                    if c.valid() and self._cmp(c.key(), key) == 0:
                        c.next()
            self._direction_forward = True
            child = self._children[self._current]
            child.next()
            self._rebuild_heap(forward=True)
            return
        item = heapq.heappop(self._heap)
        child = self._children[item.idx]
        child.next()
        if child.valid():
            heapq.heappush(self._heap, _HeapItem(child.key(), item.idx, self._cmp, False))
        self._current = self._heap[0].idx if self._heap else None

    def prev(self) -> None:
        assert self.valid()
        if self._direction_forward:
            key = self.key()
            for i, c in enumerate(self._children):
                if i != self._current:
                    c.seek_for_prev(key)
                    if c.valid() and self._cmp(c.key(), key) == 0:
                        c.prev()
            self._direction_forward = False
            child = self._children[self._current]
            child.prev()
            self._rebuild_heap(forward=False)
            return
        item = heapq.heappop(self._heap)
        child = self._children[item.idx]
        child.prev()
        if child.valid():
            heapq.heappush(self._heap, _HeapItem(child.key(), item.idx, self._cmp, True))
        self._current = self._heap[0].idx if self._heap else None

    def entries(self):
        while self.valid():
            yield self.key(), self.value()
            self.next()
