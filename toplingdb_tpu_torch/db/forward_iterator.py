"""ForwardIterator: the tailing iterator (copied from
toplingdb_tpu/db/forward_iterator.py).

RocksDB's ForwardIterator (db/forward_iterator.cc, made by
ReadOptions.tailing): a forward-only iterator over a live DB that picks up
NEW writes without being recreated. RocksDB rebuilds its child iterators
whenever the SuperVersion changes and keeps its position; here the same
contract is met by wrapping
DBIter: the fast path is a plain next() on the current view, and when the
view is exhausted (or a seek lands at its end) the iterator rebinds to the
DB's current state and resumes strictly after the last returned key — so a
tail loop `while True: it.next() or retry` observes every write exactly
once, in order.

Forward-only: prev()/seek_to_last() raise NotSupported, as in RocksDB
(forward_iterator.h notes SeekToLast/Prev are unsupported).

Its views run on the per-entry path (DB.new_iterator(scan_plane=False)):
the chunked scan plane materializes the whole memtable at each seek, and
a tailer seeks at every catch-up, so with the plane a tailer over an
8 MiB memtable spent most of a live fill's time re-reading it.
"""

from __future__ import annotations

from toplingdb_tpu_torch.utils.status import NotSupported


class ForwardIterator:
    def __init__(self, db, opts, cf=None):
        # Tailing must read the LIVE tail: a pinned snapshot contradicts it
        # (RocksDB rejects tailing with a snapshot).
        if opts.snapshot is not None:
            raise NotSupported("tailing iterators cannot use a snapshot")
        self._db = db
        self._opts = opts
        self._cf = cf
        self._inner = db.new_iterator(opts, cf=cf, scan_plane=False)
        # Where to resume when catching up after end-of-data:
        # None + not positioned → never positioned (next() is an error);
        # None + positioned     → from the first key;
        # (key, False)          → strictly after `key` (it was returned);
        # (key, True)           → at or after `key` (a seek target that
        #                         landed at end-of-data — not yet returned).
        self._resume: tuple[bytes, bool] | None = None
        self._positioned = False

    # -- positioning ----------------------------------------------------

    def seek_to_first(self) -> None:
        self._positioned = True
        self._resume = None
        self._rebind()
        self._inner.seek_to_first()
        self._sync_last()

    def seek(self, user_key: bytes) -> None:
        self._positioned = True
        # If the seek lands at end-of-data, later catch-ups must resume AT
        # the target — never before it.
        self._resume = (user_key, True)
        self._rebind()
        self._inner.seek(user_key)
        self._sync_last()

    def next(self) -> None:
        assert self._positioned, "ForwardIterator.next() before seek"
        if self._inner.valid():
            self._inner.next()
        else:
            # Previously exhausted: catching up IS the advance.
            self._catch_up()
            return
        if not self._inner.valid():
            self._catch_up()
            return
        self._sync_last()

    def seek_to_last(self) -> None:
        raise NotSupported("ForwardIterator is forward-only")

    def prev(self) -> None:
        raise NotSupported("ForwardIterator is forward-only")

    # -- accessors ------------------------------------------------------

    def valid(self) -> bool:
        return self._inner.valid()

    def key(self) -> bytes:
        return self._inner.key()

    def value(self) -> bytes:
        return self._inner.value()

    def entries(self):
        while self.valid():
            yield self.key(), self.value()
            self.next()

    def close(self) -> None:
        self._inner = None

    # -- internals ------------------------------------------------------

    def _sync_last(self) -> None:
        if self._inner.valid():
            self._resume = (self._inner.key(), False)

    def _rebind(self) -> None:
        """Re-create the inner view over the DB's CURRENT sources + latest
        sequence (RocksDB's SVCleanup/RebuildIterators)."""
        self._inner = self._db.new_iterator(self._opts, cf=self._cf,
                                           scan_plane=False)

    def _catch_up(self) -> None:
        """At end-of-view: rebind and resume from self._resume. Invalid
        afterwards means 'no new data yet' — the caller may call next()
        again later (the tail loop)."""
        self._rebind()
        if self._resume is None:
            self._inner.seek_to_first()
        else:
            key, inclusive = self._resume
            self._inner.seek(key)
            if (not inclusive and self._inner.valid()
                    and self._db.icmp.user_comparator.compare(
                        self._inner.key(), key) == 0):
                self._inner.next()
        self._sync_last()
