"""Transactions: pessimistic (2PL) and optimistic, over WriteBatchWithIndex
(copied from toplingdb_tpu/utilities/transactions.py).

The roles of RocksDB's utilities/transactions/:
  * PointLockManager: striped lock maps with deadlock detection
    (point_lock_manager.cc; ToplingDB rebuilds it on terark hash maps,
    this one uses striped dicts); RangeLockManager: the Toku locktree's
    range locks.
  * TransactionDB (PessimisticTransactionDB): writes take locks at write
    time; commit applies the indexed batch atomically; 2PC prepare /
    commit with recovery. The write policies: write_committed (the batch
    is written at commit), write_prepared (written at prepare, invisible
    until the commit marker through the DB's `_undecided_provider` and the
    snapshots' exclusion ranges; a parked compaction guard keeps the
    pre-transaction versions a snapshot still reads) and write_unprepared
    (spilled early).
  * OptimisticTransactionDB: the conflict check at commit, by per-key
    sequence validation (optimistic_transaction_db_impl.cc).

The DB's compactions keep every guard: a guard is a snapshot in the DB's
snapshot list, which the scheduler hands to every job, on the card too.
"""

from __future__ import annotations

import time

from toplingdb_tpu_torch.utils import concurrency as ccy

from toplingdb_tpu_torch.db.db import DB
from toplingdb_tpu_torch.options import Options, ReadOptions, WriteOptions
from toplingdb_tpu_torch.utilities.write_batch_with_index import WriteBatchWithIndex
from toplingdb_tpu_torch.utils.status import Busy, InvalidArgument
from toplingdb_tpu_torch.utils import errors as _errors

NUM_STRIPES = 16


class DeadlockError(Busy):
    pass


def _has_wait_cycle(waits_for: dict, waiter: int, holder: int,
                    max_steps: int = 256) -> bool:
    """Would waiter→holder close a cycle? DFS over the wait-for graph;
    values may be a single txn id (point locks: one holder per key) or a
    set of ids (range locks: many holders per interval). Callers hold
    their own lock around waits_for."""
    seen = set()
    stack = [holder]
    steps = 0
    while stack and steps < max_steps:
        cur = stack.pop()
        steps += 1
        if cur == waiter:
            return True
        if cur in seen:
            continue
        seen.add(cur)
        nxt = waits_for.get(cur)
        if nxt is None:
            continue
        if isinstance(nxt, (set, frozenset)):
            stack.extend(nxt)
        else:
            stack.append(nxt)
    return False


class PointLockManager:
    """Striped exclusive point locks with wait-for-graph deadlock detection."""

    def __init__(self, num_stripes: int = NUM_STRIPES):
        self._stripes = [
            {"mu": ccy.Lock("transactions.PointLockManager.stripe_mu"), "cv": ccy.Condition("transactions.PointLockManager.stripe_cv"),
             "locks": {}}
            for _ in range(num_stripes)
        ]
        self._n = num_stripes
        self._waits_for: dict[int, int] = {}   # txn id → txn id it waits on
        self._wf_mu = ccy.Lock("transactions.PointLockManager._wf_mu")

    def _stripe(self, key: bytes):
        return self._stripes[hash(key) % self._n]

    def _would_deadlock(self, waiter: int, holder: int) -> bool:
        with self._wf_mu:
            return _has_wait_cycle(self._waits_for, waiter, holder)

    def try_lock(self, txn_id: int, key: bytes, timeout: float = 1.0) -> None:
        s = self._stripe(key)
        deadline = time.time() + timeout
        with s["cv"]:
            while True:
                holder = s["locks"].get(key)
                if holder is None or holder == txn_id:
                    s["locks"][key] = txn_id
                    with self._wf_mu:
                        self._waits_for.pop(txn_id, None)
                    return
                if self._would_deadlock(txn_id, holder):
                    raise DeadlockError(
                        f"deadlock: txn {txn_id} → txn {holder} on {key!r}"
                    )
                with self._wf_mu:
                    self._waits_for[txn_id] = holder
                remain = deadline - time.time()
                if remain <= 0:
                    with self._wf_mu:
                        self._waits_for.pop(txn_id, None)
                    raise Busy(f"lock timeout on {key!r} (held by txn {holder})")
                s["cv"].wait(min(remain, 0.05))

    def unlock_all(self, txn_id: int, keys) -> None:
        by_stripe: dict[int, list[bytes]] = {}
        for k in keys:
            by_stripe.setdefault(hash(k) % self._n, []).append(k)
        for si, ks in by_stripe.items():
            s = self._stripes[si]
            with s["cv"]:
                for k in ks:
                    if s["locks"].get(k) == txn_id:
                        del s["locks"][k]
                s["cv"].notify_all()
        with self._wf_mu:
            self._waits_for.pop(txn_id, None)


class RangeLockManager:
    """Range (gap) locks — the role of RocksDB's Toku `locktree`
    (utilities/transactions/lock/range/range_tree/): a transaction can lock
    a whole user-key interval [begin, end] (closed), blocking writers to
    ANY key inside it, with the same wait-for-graph deadlock detection as
    point locks and Toku-style lock escalation (when one transaction holds
    more than max_ranges_per_txn ranges, adjacent owned ranges merge into
    their hull — over-locking is safe, unbounded memory is not).

    Point locks are single-key ranges, so this manager is a drop-in for
    PointLockManager (try_lock / unlock_all have the same shape)."""

    def __init__(self, max_ranges_per_txn: int = 1024):
        self._cv = ccy.Condition("transactions.RangeLockManager._cv")
        self._ranges: list[list] = []  # [begin, end, owner], sorted by begin
        self._max_per_txn = max_ranges_per_txn
        self._counts: dict[int, int] = {}
        self._waits_for: dict[int, set[int]] = {}

    # -- internals (all under self._cv) --------------------------------

    def _overlaps(self, b: bytes, e: bytes):
        # Linear scan: a begin-sorted list cannot bound the scan start
        # (an early range may extend past b), and escalation already
        # bounds the list length.
        return [r for r in self._ranges if r[0] <= e and r[1] >= b]

    def _insert(self, txn_id: int, b: bytes, e: bytes) -> None:
        import bisect

        # Merge with owned overlapping/adjacent ranges into one hull.
        merged_b, merged_e = b, e
        keep = []
        for r in self._overlaps(b, e):
            if r[2] == txn_id:
                merged_b = min(merged_b, r[0])
                merged_e = max(merged_e, r[1])
                keep.append(r)
        for r in keep:
            self._ranges.remove(r)
            self._counts[txn_id] -= 1
        bisect.insort(self._ranges, [merged_b, merged_e, txn_id])
        self._counts[txn_id] = self._counts.get(txn_id, 0) + 1
        if self._counts[txn_id] > self._max_per_txn:
            self._escalate(txn_id)

    def _escalate(self, txn_id: int) -> None:
        """Merge CONSECUTIVE ranges owned by txn_id (no other owner's range
        between them) into their hull — Toku lock escalation: widens the
        lock footprint (safe) to bound memory."""
        out = []
        for r in self._ranges:
            if (out and r[2] == txn_id and out[-1][2] == txn_id):
                out[-1][1] = max(out[-1][1], r[1])
            else:
                out.append(r)
        freed = len(self._ranges) - len(out)
        if freed:
            self._ranges = out
            self._counts[txn_id] -= freed

    # -- public surface --------------------------------------------------

    def try_lock_range(self, txn_id: int, begin: bytes, end: bytes,
                       timeout: float = 1.0) -> None:
        if begin > end:
            raise InvalidArgument("range lock begin > end")
        deadline = time.time() + timeout
        with self._cv:
            while True:
                holders = {
                    r[2] for r in self._overlaps(begin, end)
                    if r[2] != txn_id
                }
                if not holders:
                    self._insert(txn_id, begin, end)
                    self._waits_for.pop(txn_id, None)
                    return
                # A range waits on EVERY holder of an overlapping range:
                # single-edge tracking would miss cycles through the rest.
                for holder in holders:
                    if _has_wait_cycle(self._waits_for, txn_id, holder):
                        self._waits_for.pop(txn_id, None)  # no stale edge
                        raise DeadlockError(
                            f"deadlock: txn {txn_id} → txn {holder} on "
                            f"[{begin!r}, {end!r}]"
                        )
                self._waits_for[txn_id] = set(holders)
                remain = deadline - time.time()
                if remain <= 0:
                    self._waits_for.pop(txn_id, None)
                    raise Busy(
                        f"range lock timeout on [{begin!r}, {end!r}] "
                        f"(held by {len(holders)} txns)"
                    )
                self._cv.wait(min(remain, 0.05))

    def try_lock(self, txn_id: int, key: bytes, timeout: float = 1.0) -> None:
        self.try_lock_range(txn_id, key, key, timeout)

    def unlock_all(self, txn_id: int, keys=None) -> None:
        """Release EVERY range owned by txn_id (ranges may cover many keys,
        so per-key release would leak; RocksDB's locktree likewise
        releases by owner at commit/rollback)."""
        with self._cv:
            self._ranges = [r for r in self._ranges if r[2] != txn_id]
            self._counts.pop(txn_id, None)
            self._waits_for.pop(txn_id, None)
            self._cv.notify_all()


class _TxnBase:
    _next_id = [1]
    _id_lock = ccy.Lock("transactions._TxnBase._id_lock")

    def __init__(self, db: DB, write_options: WriteOptions):
        with self._id_lock:
            self.id = self._next_id[0]
            self._next_id[0] += 1
        self._db = db
        self._wo = write_options
        self.wbwi = WriteBatchWithIndex(db.options.merge_operator)
        self._snapshot = None
        self.state = "started"

    def set_snapshot(self) -> None:
        self._snapshot = self._db.get_snapshot()

    def _read_opts(self) -> ReadOptions:
        return ReadOptions(snapshot=self._snapshot)

    def get(self, key: bytes) -> bytes | None:
        return self.wbwi.get_from_batch_and_db(self._db, key, self._read_opts())

    def put(self, key: bytes, value: bytes) -> None:
        self._before_write(key)
        self.wbwi.put(key, value)

    def delete(self, key: bytes) -> None:
        self._before_write(key)
        self.wbwi.delete(key)

    def merge(self, key: bytes, value: bytes) -> None:
        self._before_write(key)
        self.wbwi.merge(key, value)

    def _before_write(self, key: bytes) -> None:
        raise NotImplementedError

    def rollback(self) -> None:
        self.wbwi.clear()
        self._cleanup()
        self.state = "rolledback"

    def _cleanup(self) -> None:
        if self._snapshot is not None:
            self._snapshot.release()
            self._snapshot = None


class PessimisticTransaction(_TxnBase):
    def __init__(self, txn_db: "TransactionDB", write_options: WriteOptions,
                 lock_timeout: float = 1.0):
        super().__init__(txn_db.db, write_options)
        self._txn_db = txn_db
        self._locked: set[bytes] = set()
        self._locked_ranges: list[tuple[bytes, bytes]] = []
        self._lock_timeout = lock_timeout

    def _before_write(self, key: bytes) -> None:
        if key not in self._locked:
            self._txn_db.lock_manager.try_lock(self.id, key, self._lock_timeout)
            self._locked.add(key)

    def get_for_update(self, key: bytes) -> bytes | None:
        self._before_write(key)
        return self.get(key)

    def get_range_lock(self, begin: bytes, end: bytes) -> None:
        """Lock the whole user-key interval [begin, end] (RocksDB's
        Transaction::GetRangeLock — range-locking TransactionDBs only)."""
        mgr = self._txn_db.lock_manager
        if not isinstance(mgr, RangeLockManager):
            raise InvalidArgument(
                "get_range_lock requires TransactionDB.open("
                "use_range_locking=True)"
            )
        mgr.try_lock_range(self.id, begin, end, self._lock_timeout)
        self._locked_ranges.append((begin, end))

    def undo_get_for_update(self, key: bytes) -> None:
        # RocksDB keeps the lock until commit if the key was written;
        # we match: only unwritten keys are released. Under RANGE locking
        # partial release is unsupported (the locktree frees by owner at
        # commit/rollback) — keeping the lock is safe over-locking.
        if isinstance(self._txn_db.lock_manager, RangeLockManager):
            return
        written = bool(self.wbwi._batch_view(key))  # one seek, not a scan
        if key in self._locked and not written:
            self._txn_db.lock_manager.unlock_all(self.id, [key])
            self._locked.discard(key)

    def set_name(self, name: str) -> None:
        """Name for 2PC (RocksDB's Transaction::SetName — required before
        Prepare so recovery can identify the transaction). Names are unique
        among undecided transactions and immutable once set."""
        if not name or "/" in name or name.startswith("."):
            raise InvalidArgument(f"bad transaction name {name!r}")
        if name.startswith("rb."):
            # Reserved: 'txn.' + 'rb.X' would collide with the rollback
            # marker of transaction 'X' (TransactionDB._RB_PREFIX).
            raise InvalidArgument(
                f"transaction names may not start with 'rb.': {name!r}"
            )
        if self.state != "started":
            raise InvalidArgument(f"cannot rename in state {self.state}")
        if getattr(self, "name", None) is not None:
            raise InvalidArgument("transaction already named")
        self._txn_db._register_name(name)
        self.name = name

    def prepare(self) -> None:
        """2PC phase 1 (RocksDB's Transaction::Prepare): persist the batch
        durably so a crash between prepare and commit leaves the transaction
        recoverable via TransactionDB.get_prepared_transactions()."""
        if self.state != "started":
            raise InvalidArgument(f"cannot prepare from state {self.state}")
        if getattr(self, "name", None) is None:
            raise InvalidArgument("set_name() required before prepare()")
        self._txn_db._persist_prepared(self)
        self.state = "prepared"
        self._tick("TXN_PREPARE")

    def commit(self) -> None:
        if self.state not in ("started", "prepared"):
            raise InvalidArgument(f"cannot commit from state {self.state}")
        # Locks release only on SUCCESS: a failed commit of a prepared txn
        # must stay prepared with its keys locked, or a retry/recovery
        # commit would stomp newer writes (lost update).
        if self.state == "prepared":
            self._txn_db._commit_prepared(self)
        else:
            if not self.wbwi.batch.is_empty():
                self._db.write(self.wbwi.batch, self._wo)
            if getattr(self, "name", None) is not None:
                self._txn_db._release_name(self.name)
        self.state = "committed"
        self._release()
        self._tick("TXN_COMMIT")

    def rollback(self) -> None:
        if self.state == "prepared":
            self._txn_db._discard_prepared(self)
        elif getattr(self, "name", None) is not None:
            self._txn_db._release_name(self.name)
        super().rollback()
        self._release()
        self._tick("TXN_ROLLBACK")

    def _tick(self, which: str) -> None:
        stats = getattr(self._db, "stats", None)
        if stats is not None:
            from toplingdb_tpu_torch.utils import statistics as st

            stats.record_tick(getattr(st, which))

    def _release(self) -> None:
        self._txn_db.lock_manager.unlock_all(self.id, self._locked)
        self._locked.clear()
        self._cleanup()


class TransactionDB:
    """Pessimistic transaction DB (RocksDB's PessimisticTransactionDB,
    WriteCommitted policy). 2PC: prepared transactions persist in
    `<db>/txns/<name>.prep` (batch + lock set, fsynced); commit appends a
    hidden marker key in the same atomic batch so recovery can tell a
    crash-after-commit from a still-prepared transaction (RocksDB
    uses WAL Prepare/Commit markers for the same purpose)."""

    _MARKER_PREFIX = b"txn."
    _TXN_CF = "__tpulsm_txn__"

    def __init__(self, db: DB, use_range_locking: bool = False,
                 write_policy: str = "write_committed"):
        if write_policy not in ("write_committed", "write_prepared",
                                "write_unprepared"):
            raise InvalidArgument(f"unknown write policy {write_policy!r}")
        self.db = db
        self.write_policy = write_policy
        # Reference TransactionDBOptions::lock_mgr_handle: "point" (default)
        # or the range-capable locktree manager.
        self.lock_manager = (
            RangeLockManager() if use_range_locking else PointLockManager()
        )
        self._txn_dir = f"{db.dbname}/txns"
        self._recovered: list[PessimisticTransaction] = []
        self._names: set[str] = set()
        self._names_mu = ccy.Lock("transactions.TransactionDB._names_mu")
        # WritePrepared/WriteUnprepared: seqno ranges of in-DB data belonging
        # to undecided transactions (name → [(lo, hi), ...]). Exposed to the
        # engine's read paths via DB._undecided_provider (RocksDB's
        # SnapshotChecker / commit-cache visibility role).
        self._undecided: dict[str, list] = {}
        self._undecided_mu = ccy.Lock("transactions.TransactionDB._undecided_mu")
        self._parked_guards: list = []  # (guard snapshot, ranges) — see
        #                                 _wp_release_guard
        db._undecided_provider = self._undecided_ranges
        # Commit markers live in their own column family so user-keyspace
        # scans never see them (RocksDB keeps its markers in the WAL).
        cf = db.get_column_family(self._TXN_CF)
        self._txn_cf = cf if cf is not None else \
            db.create_column_family(self._TXN_CF)
        try:
            db.env.create_dir(self._txn_dir)
        except Exception as e:
            _errors.swallow(reason="txn-dir-create-exists", exc=e)
        try:
            self._recover_prepared()
        except BaseException:
            # A recovery refusal (e.g. prepared range locks without
            # use_range_locking) must not leak the fully-opened DB.
            db.close()
            raise

    def _register_name(self, name: str) -> None:
        with self._names_mu:
            if name in self._names or self.db.env.file_exists(
                    self._prep_path(name)):
                raise InvalidArgument(
                    f"transaction name {name!r} already in use"
                )
            self._names.add(name)

    def _release_name(self, name: str) -> None:
        with self._names_mu:
            self._names.discard(name)

    @staticmethod
    def open(path: str, options: Options | None = None,
             use_range_locking: bool = False,
             write_policy: str = "write_committed") -> "TransactionDB":
        return TransactionDB(DB.open(path, options), use_range_locking,
                             write_policy)

    # -- 2PC journal ----------------------------------------------------

    def _prep_path(self, name: str) -> str:
        return f"{self._txn_dir}/{name}.prep"

    def _persist_prepared(self, txn) -> None:
        import json as _json

        doc = _json.dumps({
            "name": txn.name,
            "batch": txn.wbwi.batch.data().hex(),
            "locks": [k.hex() for k in txn._locked],
            "range_locks": [
                [b.hex(), e.hex()] for b, e in txn._locked_ranges
            ],
        })
        self.db.env.write_file(self._prep_path(txn.name), doc.encode(),
                               sync=True)

    def _commit_prepared(self, txn) -> None:
        from toplingdb_tpu_torch.db.write_batch import WriteBatch

        marker = self._MARKER_PREFIX + txn.name.encode()
        batch = WriteBatch(txn.wbwi.batch.data())
        batch.put(marker, b"1", cf=self._txn_cf.id)
        self.db.write(batch, txn._wo)
        try:
            self.db.env.delete_file(self._prep_path(txn.name))
        except Exception as e:
            _errors.swallow(reason="prepared-journal-cleanup", exc=e)
        self.db.delete(marker, cf=self._txn_cf)
        if txn in self._recovered:
            self._recovered.remove(txn)
        self._release_name(txn.name)

    def _discard_prepared(self, txn) -> None:
        try:
            self.db.env.delete_file(self._prep_path(txn.name))
        except Exception as e:
            _errors.swallow(reason="prepared-journal-cleanup", exc=e)
        if txn in self._recovered:
            self._recovered.remove(txn)
        self._release_name(txn.name)

    def _recover_prepared(self) -> None:
        import json as _json

        from toplingdb_tpu_torch.utils.status import NotFound

        try:
            children = self.db.env.get_children(self._txn_dir)
        except NotFound:
            return
        live_names: set[str] = set()
        for child in sorted(children):
            if not child.endswith(".prep"):
                continue
            # IO errors PROPAGATE (hiding a prepared txn loses its locks);
            # only unparseable content counts as a torn prepare.
            raw = self.db.env.read_file(f"{self._txn_dir}/{child}")
            try:
                doc = _json.loads(raw.decode())
                name = doc["name"]
                if doc.get("policy") in ("write_prepared",
                                         "write_unprepared"):
                    self._recover_wp(name, doc)
                    live_names.add(name)
                    continue
                batch_data = bytes.fromhex(doc["batch"])
                locks = [bytes.fromhex(kh) for kh in doc["locks"]]
                range_locks = [
                    (bytes.fromhex(b), bytes.fromhex(e))
                    for b, e in doc.get("range_locks", [])
                ]
            except (ValueError, KeyError, UnicodeDecodeError):
                # Torn prepare: quarantine so it can't be re-read forever.
                self.db.env.rename_file(
                    f"{self._txn_dir}/{child}",
                    f"{self._txn_dir}/{child}.corrupt",
                )
                continue
            marker = self._MARKER_PREFIX + name.encode()
            if self.db.get(marker, cf=self._txn_cf) is not None:
                # Crashed between commit-write and prep-file delete: the
                # batch is already durable — finish the bookkeeping.
                try:
                    self.db.env.delete_file(self._prep_path(name))
                except NotFound:
                    pass
                self.db.delete(marker, cf=self._txn_cf)
                continue
            txn = PessimisticTransaction(self, WriteOptions())
            txn.name = name
            self._names.add(name)
            live_names.add(name)
            from toplingdb_tpu_torch.db.write_batch import WriteBatch

            txn.wbwi.batch = WriteBatch(batch_data)
            for k in locks:
                self.lock_manager.try_lock(txn.id, k, 0.0)
                txn._locked.add(k)
            if range_locks and not isinstance(self.lock_manager,
                                              RangeLockManager):
                raise InvalidArgument(
                    f"prepared transaction {name!r} holds range locks; "
                    f"reopen with use_range_locking=True"
                )
            for b, e in range_locks:
                self.lock_manager.try_lock_range(txn.id, b, e, 0.0)
                txn._locked_ranges.append((b, e))
            txn.state = "prepared"
            self._recovered.append(txn)
        # Sweep orphan markers (crash between prep delete and marker
        # delete): any marker without a surviving .prep is garbage.
        it = self.db.new_iterator(cf=self._txn_cf)
        it.seek(self._MARKER_PREFIX)
        orphans = []
        while it.valid() and it.key().startswith(self._MARKER_PREFIX):
            name = it.key()[len(self._MARKER_PREFIX):].decode(errors="replace")
            if name not in live_names:
                orphans.append(it.key())
            it.next()
        for k in orphans:
            self.db.delete(k, cf=self._txn_cf)

    def get_prepared_transactions(self) -> list:
        """Recovered prepared-but-undecided transactions (RocksDB's
        GetAllPreparedTransactions); commit() or rollback() each."""
        return list(self._recovered)

    # -- WritePrepared / WriteUnprepared machinery ----------------------
    #
    # Reference write_prepared_txn_db.cc / write_unprepared_txn_db.cc: data
    # reaches the DB (WAL + memtable) at Prepare time — commit is a tiny
    # marker write, not a second copy of the batch. Visibility is enforced
    # by the engine: every read excludes the seqno ranges of undecided
    # transactions (DB._undecided_provider; snapshots capture the set at
    # creation, the old_commit_map role). Rollback follows RocksDB's
    # design: write compensating records restoring each key's pre-prepare
    # value, then let the whole range become visible — the compensation is
    # newer, so the observable state is the rollback.

    _RB_PREFIX = b"txn.rb."

    def _undecided_ranges(self) -> tuple:
        with self._undecided_mu:
            return tuple(r for rs in self._undecided.values() for r in rs)

    def _wp_unregister(self, name: str) -> None:
        with self._undecided_mu:
            self._undecided.pop(name, None)

    def _wp_write_batch(self, txn, batch) -> None:
        """Write `batch` into the DB invisibly, recording the new seqno
        range on the transaction. The exclusion registers via the write
        path's on_sequenced hook — inside the commit critical section,
        before the group's last_sequence publishes — so no reader can ever
        observe the data unexcluded."""
        if batch.is_empty():
            return
        db = self.db

        def on_sequenced(lo: int, hi: int) -> None:
            with self._undecided_mu:
                self._undecided.setdefault(txn.name, []).append((lo, hi))
            txn._wp_ranges.append((lo, hi))
            if txn._guard_snap is None:
                # Compaction guard: a visibility boundary below the
                # undecided data so background GC never folds/drops across
                # it (RocksDB excludes the snapshot-checker from
                # compaction similarly conservatively).
                txn._guard_snap = db.snapshots.new_snapshot(lo - 1)

        # Prepare durability: RocksDB syncs the WAL at prepare.
        db.write(batch, WriteOptions(sync=True), on_sequenced=on_sequenced)

    def _wp_journal(self, txn, finalized: bool) -> None:
        """Persist the transaction's WP journal (.prep file). Written with
        finalized=False BEFORE any data write (intent: a crash rolls the
        transaction back) and rewritten with finalized=True at Prepare.

        lo_hint: a lower bound on any seqno this transaction's data can
        occupy, taken BEFORE the data write. If we crash after the data hits
        the WAL but before the journal records the actual ranges, recovery
        still compensates correctly by reading each key just below lo_hint —
        sound because the transaction holds locks on every written key, so
        no other writer can touch them in between."""
        import json as _json

        if txn._wp_lo_hint is None:
            txn._wp_lo_hint = self.db.versions.last_sequence + 1
        doc = _json.dumps({
            "policy": "write_prepared",
            "name": txn.name,
            "finalized": finalized,
            "lo_hint": txn._wp_lo_hint,
            "ranges": [[lo, hi] for lo, hi in txn._wp_ranges],
            "keys": [k.hex() for k in sorted(txn._wp_keys)],
            "locks": [k.hex() for k in txn._locked],
            "range_locks": [
                [b.hex(), e.hex()] for b, e in txn._locked_ranges
            ],
        })
        self.db.env.write_file(self._prep_path(txn.name), doc.encode(),
                               sync=True)

    def _wp_prepare(self, txn) -> None:
        txn._wp_keys.update(txn.wbwi.key_set())
        self._wp_journal(txn, finalized=False)   # intent first: crash = abort
        self._wp_write_batch(txn, txn._wp_pending_batch())
        self._wp_journal(txn, finalized=True)

    def _wp_commit(self, txn) -> None:
        from toplingdb_tpu_torch.db.write_batch import WriteBatch

        marker = self._MARKER_PREFIX + txn.name.encode()
        b = WriteBatch()
        b.put(marker, b"1", cf=self._txn_cf.id)
        self.db.write(b, WriteOptions(sync=True))  # the commit point
        self._wp_unregister(txn.name)              # data becomes visible
        self._wp_release_guard(txn)
        try:
            self.db.env.delete_file(self._prep_path(txn.name))
        except Exception as e:
            _errors.swallow(reason="prepared-journal-cleanup", exc=e)
        self.db.delete(marker, cf=self._txn_cf)
        if txn in self._recovered:
            self._recovered.remove(txn)
        self._release_name(txn.name)

    def _wp_rollback(self, txn) -> None:
        from toplingdb_tpu_torch.db.write_batch import WriteBatch

        rb_marker = self._RB_PREFIX + txn.name.encode()
        mb = WriteBatch()
        mb.put(rb_marker, b"1", cf=self._txn_cf.id)
        self.db.write(mb, WriteOptions(sync=True))  # rollback decision point
        # Compensating records: each written key's value just below the
        # transaction's first seqno (RocksDB's WritePreparedTxn::
        # RollbackInternal reads prior versions the same way). When the
        # ranges were never journaled (crash mid-prepare), lo_hint bounds
        # them from below — see _wp_journal.
        lo0 = (min(lo for lo, _ in txn._wp_ranges) if txn._wp_ranges
               else txn._wp_lo_hint)
        if lo0 is not None and txn._wp_keys:
            snap = self.db.snapshots.new_snapshot(
                lo0 - 1, excluded_ranges=self._undecided_ranges()
            )
            comp = WriteBatch()
            try:
                for k in sorted(txn._wp_keys):
                    v = self.db.get(k, ReadOptions(snapshot=snap))
                    if v is None:
                        comp.delete(k)
                    else:
                        comp.put(k, v)
            finally:
                snap.release()
            self.db.write(comp, WriteOptions(sync=True))
        self._wp_unregister(txn.name)  # original + compensation now visible
        self._wp_release_guard(txn)
        try:
            self.db.env.delete_file(self._prep_path(txn.name))
        except Exception as e:
            _errors.swallow(reason="prepared-journal-cleanup", exc=e)
        self.db.delete(rb_marker, cf=self._txn_cf)
        if txn in self._recovered:
            self._recovered.remove(txn)
        self._release_name(txn.name)

    def _wp_release_guard(self, txn) -> None:
        g = txn._guard_snap
        txn._guard_snap = None
        if g is None:
            return
        ranges = tuple(txn._wp_ranges)
        if ranges and self.db.snapshots.any_excluding(
            min(lo for lo, _ in ranges), max(hi for _, hi in ranges)
        ):
            # A live snapshot captured this transaction's exclusion:
            # compaction must keep the pre-transaction versions that
            # snapshot reads, so the guard is PARKED until every such
            # snapshot dies (swept opportunistically).
            with self._undecided_mu:
                self._parked_guards.append((g, ranges))
            return
        g.release()

    def _sweep_parked_guards(self) -> None:
        with self._undecided_mu:
            parked, self._parked_guards = self._parked_guards, []
        keep = []
        for g, ranges in parked:
            if self.db.snapshots.any_excluding(
                min(lo for lo, _ in ranges), max(hi for _, hi in ranges)
            ):
                keep.append((g, ranges))
            else:
                g.release()
        if keep:
            with self._undecided_mu:
                self._parked_guards.extend(keep)

    def _recover_wp(self, name: str, doc: dict) -> None:
        """Recovery for a WritePrepared/WriteUnprepared journal file."""
        marker = self._MARKER_PREFIX + name.encode()
        if self.db.get(marker, cf=self._txn_cf) is not None:
            # Committed; crash before cleanup. Data is visible already.
            try:
                self.db.env.delete_file(self._prep_path(name))
            except Exception as e:
                _errors.swallow(reason="prepared-journal-cleanup", exc=e)
            self.db.delete(marker, cf=self._txn_cf)
            return
        txn = WritePreparedTransaction(self, WriteOptions())
        txn.name = name
        txn._wp_ranges = [(lo, hi) for lo, hi in doc.get("ranges", [])]
        txn._wp_lo_hint = doc.get("lo_hint")
        txn._wp_keys = {bytes.fromhex(k) for k in doc.get("keys", [])}
        with self._names_mu:
            self._names.add(name)
        with self._undecided_mu:
            self._undecided[name] = list(txn._wp_ranges)
        if txn._wp_ranges:
            txn._guard_snap = self.db.snapshots.new_snapshot(
                min(lo for lo, _ in txn._wp_ranges) - 1
            )
        rb = self.db.get(self._RB_PREFIX + name.encode(), cf=self._txn_cf)
        if rb is not None or not doc.get("finalized", False):
            # Mid-rollback, or crashed before Prepare finished: the
            # transaction never became durable-prepared — roll it back
            # (idempotent: compensation re-reads below the first seqno).
            self._wp_rollback(txn)
            return
        for kh in doc.get("locks", []):
            k = bytes.fromhex(kh)
            self.lock_manager.try_lock(txn.id, k, 0.0)
            txn._locked.add(k)
        range_locks = [
            (bytes.fromhex(b), bytes.fromhex(e))
            for b, e in doc.get("range_locks", [])
        ]
        if range_locks and not isinstance(self.lock_manager, RangeLockManager):
            raise InvalidArgument(
                f"prepared transaction {name!r} holds range locks; "
                f"reopen with use_range_locking=True"
            )
        for b, e in range_locks:
            self.lock_manager.try_lock_range(txn.id, b, e, 0.0)
            txn._locked_ranges.append((b, e))
        txn.state = "prepared"
        self._recovered.append(txn)

    def begin_transaction(self, write_options: WriteOptions = WriteOptions(),
                          lock_timeout: float = 1.0) -> PessimisticTransaction:
        self._sweep_parked_guards()
        if self.write_policy == "write_prepared":
            return WritePreparedTransaction(self, write_options, lock_timeout)
        if self.write_policy == "write_unprepared":
            return WriteUnpreparedTransaction(self, write_options, lock_timeout)
        return PessimisticTransaction(self, write_options, lock_timeout)

    # Non-transactional access locks implicitly (RocksDB's WriteCommitted
    # TransactionDB::Put): a degenerate single-op transaction.
    def put(self, key: bytes, value: bytes,
            opts: WriteOptions = WriteOptions()) -> None:
        txn = self.begin_transaction(opts)
        txn.put(key, value)
        txn.commit()

    def get(self, key: bytes, opts: ReadOptions = ReadOptions()):
        return self.db.get(key, opts)

    def close(self) -> None:
        with self._undecided_mu:
            parked, self._parked_guards = self._parked_guards, []
        for g, _ in parked:
            g.release()
        self.db.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class WritePreparedTransaction(PessimisticTransaction):
    """WritePrepared policy (RocksDB's write_prepared_txn_db.cc): Prepare
    writes the batch into the DB (WAL + memtable, synced) so Commit is a
    marker write — no second copy of a large batch at the commit point. The
    data stays invisible to every reader until the commit marker lands (see
    TransactionDB._wp_* and DB._undecided_provider)."""

    def __init__(self, txn_db: "TransactionDB", write_options: WriteOptions,
                 lock_timeout: float = 1.0):
        super().__init__(txn_db, write_options, lock_timeout)
        self._wp_ranges: list[tuple[int, int]] = []  # in-DB undecided seqnos
        self._wp_keys: set[bytes] = set()            # for rollback records
        self._wp_lo_hint: int | None = None          # see _wp_journal
        self._guard_snap = None                      # compaction guard

    def _wp_pending_batch(self):
        """The batch portion not yet written to the DB (everything, for
        plain WritePrepared; the unprepared subclass spills early)."""
        return self.wbwi.batch

    def prepare(self) -> None:
        if self.state != "started":
            raise InvalidArgument(f"cannot prepare from state {self.state}")
        if getattr(self, "name", None) is None:
            raise InvalidArgument("set_name() required before prepare()")
        self._txn_db._wp_prepare(self)
        self.state = "prepared"

    def commit(self) -> None:
        if self.state == "started":
            # Commit without Prepare: a single atomic batch write IS the
            # commit point — identical to the WriteCommitted fast path.
            super().commit()
            return
        if self.state != "prepared":
            raise InvalidArgument(f"cannot commit from state {self.state}")
        self._txn_db._wp_commit(self)
        self.state = "committed"
        self._release()

    def rollback(self) -> None:
        if self.state == "prepared":
            self._txn_db._wp_rollback(self)
            self.wbwi.clear()
            self.state = "rolledback"
            self._release()
            return
        super().rollback()


class WriteUnpreparedTransaction(WritePreparedTransaction):
    """WriteUnprepared policy (RocksDB's write_unprepared_txn_db.cc): batch
    fragments SPILL into the DB while the transaction is still running, so a
    transaction larger than memory never materializes its full batch. Each
    spill extends the undecided seqno ranges; Prepare flushes the remainder
    and finalizes the journal. The WBWI index is retained for
    read-your-own-writes across spills."""

    #: spill once the unflushed batch bytes exceed this (RocksDB's
    #: TransactionOptions::write_batch_flush_threshold).
    spill_threshold: int = 64 * 1024

    def __init__(self, txn_db: "TransactionDB", write_options: WriteOptions,
                 lock_timeout: float = 1.0,
                 spill_threshold: int | None = None):
        super().__init__(txn_db, write_options, lock_timeout)
        if spill_threshold is not None:
            self.spill_threshold = spill_threshold
        self._spill_off = None  # byte offset of unspilled tail in the batch
        self._spill_count = 0

    def _unspilled(self):
        from toplingdb_tpu_torch.db.write_batch import HEADER_SIZE, WriteBatch

        if self._spill_off is None:
            return self.wbwi.batch
        full = self.wbwi.batch
        part = WriteBatch()
        part._rep = bytearray(part._rep[:HEADER_SIZE])
        part._rep += full._rep[self._spill_off:]
        part.set_count(full.count() - self._spill_count)
        part._simple = False  # sliced bytes: decode when applying
        return part

    def _wp_pending_batch(self):
        return self._unspilled()

    def _maybe_spill(self) -> None:
        pending = self._unspilled()
        if pending.data_size() <= self.spill_threshold:
            return
        if getattr(self, "name", None) is None:
            # Spills need a recoverable identity before any data hits the
            # WAL (RocksDB assigns XIDs internally).
            self.set_name(f"__unprep.{self.id}")
        self._wp_keys.update(self.wbwi.key_set())
        self._txn_db._wp_journal(self, finalized=False)  # intent first
        self._txn_db._wp_write_batch(self, pending)
        self._txn_db._wp_journal(self, finalized=False)  # record the range
        self._spill_off = len(self.wbwi.batch._rep)
        self._spill_count = self.wbwi.batch.count()

    def put(self, key: bytes, value: bytes) -> None:
        super().put(key, value)
        self._maybe_spill()

    def delete(self, key: bytes) -> None:
        super().delete(key)
        self._maybe_spill()

    def merge(self, key: bytes, value: bytes) -> None:
        super().merge(key, value)
        self._maybe_spill()

    def commit(self) -> None:
        if self.state == "started" and self._spill_off is not None:
            # Data is already partially in the DB: a commit must go through
            # the marker protocol (implicit prepare, as RocksDB does).
            self.prepare()
        super().commit()

    def rollback(self) -> None:
        if self.state == "started" and self._spill_off is not None:
            self._txn_db._wp_rollback(self)
            self.wbwi.clear()
            self.state = "rolledback"
            self._release()
            return
        super().rollback()


class OptimisticTransaction(_TxnBase):
    def __init__(self, txn_db: "OptimisticTransactionDB",
                 write_options: WriteOptions):
        super().__init__(txn_db.db, write_options)
        self._txn_db = txn_db
        self._tracked: dict[bytes, int] = {}  # key → seqno when first read/written
        self.set_snapshot()

    def _before_write(self, key: bytes) -> None:
        # Track at the SNAPSHOT sequence: reads are served at the snapshot,
        # so any write after it is a conflict (tracking at last_sequence
        # would silently admit lost updates for writes that landed between
        # snapshot and track — RocksDB's TransactionUtil::CheckKey).
        self._tracked.setdefault(key, self._snapshot.sequence)

    def get_for_update(self, key: bytes) -> bytes | None:
        self._before_write(key)
        return self.get(key)

    def commit(self) -> None:
        if self.state != "started":
            raise InvalidArgument(f"cannot commit from state {self.state}")
        db = self._db
        with db._mutex:  # validation + write must be atomic
            for key, seq_at_track in self._tracked.items():
                if self._conflicts(key, seq_at_track):
                    self._cleanup()
                    self.state = "aborted"
                    raise Busy(f"write conflict on {key!r}")
            if not self.wbwi.batch.is_empty():
                db.write(self.wbwi.batch, self._wo)
        self.state = "committed"
        self._cleanup()

    def _conflicts(self, key: bytes, seq_at_track: int) -> bool:
        """Did anyone write `key` after we tracked it? Checked via a read at
        latest vs read at tracked seqno (RocksDB checks memtable seqnos;
        ours inspects the newest visible version's seqno)."""
        ctx_seq = self._latest_write_seqno(key)
        return ctx_seq is not None and ctx_seq > seq_at_track

    def _latest_write_seqno(self, key: bytes):
        db = self._db
        snap = db.versions.last_sequence
        for mem in [db.mem] + db.imm:
            for seq, t, val in mem.entries_for_key(key, snap):
                return seq
            ts = mem.covering_tombstone_seq(key, snap)
            if ts:
                return ts
        version = db.versions.current
        for level, f in version.files_for_get(key):
            reader = db.table_cache.get_reader(f.number)
            if not reader.key_may_match(key):
                continue
            from toplingdb_tpu_torch.db import dbformat

            it = reader.new_iterator()
            it.seek(dbformat.make_internal_key(
                key, snap, dbformat.VALUE_TYPE_FOR_SEEK
            ))
            while it.valid():
                uk, seq, t = dbformat.split_internal_key(it.key())
                if uk != key:
                    break
                return seq
            # L0 files are newest-first; the first hit is the latest version.
        return None


class OptimisticTransactionDB:
    def __init__(self, db: DB):
        self.db = db

    @staticmethod
    def open(path: str, options: Options | None = None) -> "OptimisticTransactionDB":
        return OptimisticTransactionDB(DB.open(path, options))

    def begin_transaction(self, write_options: WriteOptions = WriteOptions()
                          ) -> OptimisticTransaction:
        return OptimisticTransaction(self, write_options)

    def get(self, key: bytes, opts: ReadOptions = ReadOptions()):
        return self.db.get(key, opts)

    def close(self) -> None:
        self.db.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
