"""FollowerDB: a read replica that tails shipped WAL frames (copied from
toplingdb_tpu/replication/follower.py; RocksDB's secondary instance,
db_impl_secondary.cc, fed by shipped frames).

Extends SecondaryDB (db/db_readonly.py) with a continuous tail/apply loop:
shipped batches land in the follower's memtables at their original
sequence numbers; when the primary's MANIFEST epoch advances (flush or
compaction installed a new version) a directory-sharing follower swaps in
the new version set and re-pulls the WAL tail; when lag outruns WAL
retention, the follower bootstraps from a fresh primary checkpoint through
utilities/checkpoint.py's Checkpoint.restore_to.

Two deployment modes:

  shared      dbname IS the primary's directory (the reference secondary
              instance shape): SSTs and MANIFEST are read in place; only
              the WAL tail travels as frames. Epoch changes trigger a
              MANIFEST re-read; retention gaps resolve the same way
              (the new MANIFEST's SSTs cover the GC'd WALs).
  standalone  dbname is the follower's own directory, seeded by a
              checkpoint restore over the shared filesystem (the dcompact
              data-plane assumption): frames accumulate in the memtable;
              retention gaps trigger a full re-bootstrap.

The applied-sequence watermark (`applied_sequence()`) only advances AFTER
a batch's entries are visible, so the router's token rule — serve a
token-carrying read only from replicas with applied >= token — yields
read-your-writes with no locks on the read path.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from toplingdb_tpu_torch.db import filename
from toplingdb_tpu_torch.db.db import DB
from toplingdb_tpu_torch.db.db_readonly import SecondaryDB
from toplingdb_tpu_torch.db.write_batch import WriteBatch
from toplingdb_tpu_torch.ops.scan_plane import DEFAULT_CHUNK
from toplingdb_tpu_torch.options import Options
from toplingdb_tpu_torch.replication.log_shipper import WalRetentionGone
from toplingdb_tpu_torch.utils import concurrency as ccy
from toplingdb_tpu_torch.utils import errors as _errors
from toplingdb_tpu_torch.utils import statistics as stats_mod
from toplingdb_tpu_torch.utils.status import Corruption, IOError_


class FollowerDB(SecondaryDB):
    """A SecondaryDB fed by a ReplicationTransport instead of (only) the
    shared directory. Use FollowerDB.open(); then either call catch_up()
    on your own cadence or start_tailing() for a background loop. A
    follower runs no compaction: the tables it reads are the primary's
    (compacted on the primary's executor, on the card by default)."""

    @classmethod
    def open(cls, dbname: str, options: Options | None = None, env=None,
             transport=None, mode: str = "shared",
             bootstrap: bool = True) -> "FollowerDB":
        """Open a follower of the primary behind `transport` (None: the
        shared directory alone, as a SecondaryDB). `options` is copied
        with read_only, disable_auto_compactions and no create_if_missing
        set."""
        if mode not in ("shared", "standalone"):
            raise ValueError(f"mode {mode!r}: expected 'shared' or "
                             f"'standalone'")
        options = dataclasses.replace(
            options or Options(), create_if_missing=False,
            disable_auto_compactions=True, read_only=True)
        DB._check_open_args(options, False, DEFAULT_CHUNK, False)
        from toplingdb_tpu_torch.env import default_env

        env = env or default_env()
        if (mode == "standalone" and bootstrap and transport is not None
                and not env.file_exists(filename.current_file_name(dbname))):
            cls._restore_checkpoint_into(dbname, env, transport)
        db = cls(dbname, options, env, write_plane=False)
        db._mode = mode
        db._transport = transport
        db._epoch = None
        db._applied_seq = None  # None = pull from the retention head
        db._tail_stop = threading.Event()
        db._tail_thread = None
        db.tail_errors = 0
        # Telemetry: finished apply-span dicts awaiting the next pull (the
        # ship-frame ack channel). Fire-and-forget and bounded — a dead
        # primary or a dropped pull must neither error nor leak.
        db._span_outbox = []
        db._journal = None  # standalone-mode frame journal (local WAL)
        db.versions.recover(readonly=True)
        db._compaction_scheduler = None
        if mode == "shared":
            db._replay_wals_into_mem()
            db._applied_seq = db.versions.last_sequence
            db._epoch = db._local_epoch()
        else:
            # Checkpoint-restored: SSTs carry everything up to the
            # checkpoint sequence; frames take it from there. The frame
            # JOURNAL (a local WAL of every applied rep) makes applied
            # frames durable in OUR directory: re-opens resume from it,
            # and promote() → DB.open replays it — without it every frame
            # applied after the checkpoint lived only in the memtable and
            # silently vanished at promote (the migration-cutover
            # data-loss hole the sharding chaos soak caught).
            db._materialize_cfs()
            db._replay_wals_into_mem()  # prior journals, on re-open
            db._applied_seq = db.versions.last_sequence
            db._open_frame_journal()
        db._repl_status_provider = db.replication_status
        return db

    # -- bootstrap -------------------------------------------------------

    @staticmethod
    def _restore_checkpoint_into(dbname: str, env, transport) -> None:
        from toplingdb_tpu_torch.utilities.checkpoint import Checkpoint

        ckpt = f"{dbname}.bootstrap-ckpt"
        transport.request_checkpoint(ckpt)
        Checkpoint(ckpt, env).restore_to(dbname)
        _rm_tree(env, ckpt)

    def _bootstrap(self) -> None:
        """Standalone follower fell behind WAL retention: wipe and restore
        from a fresh primary checkpoint (RocksDB's secondaries re-open)."""
        if self.stats is not None:
            self.stats.record_tick(stats_mod.REPLICATION_BOOTSTRAPS)
        if self._transport is None:
            raise IOError_("follower lag exceeds WAL retention and no "
                           "transport is attached to bootstrap from")
        from toplingdb_tpu_torch.db.table_cache import TableCache
        from toplingdb_tpu_torch.db.version_set import VersionSet
        from toplingdb_tpu_torch.utilities.checkpoint import (
            Checkpoint,
            _untapped,
        )

        env = _untapped(self.env)  # a restore's files are not the DB's own
        ckpt = f"{self.dbname}.bootstrap-ckpt"
        _rm_tree(env, ckpt)
        self._transport.request_checkpoint(ckpt)
        with self._mutex:
            self._close_frame_journal(sync=False)  # wiped with the rest
            self.table_cache.close()
            for child in list(env.get_children(self.dbname)):
                try:
                    env.delete_file(f"{self.dbname}/{child}")
                except Exception as e:
                    # subdirectories (archive/) stay; files go
                    _errors.swallow(reason="wipe-db-file-delete", exc=e)
            Checkpoint(ckpt, env).restore_to(self.dbname)
            _rm_tree(env, ckpt)
            vs = VersionSet(self.env, self.dbname, self.icmp,
                            self.options.num_levels)
            vs.recover(readonly=True)
            self.versions = vs
            self.table_cache = TableCache(
                env, self.dbname, self.icmp, self.options.table_options,
                block_cache=self.options.block_cache)
            self.table_cache.stats = self.options.statistics
            for cf_id in list(self._cfs):
                if cf_id != 0:
                    del self._cfs[cf_id]
            self._cfs[0].mem = self._fresh_memtable()
            self._cfs[0].imm = []
            self._materialize_cfs()
            self._applied_seq = vs.last_sequence
            self._epoch = None  # next state observation resets it
            self._open_frame_journal()

    # -- frame journal (standalone durability) ---------------------------

    def _open_frame_journal(self) -> None:
        """A fresh local WAL for applied frame reps (standalone mode owns
        its directory, so writing one is safe — shared mode must never:
        dbname is the PRIMARY's directory). Reps carry their original
        sequence numbers, so DB recovery replays them verbatim."""
        from toplingdb_tpu_torch.db.log import LogWriter

        num = self.versions.new_file_number()
        self._journal = LogWriter(self.env.new_writable_file(
            filename.log_file_name(self.dbname, num)))

    def _close_frame_journal(self, sync: bool) -> None:
        j = self._journal
        self._journal = None
        if j is None:
            return
        try:
            if sync:
                j.sync()
            j.close()
        except Exception as e:
            # a broken journal close must not block shutdown
            _errors.swallow(reason="frame-journal-close-on-shutdown", exc=e)

    # -- epoch / version swap -------------------------------------------

    def _local_epoch(self) -> int:
        from toplingdb_tpu_torch.replication.log_shipper import pack_epoch

        return pack_epoch(self.versions.manifest_file_number,
                          getattr(self.versions, "edit_seq", 0))

    def _reload_versions(self) -> None:
        """Shared-directory version swap: the primary flushed/compacted.
        Fresh memtables + applied=None forces the next pull to restart at
        the retention head; everything below it is covered by the SSTs the
        new MANIFEST installed. Readers between the swap and the re-pull
        see the (consistent) manifest view."""
        if self.stats is not None:
            self.stats.record_tick(stats_mod.REPLICATION_EPOCH_RELOADS)
        with self._mutex:
            self._reload_manifest_view()
            self._applied_seq = None

    # -- tail/apply loop -------------------------------------------------

    def applied_sequence(self) -> int:
        """Router-facing watermark: every sequence <= this is visible to
        reads. 0 while a reload/bootstrap is repositioning the cursor (the
        router then treats this replica as arbitrarily stale)."""
        s = self._applied_seq
        return 0 if s is None else s

    def catch_up(self, max_bytes: int = 1 << 22) -> int:
        """One pull/apply round. Returns the number of batches applied."""
        tr = self._transport
        if tr is None:
            # Pure shared-directory mode: behave like SecondaryDB.
            self.try_catch_up_with_primary()
            self._applied_seq = self.versions.last_sequence
            self._epoch = self._local_epoch()
            return 0
        outbox = None
        if self._span_outbox:
            # Hand the pending apply spans to this pull (the ack). The
            # outbox clears regardless of outcome: a dropped exchange
            # degrades the primary's trace to primary-only, nothing leaks.
            outbox, self._span_outbox = self._span_outbox, []
        try:
            frames, state = tr.pull(self._applied_seq, max_bytes=max_bytes,
                                    span_export=outbox)
        except Corruption:
            # Truncated/bitflipped frame: nothing applied; re-pull later.
            if self.stats is not None:
                self.stats.record_tick(stats_mod.REPLICATION_FRAME_CORRUPT)
            return 0
        except WalRetentionGone:
            if self._mode == "shared":
                # The MANIFEST that advanced past those WALs is in our
                # directory: re-read it instead of copying a checkpoint.
                self._reload_versions()
            else:
                self._bootstrap()
            return 0
        epoch = state.get("epoch")
        if self._mode == "shared" and epoch is not None \
                and epoch != self._epoch:
            self._reload_versions()
            self._epoch = epoch
            return 0  # re-pull from the retention head next round
        self._epoch = epoch
        t_ap = time.monotonic()
        applied = self._apply_frames(frames)
        if applied:
            self._bank_apply_spans(state.get("trace_ctxs"),
                                   (time.monotonic() - t_ap) * 1e6)
        if self._applied_seq is None and state.get("wal_floor_seq") is None:
            # From-head pull and the primary retains NO WAL records: every
            # published sequence is durable in the SSTs our MANIFEST view
            # already covers — adopt the primary's watermark.
            self._applied_seq = state.get(
                "last_sequence", self.versions.last_sequence)
        return applied

    def _bank_apply_spans(self, ctxs, dur_us: float) -> None:
        """Record one finished `follower.apply` span per propagated write
        context this round actually covered; they ride the NEXT pull back
        to the primary and stitch into the write's trace."""
        if not ctxs:
            return
        aseq = self.applied_sequence()
        for c in ctxs:
            if not c.get("trace_id") or c.get("seq", 0) > aseq:
                continue
            self._span_outbox.append({
                "name": "follower.apply",
                "trace_id": c["trace_id"],
                "parent_id": c.get("span_id", 0),
                "span_id": 0,
                "start_us": 0,
                "dur_us": int(dur_us),
                "proc": "follower",
                "tags": {"seq": c.get("seq"), "mode": self._mode,
                         "db": self.dbname},
            })
        if len(self._span_outbox) > 256:
            del self._span_outbox[: len(self._span_outbox) - 256]

    def _apply_frames(self, frames) -> int:
        applied = 0
        now_us = int(time.time() * 1e6)
        for frame in frames:
            if self._applied_seq is not None \
                    and frame.last_seq <= self._applied_seq:
                continue  # duplicate delivery
            if self._applied_seq is not None \
                    and frame.first_seq > self._applied_seq + 1 \
                    and self.stats is not None:
                # Sequences absent from the WAL (disable_wal writes) or an
                # upstream anomaly: observable either way.
                self.stats.record_tick(stats_mod.REPLICATION_FRAME_GAPS)
            mems = {cf_id: cfd.mem for cf_id, cfd in self._cfs.items()}
            for rep in frame.batches:
                b = WriteBatch(rep, protection_bytes_per_key=self._protection)
                cnt = b.count()
                if cnt == 0:
                    continue
                end = b.sequence() + cnt - 1
                if self._applied_seq is not None \
                        and end <= self._applied_seq:
                    continue
                if self._journal is not None:
                    # Journal-first (WAL discipline): a crash between the
                    # append and the insert replays the rep on re-open.
                    self._journal.add_record(rep)
                b.insert_into(mems)
                # Publish order: entries first, then the watermark — a
                # router read that saw applied>=token is guaranteed the
                # token's entries are in the view it snapshots.
                if end > self.versions.last_sequence:
                    self.versions.last_sequence = end
                self._applied_seq = end
                applied += 1
            if self.stats is not None:
                self.stats.record_tick(stats_mod.REPLICATION_FRAMES_APPLIED)
                lag = max(0, now_us - frame.shipped_unix_us)
                self.stats.record_in_histogram(
                    stats_mod.REPLICATION_LAG_MICROS, lag)
        if applied and self.stats is not None:
            self.stats.record_tick(
                stats_mod.REPLICATION_RECORDS_APPLIED, applied)
        return applied

    # -- background tailing ---------------------------------------------

    def start_tailing(self, interval: float = 0.05) -> None:
        if self._tail_thread is not None:
            return
        self._tail_stop.clear()

        def loop():
            while not self._tail_stop.is_set():
                try:
                    self.catch_up()
                except Exception as e:
                    # The loop must survive transient primary restarts /
                    # transport outages; the next round retries.
                    _errors.swallow(reason="tail-loop-retry", exc=e)
                    self.tail_errors += 1
                if self._tail_stop.wait(interval):
                    return

        self._tail_thread = ccy.spawn("tpt-follower-tail", loop, owner=self,
                                      stop=self.stop_tailing)

    def stop_tailing(self) -> None:
        self._tail_stop.set()
        t = self._tail_thread
        if t is not None:
            t.join(timeout=5.0)
            self._tail_thread = None

    def close(self) -> None:
        self.stop_tailing()
        self._close_frame_journal(sync=True)
        super().close()

    # -- admin ----------------------------------------------------------

    def promote(self) -> str:
        """Detach from the (dead) primary: final best-effort catch-up, stop
        tailing, close, and return the path — reopen it with DB.open() for
        read-write service (SidePluginRepo's POST /promote drives this)."""
        self.stop_tailing()
        try:
            self.catch_up()
        except Exception as e:
            # primary is gone; serve what we have
            _errors.swallow(reason="promote-final-catch-up", exc=e)
        path = self.dbname
        self.close()
        return path

    def replication_status(self) -> dict:
        return {
            "role": "follower",
            "mode": self._mode,
            "applied_sequence": self.applied_sequence(),
            "epoch": self._epoch,
            "tailing": self._tail_thread is not None,
            "tail_errors": self.tail_errors,
        }


def _rm_tree(env, path: str) -> None:
    """Best-effort recursive delete through the Env (checkpoint staging)."""
    try:
        for child in env.get_children(path):
            try:
                env.delete_file(f"{path}/{child}")
            except Exception as e:
                _errors.swallow(reason="rm-tree-recurse-dir", exc=e)
                _rm_tree(env, f"{path}/{child}")
    except Exception as e:
        _errors.swallow(reason="rm-tree-best-effort", exc=e)
