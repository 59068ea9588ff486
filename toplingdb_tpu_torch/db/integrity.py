"""IntegrityScrubber: background corruption detection + quarantine (copied
from toplingdb_tpu/db/integrity.py; chunk reads are plain preads, without
the async read ring).

The at-rest half of the integrity plane: a rate-limited walker over the
live SST set that re-reads every file FROM DISK, recomputes its whole-file
checksum, and compares it against the value recorded in the MANIFEST at
flush/compaction/ingest time (utils/file_checksum.py). On a mismatch it

  1. quarantines the file (FileMetaData.quarantined: the compaction
     pickers treat it like a perpetually-busy file, so the corruption is
     never merged into new SSTs),
  2. latches the DB's background-error machinery with a kCorruption
     classification (`reason="scrub"` -> HARD_ERROR: foreground writes
     fail until the operator restores the file, re-scrubs, and calls
     resume(); unlike compaction-found corruption
     it is resumable because nothing corrupt was propagated),
  3. fires the on_corruption_detected listener and bumps the
     INTEGRITY_* tickers + scrub.latency.micros histogram.

A clean re-scan of a previously quarantined file (the operator restored
its bytes) lifts the quarantine. Deep mode additionally opens each table
and iterates every block with CRC verification, and probes each
referenced blob record (record-level CRC).

Cadence: Options.integrity_scrub_period_sec > 0 starts the background
thread at DB.open; db.scrub() runs one pass synchronously either way.
"""

from __future__ import annotations

import threading
import time

from toplingdb_tpu_torch.db import filename
from toplingdb_tpu_torch.utils import statistics as st
from toplingdb_tpu_torch.utils.file_checksum import (
    FileChecksumGenFactory,
    compute_file_checksum,
)
from toplingdb_tpu_torch.utils.status import Corruption
from toplingdb_tpu_torch.utils import errors as _errors


class _Pacer:
    """Token-bucket byte pacer (the scrubber must not starve foreground
    IO; RocksDB's rate-limited file verification)."""

    def __init__(self, bytes_per_sec: int):
        self._rate = max(0, bytes_per_sec)
        self._t0 = time.monotonic()
        self._consumed = 0

    def __call__(self, nbytes: int) -> None:
        if self._rate <= 0:
            return
        self._consumed += nbytes
        ahead = self._consumed / self._rate - (time.monotonic() - self._t0)
        if ahead > 0:
            time.sleep(min(ahead, 0.25))


class IntegrityScrubber:
    def __init__(self, db, bytes_per_sec: int | None = None,
                 period_sec: int | None = None):
        self.db = db
        opts = db.options
        self.bytes_per_sec = (bytes_per_sec if bytes_per_sec is not None
                              else getattr(opts,
                                           "integrity_scrub_bytes_per_sec",
                                           32 << 20))
        self.period_sec = (period_sec if period_sec is not None
                           else getattr(opts,
                                        "integrity_scrub_period_sec", 0))
        self._mu = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._in_progress = False
        # Rolling status (the /integrity HTTP view's payload).
        self.passes = 0
        self.last_pass_time: float | None = None
        self.last_pass_micros = 0
        self.bytes_verified_total = 0
        self.corruptions_total = 0
        self.last_report: dict = {}

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        if self.period_sec <= 0 or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tpt-integrity-scrubber")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.period_sec):
            try:
                self.run_pass()
            except Exception as e:
                # a broken pass must not kill the cadence
                _errors.swallow(reason="integrity-pass-retry", exc=e)

    # -- one pass ------------------------------------------------------

    def _snapshot_files(self):
        """(cf_id, FileMetaData) of every live SST, holding the Version
        objects so obsolete-file GC can't delete files mid-scan."""
        db = self.db
        with db._mutex:
            versions = [(cf_id, db.versions.cf_current(cf_id))
                        for cf_id in db.versions.column_families]
        out = []
        seen: set[int] = set()
        for cf_id, version in versions:
            for _lvl, f in version.all_files():
                if f.number not in seen:
                    seen.add(f.number)
                    out.append((cf_id, f))
        return out, versions  # versions returned to keep the pin alive

    def run_pass(self, deep: bool = False) -> dict:
        """Scrub every live SST once; returns the pass report. Safe to
        call concurrently with foreground traffic (reads through the Env,
        paced)."""
        db = self.db
        with self._mu:
            self._in_progress = True
        t0 = time.perf_counter()
        pacer = _Pacer(self.bytes_per_sec)
        report: dict = {
            "deep": deep,
            "files_scanned": 0,
            "files_skipped_no_checksum": 0,
            "bytes_verified": 0,
            "corruptions": [],
            "repaired": [],
            "quarantined": [],
        }
        try:
            files, _pin = self._snapshot_files()
            for cf_id, meta in files:
                if self._stop.is_set():
                    break
                path = filename.table_file_name(db.dbname, meta.number)
                err = self._scrub_file(db, meta, path, pacer, deep, report)
                if err is None:
                    if meta.quarantined:
                        # The operator restored the bytes: lift quarantine.
                        meta.quarantined = False
                        db._quarantined.discard(meta.number)
                        report["repaired"].append(meta.number)
                else:
                    self._on_corruption(db, meta, path, err, report)
        finally:
            micros = int((time.perf_counter() - t0) * 1e6)
            with self._mu:
                self._in_progress = False
                self.passes += 1
                self.last_pass_time = time.time()
                self.last_pass_micros = micros
                self.bytes_verified_total += report["bytes_verified"]
                self.corruptions_total += len(report["corruptions"])
                report["pass_micros"] = micros
                self.last_report = report
            if db.stats is not None:
                db.stats.record_tick(st.INTEGRITY_SCRUB_PASSES)
                if report["bytes_verified"]:
                    db.stats.record_tick(st.INTEGRITY_BYTES_VERIFIED,
                                         report["bytes_verified"])
                db.stats.record_in_histogram(st.SCRUB_LATENCY_MICROS,
                                             micros)
            db.event_logger.log(
                "integrity_scrub_pass",
                files=report["files_scanned"],
                bytes=report["bytes_verified"],
                corruptions=len(report["corruptions"]),
                micros=micros,
            )
        return report

    def _scrub_file(self, db, meta, path, pacer, deep, report):
        """Returns None when the file is healthy, else the Corruption."""
        if not meta.file_checksum:
            report["files_skipped_no_checksum"] += 1
            return None
        report["files_scanned"] += 1
        try:
            gen = FileChecksumGenFactory(
                meta.file_checksum_func_name or "crc32c").create()
            actual = compute_file_checksum(db.env, path, gen, pacer=pacer)
        except Corruption as e:
            return e
        except Exception as e:  # unreadable file == corrupt for our purposes
            return Corruption(f"{path}: unreadable during scrub: {e!r}")
        if actual != meta.file_checksum:
            return Corruption(
                f"{path}: file checksum mismatch — MANIFEST records "
                f"{meta.file_checksum.hex()} "
                f"({meta.file_checksum_func_name}), disk has "
                f"{actual.hex()}"
            )
        report["bytes_verified"] += meta.file_size
        if deep:
            err = self._deep_scan(db, meta, path, report)
            if err is not None:
                return err
        return None

    def _deep_scan(self, db, meta, path, report):
        """Block-level re-read: every data/meta block CRC re-verified and
        every referenced blob record probed."""
        import dataclasses as _dc

        from toplingdb_tpu_torch.db import dbformat
        from toplingdb_tpu_torch.table.factory import open_table

        try:
            topts = _dc.replace(db.options.table_options,
                                verify_checksums=True)
            reader = open_table(db.env.new_random_access_file(path),
                                db.icmp, topts)
            try:
                it = reader.new_iterator()
                it.seek_to_first()
                for ik, v in it.entries():
                    if ik[-8] == dbformat.ValueType.BLOB_INDEX:
                        db.blob_source.get(v, verify=True)
            finally:
                reader.close()
        except Corruption as e:
            return e
        except Exception as e:
            return Corruption(f"{path}: deep scrub failed: {e!r}")
        return None

    def _on_corruption(self, db, meta, path, err, report) -> None:
        report["corruptions"].append(
            {"file_number": meta.number, "path": path, "error": str(err)})
        if not meta.quarantined:
            meta.quarantined = True
            db._quarantined.add(meta.number)
            report["quarantined"].append(meta.number)
        if db.stats is not None:
            db.stats.record_tick(st.INTEGRITY_CORRUPTIONS_DETECTED)
        from toplingdb_tpu_torch.utils.listener import CorruptionInfo, notify

        notify(db.options.listeners, "on_corruption_detected", db,
               CorruptionInfo(
                   db_name=db.dbname, file_number=meta.number, path=path,
                   reason=str(err),
                   recorded_checksum=meta.file_checksum.hex(),
                   checksum_func_name=meta.file_checksum_func_name,
               ))
        db.event_logger.log("corruption_detected", file_number=meta.number,
                            path=path, error=str(err))
        latch = Corruption(
            f"scrub detected corruption in {path}: {err}; the file is "
            f"quarantined (excluded from compaction). Restore it from a "
            f"backup or replica, re-scrub, then DB.resume()."
        )
        db._set_background_error(latch, reason="scrub")

    # -- status --------------------------------------------------------

    def status(self) -> dict:
        with self._mu:
            return {
                "running": self._thread is not None,
                "in_progress": self._in_progress,
                "period_sec": self.period_sec,
                "bytes_per_sec": self.bytes_per_sec,
                "passes": self.passes,
                "last_pass_time": self.last_pass_time,
                "last_pass_micros": self.last_pass_micros,
                "bytes_verified_total": self.bytes_verified_total,
                "corruptions_total": self.corruptions_total,
                "quarantined_files": sorted(self.db._quarantined),
                "last_report": self.last_report,
            }
