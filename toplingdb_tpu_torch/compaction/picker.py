"""Compaction picking: which files to merge next (copied from
toplingdb_tpu/compaction/picker.py).

The leveled strategy is RocksDB's score-driven picker
(db/compaction/compaction_picker_level.cc): L0 scores by file count
against the trigger, L1+ by level bytes against the target; the highest-
scoring level compacts into level+1, expanding inputs to all overlapping
files. Universal and FIFO pickers cover the other two styles (RocksDB's
compaction_picker_universal.cc, compaction_picker_fifo.cc).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from toplingdb_tpu_torch.db import dbformat
from toplingdb_tpu_torch.db.version_edit import FileMetaData
from toplingdb_tpu_torch.db.version_set import Version


def _busy(f) -> bool:
    """A file the picker must not touch: already in a running job, or
    quarantined (its bytes diverged from the recorded checksum) — corrupt
    bytes must never be merged into new SSTs."""
    return f.being_compacted or f.quarantined


@dataclass
class Compaction:
    """A picked compaction: inputs at `level` (+ overlapping at output_level),
    producing files at output_level (RocksDB's db/compaction/compaction.h)."""

    level: int
    output_level: int
    inputs: list[FileMetaData]          # files at `level`
    output_level_inputs: list[FileMetaData] = field(default_factory=list)
    bottommost: bool = False
    reason: str = ""
    max_output_file_size: int = 8 * 1024 * 1024
    cf_id: int = 0
    # User-defined-timestamp history trim point (full_history_ts_low):
    # among versions with ts < this, only the newest survives compaction.
    # 0 = keep all.
    full_history_ts_low: int = 0

    def all_inputs(self) -> list[tuple[int, FileMetaData]]:
        return [(self.level, f) for f in self.inputs] + [
            (self.output_level, f) for f in self.output_level_inputs
        ]

    def total_input_bytes(self) -> int:
        return sum(f.file_size for _, f in self.all_inputs())

    def num_input_files(self) -> int:
        return len(self.inputs) + len(self.output_level_inputs)


class CompactionPicker:
    def __init__(self, options, icmp):
        self.options = options
        self.icmp = icmp

    def compaction_score(self, version: Version) -> list[tuple[float, int]]:
        raise NotImplementedError

    def pick_compaction(self, version: Version) -> Compaction | None:
        raise NotImplementedError

    # -- shared helpers -------------------------------------------------

    def _key_range(self, files) -> tuple[bytes, bytes]:
        smallest = min((f.smallest for f in files), key=self.icmp.sort_key)
        largest = max((f.largest for f in files), key=self.icmp.sort_key)
        return smallest, largest

    def _expand_range_to_level(self, version: Version, level: int,
                               smallest: bytes, largest: bytes) -> list[FileMetaData]:
        """All files at `level` overlapping [smallest, largest] (internal
        keys) — INCLUDING being_compacted ones, so callers can detect a
        conflict with a running job and abort the pick (silently omitting
        them would produce overlapping outputs)."""
        su = dbformat.extract_user_key(smallest)
        lu = dbformat.extract_user_key(largest)
        return version.overlapping_files(level, su, lu)

    def _is_bottommost(self, version: Version, output_level: int,
                       smallest: bytes, largest: bytes) -> bool:
        ucmp = self.icmp.user_comparator
        su = dbformat.extract_user_key(smallest)
        lu = dbformat.extract_user_key(largest)
        for lvl in range(output_level + 1, version.num_levels):
            if version.overlapping_files(lvl, su, lu):
                return False
        return True



class LeveledCompactionPicker(CompactionPicker):
    def compaction_score(self, version: Version) -> list[tuple[float, int]]:
        """(score, level) sorted descending; score >= 1.0 needs compaction
        (RocksDB's VersionStorageInfo::ComputeCompactionScore)."""
        scores = []
        l0 = [f for f in version.files[0] if not _busy(f)]
        l0_score = len(l0) / self.options.level0_file_num_compaction_trigger
        if any(f.marked_for_compaction for f in l0):
            l0_score = max(l0_score, 1.0)
        scores.append((l0_score, 0))
        last = version.num_levels - 1
        if any(f.marked_for_compaction and not _busy(f)
               for f in version.files[last]):
            # Bottommost marked files are rewritten in place (RocksDB's
            # bottommost_files_marked_for_compaction_).
            scores.append((1.0, last))
        for level in range(1, version.num_levels - 1):
            total = sum(
                f.file_size for f in version.files[level] if not _busy(f)
            )
            score = total / self.options.max_bytes_for_level(level)
            if any(f.marked_for_compaction and not _busy(f)
                   for f in version.files[level]):
                # Collector-flagged files (RocksDB's
                # files_marked_for_compaction_) force the level eligible.
                score = max(score, 1.0)
            scores.append((score, level))
        scores.sort(key=lambda s: -s[0])
        return scores

    def pick_compaction(self, version: Version) -> Compaction | None:
        for score, level in self.compaction_score(version):
            if score < 1.0:
                break
            c = self._pick_level(version, level)
            if c is not None:
                return c
        return None

    # RocksDB's kMinFilesForIntraL0Compaction.
    _INTRA_L0_MIN_FILES = 4

    def _try_intra_l0(self, version: Version) -> Compaction | None:
        """L0→L0 merge of the newest CONTIGUOUS run of free files
        (RocksDB's TryPickIntraL0Compaction, compaction_picker.cc): L0
        files hold disjoint seqno intervals in newest-first order, so a
        contiguous prefix merges into one file that slots back at its
        position; non-contiguous picks could interleave seqnos."""
        run = []
        total = 0
        cap = self.options.max_compaction_bytes or (1 << 62)
        for f in version.files[0]:  # newest-first
            if _busy(f):
                break
            if total + f.file_size > cap and run:
                break
            run.append(f)
            total += f.file_size
        if len(run) < self._INTRA_L0_MIN_FILES:
            return None
        return Compaction(
            level=0, output_level=0, inputs=run, output_level_inputs=[],
            bottommost=False, reason="intra-L0",
            max_output_file_size=1 << 62,  # one output file
        )

    def _pick_level(self, version: Version, level: int) -> Compaction | None:
        if level == version.num_levels - 1:
            # In-place rewrite of a collector-marked bottommost file.
            marked = [f for f in version.files[level]
                      if f.marked_for_compaction and not _busy(f)]
            if not marked:
                return None
            f0 = marked[0]
            return Compaction(
                level=level, output_level=level, inputs=[f0],
                output_level_inputs=[], bottommost=True,
                reason="bottommost marked",
                max_output_file_size=self.options.target_file_size(level),
            )
        if level == 0:
            inputs = [f for f in version.files[0] if not _busy(f)]
            if (len(inputs) < self.options.level0_file_num_compaction_trigger
                    and not any(f.marked_for_compaction for f in inputs)):
                return None
            if not inputs or any(_busy(f) for f in version.files[0]):
                # L0→L1 must take all L0 files; while some are busy,
                # compact the free newest prefix L0→L0 instead
                # (RocksDB's TryPickIntraL0Compaction) so read-amp and
                # the L0 stall triggers keep falling.
                return self._try_intra_l0(version)
            output_level = 1
        else:
            # Pick the largest not-being-compacted file (simple heuristic;
            # RocksDB uses kByCompensatedSize by default).
            candidates = [f for f in version.files[level] if not _busy(f)]
            if not candidates:
                return None
            marked = [f for f in candidates if f.marked_for_compaction]
            inputs = [max(marked or candidates, key=lambda f: f.file_size)]
            output_level = level + 1
        if output_level >= version.num_levels:
            return None
        smallest, largest = self._key_range(inputs)
        if level > 0:
            # Expand inputs at the same level to cover the user-key range
            # fully; abort on conflict with a running job.
            more = self._expand_range_to_level(version, level, smallest, largest)
            if any(_busy(f) for f in more):
                return None
            merged = {f.number: f for f in inputs + more}
            inputs = sorted(merged.values(), key=lambda f: f.number)
            smallest, largest = self._key_range(inputs)
        outputs = self._expand_range_to_level(version, output_level, smallest, largest)
        if any(_busy(f) for f in outputs):
            return self._try_intra_l0(version) if level == 0 else None
        all_small, all_large = self._key_range(inputs + outputs) if outputs else (smallest, largest)
        return Compaction(
            level=level,
            output_level=output_level,
            inputs=inputs,
            output_level_inputs=outputs,
            bottommost=self._is_bottommost(version, output_level, all_small, all_large),
            reason=f"L{level} score",
            max_output_file_size=self.options.target_file_size(output_level),
        )


class UniversalCompactionPicker(CompactionPicker):
    """Size-tiered universal compaction over L0-resident sorted runs
    (RocksDB's compaction_picker_universal.cc). Runs live in L0 (newest
    first) plus at most one full-keyspace run in the last level. Every job
    writes one output (no size cut)."""

    def compaction_score(self, version: Version) -> list[tuple[float, int]]:
        n = len(version.files[0])
        return [(n / max(1, self.options.level0_file_num_compaction_trigger), 0)]

    def pick_compaction(self, version: Version) -> Compaction | None:
        runs = [f for f in version.files[0] if not _busy(f)]
        if len(runs) < self.options.level0_file_num_compaction_trigger:
            return None
        if any(_busy(f) for f in version.files[0]):
            return None
        opts = self.options
        # 1. Size-amplification trigger: the younger runs' bytes against
        # the last level's, in percent.
        last_level = version.num_levels - 1
        base = version.files[last_level]
        younger_bytes = sum(f.file_size for f in runs)
        base_bytes = sum(f.file_size for f in base)
        if base and not any(_busy(f) for f in base):
            if base_bytes > 0 and younger_bytes * 100 >= (
                opts.universal_max_size_amplification_percent * base_bytes
            ):
                return Compaction(
                    level=0, output_level=last_level, inputs=runs,
                    output_level_inputs=list(base), bottommost=True,
                    reason="universal size-amp",
                    max_output_file_size=2**62,
                )
        # 2. Size-ratio trigger: merge a run of similar-sized runs, oldest
        # first (runs are sorted newest to oldest).
        picked = [runs[-1]]
        total = runs[-1].file_size
        for f in reversed(runs[:-1]):
            if total * (100 + opts.universal_size_ratio) >= f.file_size * 100:
                picked.append(f)
                total += f.file_size
            else:
                break
        if len(picked) >= opts.universal_min_merge_width:
            picked = picked[: opts.universal_max_merge_width]
            picked_set = {f.number for f in picked}
            inputs = [f for f in version.files[0] if f.number in picked_set]
            bottom = self._is_bottommost(
                version, 0, *self._key_range(inputs)
            ) and len(inputs) == len(version.files[0])
            return Compaction(
                level=0, output_level=0, inputs=inputs,
                bottommost=bottom, reason="universal size-ratio",
                max_output_file_size=2**62,
            )
        # 3. Otherwise merge every run into the last level.
        if base and any(_busy(f) for f in base):
            return None
        return Compaction(
            level=0, output_level=last_level, inputs=runs,
            output_level_inputs=list(base), bottommost=True,
            reason="universal merge-all", max_output_file_size=2**62,
        )


class FIFOCompactionPicker(CompactionPicker):
    """Drop the oldest files when the total size exceeds the budget, or
    when they are older than fifo_ttl_seconds (RocksDB's
    compaction_picker_fifo.cc with CompactionOptionsFIFO.ttl).
    Deletion-only: a FIFO compaction writes nothing. `creation_time_fn`
    (set by the scheduler) reads a file's creation time from its table
    properties."""

    creation_time_fn = None  # f -> unix time | None

    def compaction_score(self, version: Version) -> list[tuple[float, int]]:
        total = sum(f.file_size for f in version.files[0])
        score = total / max(1, self.options.fifo_max_table_files_size)
        if self._ttl_expired(version):
            score = max(score, 1.0)
        return [(score, 0)]

    def _ttl_expired(self, version: Version) -> list:
        ttl = self.options.fifo_ttl_seconds
        if not ttl or self.creation_time_fn is None:
            return []
        cutoff = int(time.time()) - ttl
        out = []
        for f in version.files[0]:
            if _busy(f):
                continue
            ct = self.creation_time_fn(f)
            if ct and ct <= cutoff:
                out.append(f)
        return out

    def pick_compaction(self, version: Version) -> Compaction | None:
        expired = self._ttl_expired(version)
        if expired:
            return Compaction(
                level=0, output_level=0, inputs=expired, reason="fifo ttl",
            )
        total = sum(f.file_size for f in version.files[0])
        if total <= self.options.fifo_max_table_files_size:
            return None
        # files[0] is newest first: drop from the tail (the oldest).
        drop = []
        for f in reversed(version.files[0]):
            if _busy(f):
                break
            drop.append(f)
            total -= f.file_size
            if total <= self.options.fifo_max_table_files_size:
                break
        if not drop:
            return None
        return Compaction(
            level=0, output_level=0, inputs=drop, reason="fifo ttl/size",
        )


def create_picker(options, icmp) -> CompactionPicker:
    style = options.compaction_style
    if style == "leveled":
        return LeveledCompactionPicker(options, icmp)
    if style == "universal":
        return UniversalCompactionPicker(options, icmp)
    if style == "fifo":
        return FIFOCompactionPicker(options, icmp)
    from toplingdb_tpu_torch.utils.status import InvalidArgument

    raise InvalidArgument(f"unknown compaction style {style!r}")
