"""Version / VersionSet: the LSM metadata spine (copied from
toplingdb_tpu/db/version_set.py, with the column families and without the
replication epoch and the read-only recovery).

The roles of RocksDB's Version / VersionSet / VersionBuilder
(db/version_set.cc `Version::Get`, `LogAndApply`, `Recover`): a Version is
an immutable snapshot of the file DAG (per-level sorted file lists);
VersionSet owns the current Version, the MANIFEST log, and the file and
sequence number allocators; VersionBuilder applies VersionEdits to produce
new Versions. The MANIFEST records are toplingdb_tpu's, so either package
opens the other's DB directory.

Column families (RocksDB's ColumnFamilySet): each CF has its own Version;
one MANIFEST, one file-number allocator and one sequence serve them all.
An edit names its CF (`VersionEdit.column_family`); an edit for a CF that
was dropped meanwhile is discarded, as a device job may finish after its
CF was dropped.
"""

from __future__ import annotations

import threading
import weakref

from toplingdb_tpu_torch.db import dbformat, filename
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator
from toplingdb_tpu_torch.db.log import LogReader, LogWriter
from toplingdb_tpu_torch.db.version_edit import FileMetaData, VersionEdit
from toplingdb_tpu_torch.utils.status import Corruption, InvalidArgument


# A read chain pins a reader and a dup'd fd per file for the version's
# lifetime: past the reference table cache's default capacity the
# version's gets run the Python chain instead, as in toplingdb_tpu.
_MAX_CHAIN_FILES = 512


class Version:
    """Immutable per-point-in-time file layout: files[level] sorted by
    smallest key (L1+) / newest-first (L0)."""

    def __init__(self, icmp: InternalKeyComparator, num_levels: int):
        self.icmp = icmp
        self.num_levels = num_levels
        self.files: list[list[FileMetaData]] = [[] for _ in range(num_levels)]

    # -- read path ------------------------------------------------------

    def overlapping_files(self, level: int, smallest_user_key: bytes | None,
                          largest_user_key: bytes | None) -> list[FileMetaData]:
        """Files whose user-key range intersects [smallest, largest].
        L1+ file lists are sorted and disjoint, so the scan bisects to the
        first candidate instead of walking the level."""
        ucmp = self.icmp.user_comparator
        fl = self.files[level]
        start = 0
        if level > 0 and smallest_user_key is not None and fl:
            lo, hi = 0, len(fl)
            while lo < hi:
                mid = (lo + hi) // 2
                if ucmp.compare(dbformat.extract_user_key(fl[mid].largest),
                                smallest_user_key) < 0:
                    lo = mid + 1
                else:
                    hi = mid
            start = lo
        out = []
        for f in fl[start:]:
            f_small = dbformat.extract_user_key(f.smallest)
            f_large = dbformat.extract_user_key(f.largest)
            if smallest_user_key is not None and ucmp.compare(f_large, smallest_user_key) < 0:
                continue
            if largest_user_key is not None and ucmp.compare(f_small, largest_user_key) > 0:
                if level > 0:
                    break  # sorted disjoint: nothing further overlaps
                continue
            out.append(f)
        return out

    def native_read_chain(self, table_cache):
        """Native read-chain handle for tpulsm_db_get (built once: a
        Version is immutable): L0 newest-first then the deeper levels, each
        table's handle from its cached reader. Returns the handle, or None
        when the native library is unavailable, a table has no handle, or
        the version holds more files than _MAX_CHAIN_FILES. The chain keeps
        strong refs to every reader, so the table handles outlive it."""
        cached = getattr(self, "_nchain", False)
        if cached is not False:
            return cached[0] if cached else None
        import ctypes

        from toplingdb_tpu_torch import native
        from toplingdb_tpu_torch.utils import errors

        cl = native.lib()
        if cl is None or sum(len(fl) for fl in self.files) > _MAX_CHAIN_FILES:
            self._nchain = None
            return None
        readers, handles = [], []
        level_offs = []
        try:
            for level in range(self.num_levels):
                for f in self.files[level]:
                    r = table_cache.get_reader(f.number)
                    h = r.native_get_handle(
                        dbformat.extract_user_key(f.smallest),
                        dbformat.extract_user_key(f.largest),
                    )
                    if h is None:
                        self._nchain = None
                        return None
                    readers.append(r)
                    handles.append(h)
                # level_offs[0] == n_l0; [li], [li+1] bound deeper level li.
                level_offs.append(len(handles))
        except Exception as e:  # noqa: BLE001 - the Python chain serves
            errors.swallow(reason="native-chain-build-fallback", exc=e)
            self._nchain = None
            return None
        offs = (ctypes.c_int32 * len(level_offs))(*level_offs)
        arr = (ctypes.c_void_p * max(1, len(handles)))(*handles)
        vh = cl.tpulsm_version_handle_new(arr, level_offs[0], offs,
                                          self.num_levels - 1)
        if not vh:
            self._nchain = None
            return None
        self._nchain = (vh, readers)
        weakref.finalize(self, cl.tpulsm_version_handle_free, vh)
        return vh

    def files_for_get(self, user_key: bytes):
        """Yield files that may contain user_key, newest data first:
        L0 newest-to-oldest, then each deeper level's single candidate
        (RocksDB's FilePicker)."""
        ucmp = self.icmp.user_comparator
        for f in self.files[0]:  # already newest-first
            if (ucmp.compare(dbformat.extract_user_key(f.smallest), user_key) <= 0
                    and ucmp.compare(user_key, dbformat.extract_user_key(f.largest)) <= 0):
                yield 0, f
        for level in range(1, self.num_levels):
            fl = self.files[level]
            if not fl:
                continue
            lo, hi = 0, len(fl) - 1
            pick = None
            while lo <= hi:
                mid = (lo + hi) // 2
                if ucmp.compare(dbformat.extract_user_key(fl[mid].largest), user_key) < 0:
                    lo = mid + 1
                else:
                    pick = mid
                    hi = mid - 1
            if pick is not None and ucmp.compare(
                dbformat.extract_user_key(fl[pick].smallest), user_key
            ) <= 0:
                yield level, fl[pick]
                # A range tombstone's exclusive end widens a file's largest
                # bound to (end_uk, MAX_SEQ); the NEXT file may legally start
                # at the same user key (RocksDB's FilePicker walks files
                # while the user key still overlaps).
                while (pick + 1 < len(fl) and ucmp.compare(
                        dbformat.extract_user_key(fl[pick + 1].smallest),
                        user_key) <= 0):
                    pick += 1
                    yield level, fl[pick]

    def total_bytes(self, level: int) -> int:
        return sum(f.file_size for f in self.files[level])

    def num_files(self) -> int:
        return sum(len(fl) for fl in self.files)

    def all_files(self):
        for level, fl in enumerate(self.files):
            for f in fl:
                yield level, f

    def describe(self) -> str:
        lines = []
        for level, fl in enumerate(self.files):
            if fl:
                lines.append(
                    f"L{level}: " + " ".join(
                        f"{f.number}({f.file_size})" for f in fl
                    )
                )
        return "\n".join(lines)


class VersionBuilder:
    """Applies edits on a base Version to produce the next one (RocksDB's
    db/version_builder.cc)."""

    def __init__(self, base: Version):
        self._base = base
        self._added: list[list[FileMetaData]] = [[] for _ in range(base.num_levels)]
        self._deleted: set[tuple[int, int]] = set()

    def apply(self, edit: VersionEdit) -> None:
        for level, number in edit.deleted_files:
            self._deleted.add((level, number))
            # Multi-edit replay (MANIFEST recovery): a file added by an
            # earlier edit and deleted later must not survive in _added.
            self._added[level] = [
                f for f in self._added[level] if f.number != number
            ]
        for level, meta in edit.new_files:
            self._deleted.discard((level, meta.number))
            self._added[level].append(meta)

    def save(self) -> Version:
        v = Version(self._base.icmp, self._base.num_levels)
        icmp = self._base.icmp
        for level in range(self._base.num_levels):
            merged = [
                f for f in self._base.files[level]
                if (level, f.number) not in self._deleted
            ] + self._added[level]
            if level == 0:
                # Newest data first, by seqno (then file number).
                merged.sort(key=lambda m: (-m.largest_seqno, -m.number))
            else:
                merged.sort(key=lambda m: _SmallestKey(icmp, m.smallest))
                # Sanity: non-overlapping ranges in L1+.
                for a, b in zip(merged, merged[1:]):
                    if icmp.compare(a.largest, b.smallest) >= 0:
                        raise Corruption(
                            f"overlapping files at L{level}: "
                            f"{a.number} and {b.number}"
                        )
            v.files[level] = merged
        return v


class _SmallestKey:
    __slots__ = ("icmp", "k")

    def __init__(self, icmp, k):
        self.icmp = icmp
        self.k = k

    def __lt__(self, other):
        return self.icmp.compare(self.k, other.k) < 0


class ColumnFamilyState:
    """Per-CF metadata inside the VersionSet (RocksDB's ColumnFamilyData,
    db/column_family.h)."""

    __slots__ = ("cf_id", "name", "current", "dropped")

    def __init__(self, cf_id: int, name: str, current: Version):
        self.cf_id = cf_id
        self.name = name
        self.current = current
        self.dropped = False


class VersionSet:
    def __init__(self, env, dbname: str, icmp: InternalKeyComparator,
                 num_levels: int = 7):
        self.env = env
        self.dbname = dbname
        self.icmp = icmp
        self.num_levels = num_levels
        # Weak registry of every Version still referenced anywhere (readers
        # hold strong refs while in flight) — the GC analogue of RocksDB's
        # Version refcounts: obsolete-file deletion must respect files
        # visible to ANY live Version, not just the current ones.
        self._all_versions: "weakref.WeakSet[Version]" = weakref.WeakSet()
        v0 = Version(icmp, num_levels)
        self._all_versions.add(v0)
        self.column_families: dict[int, ColumnFamilyState] = {
            0: ColumnFamilyState(0, "default", v0)
        }
        self.max_column_family = 0
        self.last_sequence = 0
        self.log_number = 0          # WALs with number < this are obsolete
        self.prev_log_number = 0
        self.manifest_file_number = 0
        self._next_file_number = 2
        self._manifest_writer: LogWriter | None = None
        self._lock = threading.Lock()

    # The default CF's Version: the single-CF view wherever the CF does not
    # matter.
    @property
    def current(self) -> Version:
        return self.column_families[0].current

    @current.setter
    def current(self, v: Version) -> None:
        self.column_families[0].current = v

    def cf_current(self, cf_id: int) -> Version:
        return self.column_families[cf_id].current

    # -- number allocation ---------------------------------------------

    def new_file_number(self) -> int:
        with self._lock:
            n = self._next_file_number
            self._next_file_number += 1
            return n

    def mark_file_number_used(self, n: int) -> None:
        with self._lock:
            if self._next_file_number <= n:
                self._next_file_number = n + 1

    @property
    def next_file_number(self) -> int:
        return self._next_file_number

    # -- manifest lifecycle --------------------------------------------

    def create_new(self) -> None:
        """Initialize a brand-new DB: write the MANIFEST snapshot + CURRENT."""
        self.manifest_file_number = self.new_file_number()
        edit = VersionEdit(
            comparator=self.icmp.user_comparator.name(),
            log_number=0,
            next_file_number=self._next_file_number,
            last_sequence=0,
            column_family_add="default",
            max_column_family=0,
        )
        path = filename.manifest_file_name(self.dbname, self.manifest_file_number)
        w = self.env.new_writable_file(path)
        self._manifest_writer = LogWriter(w)
        self._manifest_writer.add_record(edit.encode())
        self._manifest_writer.sync()
        filename.set_current_file(self.env, self.dbname, self.manifest_file_number)

    def recover(self) -> None:
        """Replay CURRENT → MANIFEST into the in-memory state (RocksDB's
        VersionSet::Recover): every CF's adds, drops and file edits, then
        roll the MANIFEST into a fresh snapshot file for appending."""
        cur = self.env.read_file(filename.current_file_name(self.dbname))
        try:
            name = cur.decode().strip()
        except UnicodeDecodeError:
            raise Corruption("CURRENT file holds undecodable bytes") from None
        if not name.startswith("MANIFEST-"):
            raise Corruption(f"CURRENT points at {name!r}")
        try:
            self.manifest_file_number = int(name[len("MANIFEST-"):])
        except ValueError:
            raise Corruption(f"CURRENT points at {name!r}") from None
        path = filename.manifest_file_name(self.dbname, self.manifest_file_number)
        reader = LogReader(self.env.new_sequential_file(path))
        builders: dict[int, VersionBuilder] = {}
        cf_names: dict[int, str] = {}
        dropped: set[int] = set()
        have_comparator = None
        next_cf_hint = 0
        have_log_number = have_next_file = have_last_seq = False
        n_records = 0
        for rec in reader.records():
            n_records += 1
            edit = VersionEdit.decode(rec)
            cf = edit.column_family
            if edit.column_family_add is not None:
                cf_names[cf] = edit.column_family_add
                builders.setdefault(
                    cf, VersionBuilder(Version(self.icmp, self.num_levels)))
            if edit.column_family_drop:
                dropped.add(cf)
            if edit.max_column_family is not None:
                next_cf_hint = max(next_cf_hint, edit.max_column_family)
            if edit.comparator is not None:
                have_comparator = edit.comparator
            if edit.log_number is not None:
                self.log_number = edit.log_number
                have_log_number = True
            if edit.prev_log_number is not None:
                self.prev_log_number = edit.prev_log_number
            if edit.next_file_number is not None:
                self._next_file_number = edit.next_file_number
                have_next_file = True
            if edit.last_sequence is not None:
                self.last_sequence = edit.last_sequence
                have_last_seq = True
            if edit.new_files or edit.deleted_files:
                builders.setdefault(
                    cf, VersionBuilder(Version(self.icmp, self.num_levels))
                ).apply(edit)
        if have_comparator is not None and have_comparator != self.icmp.user_comparator.name():
            raise Corruption(
                f"comparator mismatch: DB created with {have_comparator}, "
                f"opened with {self.icmp.user_comparator.name()}"
            )
        # A readable manifest MUST yield the descriptor fields: a corrupt
        # head otherwise "recovers" an EMPTY DB — the log reader treats
        # undecodable bytes as a torn tail, which is only valid AFTER a
        # good snapshot record.
        if not (have_next_file and have_last_seq and have_log_number):
            missing = [name for ok, name in (
                (have_next_file, "next-file"), (have_last_seq, "last-seq"),
                (have_log_number, "log-number")) if not ok]
            raise Corruption(
                f"manifest {path} yields no {'/'.join(missing)} entry "
                f"({n_records} records decoded): corrupt descriptor head"
            )
        builders.setdefault(0, VersionBuilder(Version(self.icmp, self.num_levels)))
        cf_names.setdefault(0, "default")
        self.column_families = {}
        for cf, b in builders.items():
            if cf in dropped:
                continue
            v = b.save()
            self._all_versions.add(v)
            self.column_families[cf] = ColumnFamilyState(
                cf, cf_names.get(cf, f"cf{cf}"), v)
        self.max_column_family = max(
            [next_cf_hint] + list(self.column_families))
        self.mark_file_number_used(self.manifest_file_number)
        self._reopen_manifest_for_append()

    def _reopen_manifest_for_append(self) -> None:
        # The Env has no append mode: rewrite the manifest as a fresh
        # snapshot in a new file. This also bounds manifest growth on
        # reopen (RocksDB rolls the manifest similarly on recovery).
        self.manifest_file_number = self.new_file_number()
        newpath = filename.manifest_file_name(self.dbname, self.manifest_file_number)
        w = self.env.new_writable_file(newpath)
        self._manifest_writer = LogWriter(w)
        for snap in self._snapshot_edits():
            self._manifest_writer.add_record(snap.encode())
        self._manifest_writer.sync()
        filename.set_current_file(self.env, self.dbname, self.manifest_file_number)

    def _snapshot_edits(self) -> list[VersionEdit]:
        """One snapshot record per CF, in id order; the default CF's also
        carries the descriptor fields."""
        edits = []
        for cf_id in sorted(self.column_families):
            st = self.column_families[cf_id]
            edit = VersionEdit(
                column_family=cf_id,
                column_family_add=st.name,
                max_column_family=self.max_column_family,
            )
            if cf_id == 0:
                edit.comparator = self.icmp.user_comparator.name()
                edit.log_number = self.log_number
                edit.prev_log_number = self.prev_log_number
                edit.next_file_number = self._next_file_number
                edit.last_sequence = self.last_sequence
            for level, f in st.current.all_files():
                edit.add_file(level, f)
            edits.append(edit)
        return edits

    def log_and_apply(self, edit: VersionEdit, sync: bool = True) -> None:
        """Append edit to the MANIFEST and install the resulting Version for
        the edit's column family (RocksDB's VersionSet::LogAndApply). An
        edit for a CF dropped meanwhile is discarded. Failures are tagged
        _bg_reason="manifest", so the DB's error handler latches them FATAL
        whichever caller surfaced them (RocksDB's
        BackgroundErrorReason::kManifestWrite)."""
        try:
            self._log_and_apply_locked(edit, sync)
        except BaseException as e:
            try:
                e._bg_reason = "manifest"
            except AttributeError:
                pass  # exceptions with __slots__: classification falls back
            raise

    def _log_and_apply_locked(self, edit: VersionEdit,
                              sync: bool = True) -> None:
        with self._lock:
            st = self.column_families.get(edit.column_family)
            if st is None:
                return
            if edit.log_number is not None:
                assert edit.log_number >= self.log_number
                self.log_number = edit.log_number
            edit.next_file_number = self._next_file_number
            edit.last_sequence = self.last_sequence
            builder = VersionBuilder(st.current)
            builder.apply(edit)
            new_version = builder.save()
            assert self._manifest_writer is not None
            self._manifest_writer.add_record(edit.encode())
            if sync:
                self._manifest_writer.sync()
            self._all_versions.add(new_version)
            st.current = new_version

    def create_column_family(self, name: str) -> int:
        """Register a new CF in the MANIFEST; returns its id (RocksDB's
        VersionSet::CreateColumnFamily). Ids are never reused: a name
        created again after a drop gets a fresh id."""
        with self._lock:
            for st in self.column_families.values():
                if st.name == name:
                    raise Corruption(f"column family {name!r} already exists")
            cf_id = self.max_column_family + 1
            self.max_column_family = cf_id
            edit = VersionEdit(
                column_family=cf_id, column_family_add=name,
                max_column_family=cf_id,
            )
            assert self._manifest_writer is not None
            self._manifest_writer.add_record(edit.encode())
            self._manifest_writer.sync()
            v = Version(self.icmp, self.num_levels)
            self._all_versions.add(v)
            self.column_families[cf_id] = ColumnFamilyState(cf_id, name, v)
            return cf_id

    def drop_column_family(self, cf_id: int) -> None:
        """Record the drop in the MANIFEST. The default CF cannot be
        dropped; dropping an unknown (or already dropped) CF raises
        InvalidArgument."""
        with self._lock:
            if cf_id == 0:
                raise Corruption("cannot drop the default column family")
            if cf_id not in self.column_families:
                raise InvalidArgument(
                    f"column family {cf_id} does not exist (double drop?)")
            st = self.column_families.pop(cf_id)
            st.dropped = True
            edit = VersionEdit(column_family=cf_id, column_family_drop=True)
            assert self._manifest_writer is not None
            self._manifest_writer.add_record(edit.encode())
            self._manifest_writer.sync()

    def close(self) -> None:
        if self._manifest_writer is not None:
            self._manifest_writer.close()
            self._manifest_writer = None

    # -- introspection --------------------------------------------------

    def live_file_sets(self) -> tuple[set[int], set[int]]:
        """(sst_numbers, blob_numbers) referenced by any CF's current
        version OR any version still held by an in-flight reader/iterator —
        the deletion guards for obsolete-file GC, filled in one pass."""
        ssts: set[int] = set()
        blobs: set[int] = set()
        versions = list(self._all_versions) + [
            st.current for st in self.column_families.values()]
        for v in versions:
            for _, f in v.all_files():
                ssts.add(f.number)
                blobs.update(f.blob_refs)
        return ssts, blobs
