"""VersionEdit: one MANIFEST record — a delta on the LSM file metadata
(copied from toplingdb_tpu/db/version_edit.py; the same tags and bytes, so
either package reads the other's MANIFEST).

Tag-encoded like RocksDB's db/version_edit.h: a sequence of (varint tag,
payload) fields. Unknown tags are an error (unknown → Corruption).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from toplingdb_tpu_torch.utils import coding
from toplingdb_tpu_torch.utils.status import Corruption

# Tags (toplingdb_tpu's numbering; the same roles as RocksDB's).
TAG_COMPARATOR = 1
TAG_LOG_NUMBER = 2
TAG_NEXT_FILE_NUMBER = 3
TAG_LAST_SEQUENCE = 4
TAG_DELETED_FILE = 5
TAG_NEW_FILE = 6
TAG_PREV_LOG_NUMBER = 7
TAG_MIN_LOG_NUMBER_TO_KEEP = 8
TAG_COLUMN_FAMILY = 9           # selects CF for this edit
TAG_COLUMN_FAMILY_ADD = 10
TAG_COLUMN_FAMILY_DROP = 11
TAG_MAX_COLUMN_FAMILY = 12
TAG_NEW_FILE_EXT = 13           # NEW_FILE + varint flags [+ blob_refs list]
_EXT_FLAG_MARKED = 1            # marked_for_compaction
_EXT_FLAG_BLOBS = 2             # blob_refs list follows
_EXT_FLAG_CHECKSUM = 4          # file checksum (func name + digest) follows


@dataclass
class FileMetaData:
    """Per-SST metadata held in a Version (RocksDB's FileMetaData)."""

    number: int
    file_size: int
    smallest: bytes  # internal key
    largest: bytes   # internal key
    smallest_seqno: int = 0
    largest_seqno: int = 0
    num_entries: int = 0
    num_deletions: int = 0
    num_range_deletions: int = 0
    blob_refs: list[int] = field(default_factory=list)  # referenced blob files
    being_compacted: bool = False  # in-memory only
    # Set by a TablePropertiesCollector's need_compact() — prioritized by the
    # picker; persisted via the extended NEW_FILE tag (RocksDB persists it
    # as a NewFile4 custom field).
    marked_for_compaction: bool = False
    # Whole-file checksum (RocksDB's FileMetaData.file_checksum /
    # file_checksum_func_name, recorded per SST in the MANIFEST): digest
    # bytes + the generator name that produced them (utils/file_checksum).
    # Empty = not recorded (pre-upgrade file or checksums disabled).
    file_checksum: bytes = b""
    file_checksum_func_name: str = ""
    # In-memory only: the IntegrityScrubber found this file's on-disk bytes
    # diverging from the recorded checksum — excluded from compaction picks
    # so the corruption is never baked into new SSTs.
    quarantined: bool = False

    def _ext_flags(self) -> int:
        return ((_EXT_FLAG_MARKED if self.marked_for_compaction else 0)
                | (_EXT_FLAG_BLOBS if self.blob_refs else 0)
                | (_EXT_FLAG_CHECKSUM if self.file_checksum else 0))

    def encode(self, extended: bool = False) -> bytes:
        out = bytearray()
        out += coding.encode_varint64(self.number)
        out += coding.encode_varint64(self.file_size)
        coding.put_length_prefixed_slice(out, self.smallest)
        coding.put_length_prefixed_slice(out, self.largest)
        out += coding.encode_varint64(self.smallest_seqno)
        out += coding.encode_varint64(self.largest_seqno)
        out += coding.encode_varint64(self.num_entries)
        out += coding.encode_varint64(self.num_deletions)
        out += coding.encode_varint64(self.num_range_deletions)
        if extended:
            # Only under TAG_NEW_FILE_EXT — TAG_NEW_FILE keeps the original
            # layout so MANIFESTs written before the flags existed still parse.
            flags = self._ext_flags()
            out += coding.encode_varint64(flags)
            if flags & _EXT_FLAG_BLOBS:
                out += coding.encode_varint64(len(self.blob_refs))
                for fn in self.blob_refs:
                    out += coding.encode_varint64(fn)
            if flags & _EXT_FLAG_CHECKSUM:
                coding.put_length_prefixed_slice(
                    out, self.file_checksum_func_name.encode())
                coding.put_length_prefixed_slice(out, self.file_checksum)
        return bytes(out)

    @staticmethod
    def decode(buf: bytes, off: int,
               extended: bool = False) -> tuple["FileMetaData", int]:
        number, off = coding.decode_varint64(buf, off)
        size, off = coding.decode_varint64(buf, off)
        smallest, off = coding.get_length_prefixed_slice(buf, off)
        largest, off = coding.get_length_prefixed_slice(buf, off)
        ssq, off = coding.decode_varint64(buf, off)
        lsq, off = coding.decode_varint64(buf, off)
        ne, off = coding.decode_varint64(buf, off)
        nd, off = coding.decode_varint64(buf, off)
        nrd, off = coding.decode_varint64(buf, off)
        refs: list[int] = []
        marked = False
        cksum = b""
        cksum_name = ""
        if extended:
            flags, off = coding.decode_varint64(buf, off)
            marked = bool(flags & _EXT_FLAG_MARKED)
            if flags & _EXT_FLAG_BLOBS:
                nrefs, off = coding.decode_varint64(buf, off)
                for _ in range(nrefs):
                    fn, off = coding.decode_varint64(buf, off)
                    refs.append(fn)
            if flags & _EXT_FLAG_CHECKSUM:
                name_b, off = coding.get_length_prefixed_slice(buf, off)
                cksum_name = name_b.decode()
                cksum, off = coding.get_length_prefixed_slice(buf, off)
        return FileMetaData(number, size, smallest, largest, ssq, lsq,
                            ne, nd, nrd, refs,
                            marked_for_compaction=marked,
                            file_checksum=cksum,
                            file_checksum_func_name=cksum_name), off


@dataclass
class VersionEdit:
    comparator: str | None = None
    log_number: int | None = None
    prev_log_number: int | None = None
    next_file_number: int | None = None
    last_sequence: int | None = None
    min_log_number_to_keep: int | None = None
    column_family: int = 0
    column_family_add: str | None = None
    column_family_drop: bool = False
    max_column_family: int | None = None
    new_files: list[tuple[int, FileMetaData]] = field(default_factory=list)
    deleted_files: list[tuple[int, int]] = field(default_factory=list)  # (level, file#)

    def add_file(self, level: int, meta: FileMetaData) -> None:
        self.new_files.append((level, meta))

    def delete_file(self, level: int, number: int) -> None:
        self.deleted_files.append((level, number))

    def encode(self) -> bytes:
        out = bytearray()

        def tag(t: int):
            out.extend(coding.encode_varint32(t))

        if self.comparator is not None:
            tag(TAG_COMPARATOR)
            coding.put_length_prefixed_slice(out, self.comparator.encode())
        if self.log_number is not None:
            tag(TAG_LOG_NUMBER)
            out += coding.encode_varint64(self.log_number)
        if self.prev_log_number is not None:
            tag(TAG_PREV_LOG_NUMBER)
            out += coding.encode_varint64(self.prev_log_number)
        if self.next_file_number is not None:
            tag(TAG_NEXT_FILE_NUMBER)
            out += coding.encode_varint64(self.next_file_number)
        if self.last_sequence is not None:
            tag(TAG_LAST_SEQUENCE)
            out += coding.encode_varint64(self.last_sequence)
        if self.min_log_number_to_keep is not None:
            tag(TAG_MIN_LOG_NUMBER_TO_KEEP)
            out += coding.encode_varint64(self.min_log_number_to_keep)
        if self.column_family:
            tag(TAG_COLUMN_FAMILY)
            out += coding.encode_varint64(self.column_family)
        if self.column_family_add is not None:
            tag(TAG_COLUMN_FAMILY_ADD)
            coding.put_length_prefixed_slice(out, self.column_family_add.encode())
        if self.column_family_drop:
            tag(TAG_COLUMN_FAMILY_DROP)
        if self.max_column_family is not None:
            tag(TAG_MAX_COLUMN_FAMILY)
            out += coding.encode_varint64(self.max_column_family)
        for level, number in self.deleted_files:
            tag(TAG_DELETED_FILE)
            out += coding.encode_varint64(level)
            out += coding.encode_varint64(number)
        for level, meta in self.new_files:
            ext = meta._ext_flags() != 0
            tag(TAG_NEW_FILE_EXT if ext else TAG_NEW_FILE)
            out += coding.encode_varint64(level)
            out += meta.encode(extended=ext)
        return bytes(out)

    @staticmethod
    def decode(buf: bytes) -> "VersionEdit":
        e = VersionEdit()
        off = 0
        while off < len(buf):
            t, off = coding.decode_varint32(buf, off)
            if t == TAG_COMPARATOR:
                s, off = coding.get_length_prefixed_slice(buf, off)
                e.comparator = s.decode()
            elif t == TAG_LOG_NUMBER:
                e.log_number, off = coding.decode_varint64(buf, off)
            elif t == TAG_PREV_LOG_NUMBER:
                e.prev_log_number, off = coding.decode_varint64(buf, off)
            elif t == TAG_NEXT_FILE_NUMBER:
                e.next_file_number, off = coding.decode_varint64(buf, off)
            elif t == TAG_LAST_SEQUENCE:
                e.last_sequence, off = coding.decode_varint64(buf, off)
            elif t == TAG_MIN_LOG_NUMBER_TO_KEEP:
                e.min_log_number_to_keep, off = coding.decode_varint64(buf, off)
            elif t == TAG_COLUMN_FAMILY:
                cf, off = coding.decode_varint64(buf, off)
                e.column_family = cf
            elif t == TAG_COLUMN_FAMILY_ADD:
                s, off = coding.get_length_prefixed_slice(buf, off)
                e.column_family_add = s.decode()
            elif t == TAG_COLUMN_FAMILY_DROP:
                e.column_family_drop = True
            elif t == TAG_MAX_COLUMN_FAMILY:
                e.max_column_family, off = coding.decode_varint64(buf, off)
            elif t == TAG_DELETED_FILE:
                lvl, off = coding.decode_varint64(buf, off)
                num, off = coding.decode_varint64(buf, off)
                e.deleted_files.append((lvl, num))
            elif t == TAG_NEW_FILE or t == TAG_NEW_FILE_EXT:
                lvl, off = coding.decode_varint64(buf, off)
                meta, off = FileMetaData.decode(
                    buf, off, extended=(t == TAG_NEW_FILE_EXT)
                )
                e.new_files.append((lvl, meta))
            else:
                raise Corruption(f"unknown VersionEdit tag {t}")
        return e
