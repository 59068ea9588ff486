"""DB repair: rebuild a usable MANIFEST from the SSTs on disk (copied from
toplingdb_tpu/db/repair.py; RocksDB's db/repair.cc).

Strategy (RocksDB's RepairDB): archive the old MANIFEST/CURRENT,
scan every .sst for bounds/seqnos (checksum-verified), replay any WALs into
fresh L0 tables, then write a new MANIFEST placing every surviving table in L0
— overlap-safe because L0 allows overlapping ranges; the next compaction
re-sorts the tree.

Column families are reconstructed from the column_family_id/name stored in
every table's properties block (RocksDB keeps the same property,
table/table_properties.cc) — WAL records carry their CF ids natively.
"""

from __future__ import annotations

import os

from toplingdb_tpu_torch.db import dbformat, filename
from toplingdb_tpu_torch.db.blob import decode_blob_index
from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator
from toplingdb_tpu_torch.db.flush_job import flush_memtable_to_table
from toplingdb_tpu_torch.db.log import LogReader, LogWriter
from toplingdb_tpu_torch.db.memtable import MemTable
from toplingdb_tpu_torch.db.version_edit import FileMetaData, VersionEdit
from toplingdb_tpu_torch.db.write_batch import WriteBatch
from toplingdb_tpu_torch.env import default_env
from toplingdb_tpu_torch.options import Options
from toplingdb_tpu_torch.table.factory import open_table
from toplingdb_tpu_torch.utils import errors as _errors
from toplingdb_tpu_torch.utils.status import Corruption, NotFound


def repair_db(dbname: str, options: Options | None = None, env=None) -> dict:
    """Rebuild `dbname`'s MANIFEST and CURRENT from its tables and WALs.
    Returns a report dict: tables kept / dropped, WAL records recovered,
    WAL errors, the archived metadata files and the column families."""
    options = options or Options()
    env = env or default_env()
    icmp = InternalKeyComparator(options.comparator)
    report = {"tables_kept": 0, "tables_dropped": 0, "wal_records": 0,
              "archived": []}

    children = env.get_children(dbname)
    # 1. Archive old metadata (lost+found style).
    archive = os.path.join(dbname, "lost")
    env.create_dir(archive)
    for child in children:
        ftype, num = filename.parse_file_name(child)
        if ftype in (filename.FileType.MANIFEST, filename.FileType.CURRENT):
            env.rename_file(f"{dbname}/{child}", f"{archive}/{child}")
            report["archived"].append(child)

    # 2. Scan tables: verified ones survive with recomputed metadata,
    # grouped into their column family (id+name from the properties block).
    metas: dict[int, list[FileMetaData]] = {}
    cf_names: dict[int, str] = {0: "default"}
    max_file_number = 1
    max_seq = 0
    for child in children:
        ftype, num = filename.parse_file_name(child)
        if ftype == filename.FileType.BLOB:
            max_file_number = max(max_file_number, num)  # don't reuse
        if ftype != filename.FileType.TABLE:
            continue
        max_file_number = max(max_file_number, num)
        path = filename.table_file_name(dbname, num)
        try:
            r = open_table(env.new_random_access_file(path), icmp,
                            options.table_options)
            it = r.new_iterator()
            it.seek_to_first()
            smallest = None
            largest = None
            n = 0
            blob_refs = set()
            for k, v in it.entries():  # checksum-verified full scan
                if smallest is None:
                    smallest = k
                largest = k
                n += 1
                if k[-8] == dbformat.ValueType.BLOB_INDEX:
                    # Keep the referenced blob files alive in the rebuilt
                    # MANIFEST, or obsolete-file GC would orphan the values.
                    blob_refs.add(decode_blob_index(v)[0])
            for b, e in r.range_del_entries():
                if smallest is None or icmp.compare(b, smallest) < 0:
                    smallest = b
                end_ikey = dbformat.make_internal_key(
                    e, dbformat.MAX_SEQUENCE_NUMBER,
                    dbformat.VALUE_TYPE_FOR_SEEK,
                )
                if largest is None or icmp.compare(end_ikey, largest) > 0:
                    largest = end_ikey
            if smallest is None:
                raise ValueError("empty table")
            props = r.properties
            cf_id = props.column_family_id
            if props.column_family_name:
                cf_names[cf_id] = props.column_family_name
            else:
                cf_names.setdefault(cf_id, f"cf{cf_id}")
            metas.setdefault(cf_id, []).append(FileMetaData(
                number=num, file_size=env.get_file_size(path),
                smallest=smallest, largest=largest,
                smallest_seqno=props.smallest_seqno,
                largest_seqno=props.largest_seqno,
                num_entries=n,
                num_range_deletions=props.num_range_deletions,
                blob_refs=sorted(blob_refs),
            ))
            max_seq = max(max_seq, props.largest_seqno)
            report["tables_kept"] += 1
        except Exception as e:  # noqa: BLE001 - the table is set aside
            _errors.swallow(reason="repair-table-unreadable", exc=e)
            env.rename_file(path, f"{archive}/{child}")
            report["tables_dropped"] += 1

    # 3. Replay WALs into a fresh L0 table. Only CORRUPTION stops a WAL
    # (its tail is unrecoverable); anything else is a real error the caller
    # must see — swallowing it would silently drop acknowledged writes.
    report["wal_errors"] = 0
    mems: dict[int, MemTable] = {}
    for child in children:
        ftype, num = filename.parse_file_name(child)
        if ftype != filename.FileType.WAL:
            continue
        max_file_number = max(max_file_number, num)
        try:
            reader = LogReader(env.new_sequential_file(
                filename.log_file_name(dbname, num)), log_number=num)
            for rec in reader.records():
                batch = WriteBatch(rec)
                for cf, _, _, _ in batch.entries_cf():
                    if cf not in mems:
                        mems[cf] = MemTable(icmp)
                        cf_names.setdefault(cf, f"cf{cf}")
                batch.insert_into(mems)
                report["wal_records"] += batch.count()
                max_seq = max(max_seq, batch.sequence() + batch.count() - 1)
        except (Corruption, NotFound):
            report["wal_errors"] += 1
    for cf_id, mem in sorted(mems.items()):
        if mem.empty():
            continue
        fnum = max_file_number + 1
        max_file_number = fnum
        meta = flush_memtable_to_table(
            env, dbname, fnum, icmp, [mem], options.table_options,
            column_family=(cf_id, cf_names[cf_id]),
        )
        if meta is not None:
            metas.setdefault(cf_id, []).append(meta)
            report["tables_kept"] += 1

    # 4. Fresh MANIFEST: everything goes to L0 (overlap-legal), with one
    # CF-add record per reconstructed column family.
    manifest_number = max_file_number + 1
    all_cfs = sorted(set(cf_names) | set(metas) | {0})
    records = [VersionEdit(
        comparator=icmp.user_comparator.name(),
        log_number=max_file_number + 2,
        next_file_number=max_file_number + 3,
        last_sequence=max_seq,
        column_family_add="default",
        max_column_family=max(all_cfs),
    )]
    for cf_id in all_cfs:
        if cf_id != 0:
            records.append(VersionEdit(
                column_family=cf_id, column_family_add=cf_names[cf_id]
            ))
        if metas.get(cf_id):
            e = VersionEdit(column_family=cf_id)
            for m in metas[cf_id]:
                e.add_file(0, m)
            records.append(e)
    w = LogWriter(env.new_writable_file(
        filename.manifest_file_name(dbname, manifest_number)))
    for e in records:
        w.add_record(e.encode())
    w.sync()
    w.close()
    filename.set_current_file(env, dbname, manifest_number)
    report["column_families"] = {cf: cf_names[cf] for cf in all_cfs}
    return report
