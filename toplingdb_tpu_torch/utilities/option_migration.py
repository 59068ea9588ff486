"""Option-change migration (copied from
toplingdb_tpu/utilities/option_migration.py; RocksDB's
utilities/option_change_migration/option_change_migration.cc): reshape an
existing DB's file layout so a different compaction style's invariants
hold before it reopens with the new options:

  * to leveled: any layout is legal; a full manual compaction tidies it.
  * to universal: the picker sees L0 runs and one base run in the last
    level; a full compaction leaves exactly that shape.
  * to fifo: ALL files must live in L0 (fifo only ever looks there);
    after compacting, every file is MOVED to L0 (overlap-legal).
"""

from __future__ import annotations

from toplingdb_tpu_torch.db.db import DB
from toplingdb_tpu_torch.db.version_edit import VersionEdit
from toplingdb_tpu_torch.options import Options


def migrate_options(dbname: str, from_options: Options, to_options: Options,
                    env=None) -> None:
    """Run the migration and persist the new options. The DB must be closed;
    it is reopened briefly twice (old options to reshape, new to validate)."""
    with DB.open(dbname, from_options, env=env) as db:
        db.compact_range()  # one sorted run at the bottom
        if to_options.compaction_style == "fifo":
            moved = False
            with db._mutex:
                for cf_id in db.versions.column_families:
                    v = db.versions.cf_current(cf_id)
                    edit = VersionEdit(column_family=cf_id)
                    any_move = False
                    for level in range(1, v.num_levels):
                        for f in v.files[level]:
                            edit.delete_file(level, f.number)
                            edit.add_file(0, f)
                            any_move = True
                    if any_move:
                        db._install_edit(edit)
                        moved = True
            if moved:
                db.event_logger.log("option_migration_moved_to_l0")
    # Validate + persist the new options (writes a fresh OPTIONS file).
    DB.open(dbname, to_options, env=env).close()
