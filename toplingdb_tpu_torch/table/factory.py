"""Table format factory (copied from toplingdb_tpu/table/factory.py,
trimmed to the block-based builder; the other formats and the adaptive
reader come with a later slice)."""

from __future__ import annotations

from toplingdb_tpu_torch.table.builder import TableBuilder, TableOptions
from toplingdb_tpu_torch.utils.status import InvalidArgument, NotSupported

FORMATS = ("block", "single_fast", "cuckoo", "plain", "zip")


def new_table_builder(wfile, icmp, options: TableOptions | None = None,
                      **kw):
    options = options or TableOptions()
    f = options.format
    if options.auto_sort and f != "single_fast":
        raise InvalidArgument(
            "auto_sort is a single_fast-format feature (the block builder "
            "requires sorted adds)"
        )
    if f == "block":
        return TableBuilder(wfile, icmp, options, **kw)
    if f in FORMATS:
        raise NotSupported(f"table format {f!r} is not ported yet")
    raise InvalidArgument(f"unknown table format {f!r}")
