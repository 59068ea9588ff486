"""Table format factory (copied from toplingdb_tpu/table/factory.py,
trimmed to the block-based format: its builder, and `open_table`, the
adaptive open that dispatches on the footer magic; the other formats come
with a later slice and raise NotSupported on both sides)."""

from __future__ import annotations

from toplingdb_tpu_torch.table import format as fmt
from toplingdb_tpu_torch.table.builder import TableBuilder, TableOptions
from toplingdb_tpu_torch.table.reader import TableReader
from toplingdb_tpu_torch.utils.status import (
    Corruption,
    InvalidArgument,
    NotSupported,
)

# Footer magics of the reference's other table formats.
_OTHER_MAGICS = {
    0x7470756C736D4654: "single_fast",
    0x7470756C736D4354: "cuckoo",
    0x7470756C736D5054: "plain",
    0x7470756C736D5A54: "zip",
}

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


def open_table(rfile, icmp, options: TableOptions | None = None):
    """Adaptive open: dispatch on the footer magic."""
    size = rfile.size()
    tail = rfile.read(max(0, size - fmt.FOOTER_LEN), fmt.FOOTER_LEN)
    magic = fmt.Footer.read_magic(tail)
    if magic == fmt.MAGIC:
        return TableReader(rfile, icmp, options)
    if magic in _OTHER_MAGICS:
        raise NotSupported(
            f"table format {_OTHER_MAGICS[magic]!r} is not ported yet")
    raise Corruption(f"unknown SST magic {magic:#x}")
