"""Table format factory and adaptive reader dispatch (copied from
toplingdb_tpu/table/factory.py).

Builders are chosen by `TableOptions.format`; readers are dispatched by
the footer magic, so a job may read a mix of formats.
"""

from __future__ import annotations

from toplingdb_tpu_torch.table import format as fmt
from toplingdb_tpu_torch.table.builder import TableBuilder, TableOptions
from toplingdb_tpu_torch.table.cuckoo import (
    CuckooTableBuilder,
    CuckooTableReader,
)
from toplingdb_tpu_torch.table.plain import PlainTableBuilder, PlainTableReader
from toplingdb_tpu_torch.table.reader import TableReader
from toplingdb_tpu_torch.table.single_fast import (
    SingleFastTableBuilder,
    SingleFastTableReader,
)
from toplingdb_tpu_torch.table.zip_table import ZipTableBuilder, ZipTableReader
from toplingdb_tpu_torch.utils.status import Corruption, InvalidArgument

FORMATS = ("block", "single_fast", "cuckoo", "plain", "zip")

_BUILDERS = {
    "block": TableBuilder,
    "single_fast": SingleFastTableBuilder,
    "cuckoo": CuckooTableBuilder,
    "plain": PlainTableBuilder,
    "zip": ZipTableBuilder,
}

_READERS = {
    fmt.MAGIC: TableReader,
    fmt.SINGLE_FAST_MAGIC: SingleFastTableReader,
    fmt.CUCKOO_MAGIC: CuckooTableReader,
    fmt.PLAIN_MAGIC: PlainTableReader,
    fmt.ZIP_MAGIC: ZipTableReader,
}


def new_table_builder(wfile, icmp, options: TableOptions | None = None,
                      **kw):
    options = options or TableOptions()
    f = options.format
    if options.auto_sort and f != "single_fast":
        raise InvalidArgument(
            "auto_sort is a single_fast-format feature (the block builder "
            "requires sorted adds)"
        )
    if f not in _BUILDERS:
        raise InvalidArgument(f"unknown table format {f!r}")
    return _BUILDERS[f](wfile, icmp, options, **kw)


def open_table(rfile, icmp, options: TableOptions | None = None,
               block_cache=None, cache_key_prefix: bytes = b""):
    """Adaptive open: dispatch on the footer magic."""
    size = rfile.size()
    tail = rfile.read(max(0, size - fmt.FOOTER_LEN), fmt.FOOTER_LEN)
    magic = fmt.Footer.read_magic(tail)
    if magic not in _READERS:
        raise Corruption(f"unknown SST magic {magic:#x}")
    if magic == fmt.MAGIC:
        # Block tables read block by block, through the shared cache; the
        # other formats hold their whole file (or its sections) resident.
        return TableReader(rfile, icmp, options, block_cache=block_cache,
                           cache_key_prefix=cache_key_prefix)
    return _READERS[magic](rfile, icmp, options)
