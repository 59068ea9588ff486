"""Carrying a job's state across from toplingdb_tpu.

The state of this system is its files, and the port's SST formats are its
own copies of the reference's, so SSTs cross in both directions as they
are. What does not cross by itself is a live options object:
`table_options_from_plain` builds the port's TableOptions from plain
values — the scalar fields of the reference's TableOptions (`format`,
`index_type`, `metadata_block_size`, `partition_filters`,
`protection_bytes_per_key` among them), `filter_policy_name` (the name the
SST properties record for the filter policy, empty for none),
`compression_opts` (a dict of the reference's CompressionOptions fields:
`level`, `max_dict_bytes`, `zstd_max_train_bytes`), `prefix_extractor` (the
extractor's name, as SST properties and dcompact jobs record it; empty or
None for none) and `properties_collector_factories` (the factories'
serialized dicts, as dcompact jobs carry them).

A dcompact job crosses as its job dir: the port's worker
(`compaction/worker.py`) reads a params.json written by the reference's
`CompactionParams.to_json`, and the reference's worker reads the port's.

Merge operators and compaction filters cross by name, through their
registries, as a reference job's options travel to a remote worker:
`utils.merge_operator.create_merge_operator(op.name())` and
`utils.compaction_filter.create_compaction_filter(f.name())` build the
port's counterpart of a reference object `op` or `f`; a custom filter
registers on both sides (`register_compaction_filter`).
"""

from __future__ import annotations

import dataclasses

from toplingdb_tpu_torch.table.builder import CompressionOptions, TableOptions
from toplingdb_tpu_torch.table.filter import filter_policy_from_name
from toplingdb_tpu_torch.utils.slice_transform import slice_transform_from_name
from toplingdb_tpu_torch.utils.status import InvalidArgument
from toplingdb_tpu_torch.utils.table_properties_collector import (
    create_collector_factory,
)


def table_options_from_plain(d: dict) -> TableOptions:
    """TableOptions from a dict of plain values. Keys are TableOptions
    field names (every scalar field of the reference's options;
    `prefix_extractor` as a name, `properties_collector_factories` as
    serialized dicts), `filter_policy_name` and `compression_opts` (a dict
    of CompressionOptions fields); unknown keys or names raise
    InvalidArgument."""
    fields = {f.name for f in dataclasses.fields(TableOptions)}
    copt_fields = {f.name for f in dataclasses.fields(CompressionOptions)}
    kwargs = {}
    for k, v in d.items():
        if k == "filter_policy_name":
            if v and filter_policy_from_name(v) is None:
                raise InvalidArgument(f"unknown filter policy {v!r}")
            kwargs["filter_policy"] = filter_policy_from_name(v) if v else None
        elif k == "compression_opts":
            bad = set(v) - copt_fields
            if bad:
                raise InvalidArgument(
                    f"unknown compression options {sorted(bad)!r}")
            kwargs[k] = CompressionOptions(**v)
        elif k == "prefix_extractor":
            pe = slice_transform_from_name(v) if v else None
            if v and pe is None:
                raise InvalidArgument(f"unknown prefix extractor {v!r}")
            kwargs[k] = pe
        elif k == "properties_collector_factories":
            kwargs[k] = [create_collector_factory(c) for c in v]
        elif k in fields and k != "filter_policy":
            kwargs[k] = v
        else:
            raise InvalidArgument(f"unknown table option {k!r}")
    return TableOptions(**kwargs)
