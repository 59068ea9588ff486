"""Host utilities: status model, byte coding, checksums, block codecs,
merge operators, compaction filters, prefix extractors, property
collectors, per-entry protection and span tracing."""
