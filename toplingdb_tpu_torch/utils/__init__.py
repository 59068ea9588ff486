"""Host utilities: status model, byte coding, checksums, block codecs,
merge operators, compaction filters and span tracing."""
