"""SST formats: framing, blocks, properties, filters, the block-based
builder and reader, the single_fast, plain, cuckoo and zip formats, and
the factory that picks a builder by format and a reader by footer
magic."""
