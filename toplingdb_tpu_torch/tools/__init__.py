"""Command-line tools of the port (copied from toplingdb_tpu/tools/ as
their slices land)."""
