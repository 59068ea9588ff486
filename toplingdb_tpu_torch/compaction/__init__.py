"""Compaction: the job descriptor, per-job stats, the iterator, and the
dcompact worker with its job boundary and leases."""
