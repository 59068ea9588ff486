"""Filesystem access for the DB, its WAL and MANIFEST, and SST reads and
writes."""

from toplingdb_tpu_torch.env.env import MemEnv, PosixEnv, default_env

__all__ = ["MemEnv", "PosixEnv", "default_env"]
