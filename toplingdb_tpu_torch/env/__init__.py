"""Filesystem access for the DB, its WAL and MANIFEST, and SST reads and
writes."""

from toplingdb_tpu_torch.env.env import PosixEnv, default_env

__all__ = ["PosixEnv", "default_env"]
