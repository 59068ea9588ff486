"""Disaggregated SST storage (copied from toplingdb_tpu/storage/; the
shared storage of ToplingDB's dcompact, compaction_job.cc's remote path).

A content-addressed object store for SSTs keyed by the integrity plane's
whole-file checksums, an Env wrapper (`SharedSstEnv`) that lets DB
directories hold SSTs by reference, reference-mode checkpoints and
bootstrap (utilities/checkpoint.py), zero-SST-byte dcompact jobs
(compaction/executor.py + worker.py), and a leased mark-sweep GC.

Opt-in through `Options.shared_store` only (the port reads no environment
variable for it): a filesystem path selects the LocalObjectStore backend,
an http:// URL the StoreServer/StoreClient pair, a store object is used
as it is, and None / "0" / "" leaves the classic local-files path (the
byte-parity oracle) in charge.
"""

from toplingdb_tpu_torch.storage.gc import (  # noqa: F401
    collect_live_addresses,
    mark_sweep,
)
from toplingdb_tpu_torch.storage.object_store import (  # noqa: F401
    LocalObjectStore,
    address_of_meta,
    address_size,
    compute_address,
    object_address,
    parse_address,
    verify_payload,
)
from toplingdb_tpu_torch.storage.shared_env import (  # noqa: F401
    REFS_NAME,
    SharedSstEnv,
    StoreCacheTier,
)
from toplingdb_tpu_torch.storage.store_server import (  # noqa: F401
    StoreClient,
    StoreServer,
)
from toplingdb_tpu_torch.utils.status import NotSupported


def store_spec_enabled(spec) -> bool:
    """Is a shared_store knob value actually ON? ("0"/""/None are off)."""
    return bool(spec) and spec != "0"


def check_store_spec(spec) -> None:
    """Refuse a string spec that names no backend: a URL whose scheme is
    not http(s) (toplingdb_tpu would make a directory of that name)."""
    if (isinstance(spec, str) and "://" in spec
            and not spec.startswith(("http://", "https://"))):
        raise NotSupported(
            f"store_spec {spec!r}: a shared store is a directory path, an "
            f"http(s):// URL of a StoreServer or a store object")


def open_store(spec, env=None):
    """Build a store backend from a knob value: an existing store object
    passes through, an http(s):// URL builds a StoreClient, a directory
    path a LocalObjectStore."""
    if not store_spec_enabled(spec):
        raise ValueError(f"shared store disabled by spec {spec!r}")
    if not isinstance(spec, str):
        return spec  # already a store-shaped object
    check_store_spec(spec)
    if spec.startswith(("http://", "https://")):
        return StoreClient(spec)
    return LocalObjectStore(spec, env=env)
