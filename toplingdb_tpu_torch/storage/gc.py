"""Mark-sweep GC for the shared SST object store (copied from
toplingdb_tpu/storage/gc.py).

An object is garbage only when NO live root can reach it:

  mark   every root directory (DB dirs, checkpoint dirs) contributes the
         addresses of its MANIFEST-recorded live SSTs (checksum + size
         straight from the VersionEdit stream — no DB open) plus every
         entry of its STORE_REFS.json table (references that may not be
         in a MANIFEST yet: a mid-restore bootstrap, an adopted dcompact
         output awaiting install);
  pins   the store's own pin table shields published-but-not-yet-installed
         objects (the publisher pins with a TTL before the manifest edit
         lands);
  grace  objects younger than `grace_sec` are kept regardless — a publish
         that happened after the mark phase scanned its root cannot be
         reaped by the same sweep;
  lease  when a lease service is given (an object with toplingdb_tpu's
         LeaseCoordinator interface: acquire(shard, holder, ttl) -> a
         grant with a token, raising Busy while another holder has it;
         release(shard, holder, token)), the sweep runs under the
         "store-gc" lease so two GC processes can't interleave their mark
         and sweep phases.

Sweeping is the ONLY deletion path for store objects; everything else
(publish, adopt, fetch) is monotone."""

from __future__ import annotations

import json

from toplingdb_tpu_torch.storage.object_store import object_address
from toplingdb_tpu_torch.storage.shared_env import REFS_NAME
from toplingdb_tpu_torch.utils import statistics as stats_mod
from toplingdb_tpu_torch.utils.status import Busy, NotFound

GC_LEASE_SHARD = "store-gc"


def manifest_live_addresses(dbdir: str, env) -> set[str]:
    """Addresses of every live, checksum-stamped SST recorded by the
    directory's CURRENT+MANIFEST (offline — mirrors
    file_checksum.manifest_file_checksums but keeps the file sizes the
    address needs)."""
    from toplingdb_tpu_torch.db import filename
    from toplingdb_tpu_torch.db.log import LogReader
    from toplingdb_tpu_torch.db.version_edit import VersionEdit

    cur = env.read_file(filename.current_file_name(dbdir)).decode().strip()
    live: dict[int, str] = {}
    for rec in LogReader(
            env.new_sequential_file(f"{dbdir}/{cur}")).records():
        e = VersionEdit.decode(rec)
        for _lvl, num in e.deleted_files:
            live.pop(num, None)
        for _lvl, meta in e.new_files:
            if meta.file_checksum:
                live[meta.number] = object_address(
                    meta.file_checksum_func_name, meta.file_checksum,
                    meta.file_size)
    return set(live.values())


def refs_table_addresses(root: str, env) -> set[str]:
    """Addresses referenced by a directory's STORE_REFS.json (read through
    the BASE env — SharedSstEnv hides the table from get_children but not
    from read_file)."""
    base = getattr(env, "base", env)
    try:
        raw = base.read_file(f"{root}/{REFS_NAME}")
        return {str(v) for v in json.loads(raw.decode()).values()}
    except (OSError, NotFound, ValueError):
        return set()


def collect_live_addresses(roots, env=None) -> set[str]:
    """The mark phase: union of manifest-live and refs-table addresses
    over every root directory. Roots without a CURRENT (mid-bootstrap
    dirs) still contribute their refs table."""
    if env is None:
        from toplingdb_tpu_torch.env import default_env

        env = default_env()
    live: set[str] = set()
    for root in roots:
        try:
            live |= manifest_live_addresses(root, env)
        except (OSError, NotFound):
            pass  # no CURRENT yet: refs below still count
        live |= refs_table_addresses(root, env)
    return live


def mark_sweep(store, roots, env=None, grace_sec: float = 0.0,
               lease=None, holder: str = "store-gc",
               lease_ttl: float = 60.0, statistics=None) -> dict:
    """One GC round. Returns a report dict; raises Busy when another
    process holds the store-gc lease (callers retry on their cadence).

    `store` is a LocalObjectStore or StoreClient; `roots` the directories
    whose manifests/refs define liveness; `lease` an optional lease
    service (see the module docstring) serializing concurrent sweeps."""
    import time

    token = None
    if lease is not None:
        grant = lease.acquire(GC_LEASE_SHARD, holder, lease_ttl)
        token = grant.get("token") if isinstance(grant, dict) else None
    try:
        live = collect_live_addresses(roots, env)
        pinned = set(store.pinned())
        now = time.time()
        swept, kept_young = [], 0
        for addr in store.list_addresses():
            if addr in live or addr in pinned:
                continue
            if grace_sec > 0:
                mtime = store.object_mtime(addr)
                # No mtime = the backend can't prove age: keep (the next
                # sweep with the object in no manifest will see it again).
                if mtime is None or now - mtime < grace_sec:
                    kept_young += 1
                    continue
            if store.delete(addr):
                swept.append(addr)
        if statistics is not None and swept:
            statistics.record_tick(stats_mod.STORE_GC_SWEPT, len(swept))
        return {"live": len(live), "pinned": len(pinned),
                "swept": swept, "kept_young": kept_young}
    finally:
        if lease is not None and token is not None:
            try:
                lease.release(GC_LEASE_SHARD, holder, token)
            except Busy:
                pass  # the lease lapsed mid-sweep: nothing to release
