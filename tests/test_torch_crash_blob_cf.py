"""tests/test_crash_blob_cf.py on toplingdb_tpu_torch's DB: a kill -9
crash soak over column families, blob files and blob GC. A child process
does synced writes into the port's DB (its compactions on the device
executor's plain kernels, "cpu"), journaling each op after its write
returns, so every journaled op must survive the kill; only the one op in
flight (written, not yet journaled) may diverge, once per kill. The child
is killed at a random point after its first journaled op (the port's
child starts slower than the reference's: it imports torch). After each
kill the DB reopens, every journaled key reads back, and a full scan of
both column families reads every table block and blob record with its
checksum (the reference's test calls verify_checksum, which the port's DB
does not have yet)."""

import os
import random
import shutil
import subprocess
import sys
import time

_CHILD = r"""
import os, random, sys
sys.path.insert(0, %(repo)r)
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory)
from toplingdb_tpu_torch.db.db import DB
from toplingdb_tpu_torch.options import Options, WriteOptions

d, journal, seed = sys.argv[1], sys.argv[2], int(sys.argv[3])
rng = random.Random(seed)
o = Options(write_buffer_size=8 * 1024, enable_blob_files=True,
            min_blob_size=64, enable_blob_garbage_collection=True,
            blob_garbage_collection_age_cutoff=0.5,
            level0_file_num_compaction_trigger=3,
            compaction_executor_factory=DeviceCompactionExecutorFactory(
                device="cpu"))
db = DB.open(d, o)
cf = db.get_column_family("meta") or db.create_column_family("meta")
jf = open(journal, "a", buffering=1)
wo = WriteOptions(sync=True)
i = 0
while True:
    k = b"key%%05d" %% rng.randrange(1500)
    v = (b"B%%05d" %% i) * (20 if rng.random() < 0.3 else 1)
    use_cf = rng.random() < 0.25
    if rng.random() < 0.85:
        db.put(k, v, wo, cf=cf if use_cf else None)
        jf.write("P %%d %%s %%s\n" %% (int(use_cf), k.decode(), v.decode()))
    else:
        db.delete(k, wo, cf=cf if use_cf else None)
        jf.write("D %%d %%s\n" %% (int(use_cf), k.decode()))
    jf.flush(); os.fsync(jf.fileno())
    i += 1
"""


def _lines(path):
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        return sum(1 for _ in f)


def test_crash_recovery_with_cfs_and_blobs(tmp_path):
    from toplingdb_tpu_torch.compaction.executor import (
        DeviceCompactionExecutorFactory,
    )
    from toplingdb_tpu_torch.db.db import DB
    from toplingdb_tpu_torch.options import Options

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    child_py = str(tmp_path / "child.py")
    with open(child_py, "w") as f:
        f.write(_CHILD % {"repo": repo})
    base = str(tmp_path / "db")
    journal = str(tmp_path / "journal")
    rng = random.Random(99)
    for rnd in range(3):
        start = _lines(journal)
        p = subprocess.Popen(
            [sys.executable, child_py, base, journal, str(rnd)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        )
        deadline = time.time() + 120
        while _lines(journal) == start and p.poll() is None \
                and time.time() < deadline:
            time.sleep(0.05)
        time.sleep(rng.uniform(1.0, 2.0))
        if p.poll() is not None:
            # The child died on its own: a bug, not a kill.
            raise AssertionError(
                f"round {rnd}: child died early: "
                f"{p.stderr.read().decode()[-800:]}")
        p.kill()
        p.wait()
        p.stderr.close()
        assert _lines(journal) > start, f"round {rnd}: no op journaled"
        model = [{}, {}]
        with open(journal) as f:
            for line in f:
                parts = line.rstrip("\n").split(" ", 3)
                if parts[0] == "P":
                    model[int(parts[1])][parts[2].encode()] = \
                        parts[3].encode()
                else:
                    model[int(parts[1])].pop(parts[2].encode(), None)
        o = Options(enable_blob_files=True, min_blob_size=64,
                    enable_blob_garbage_collection=True,
                    blob_garbage_collection_age_cutoff=0.5,
                    compaction_executor_factory=(
                        DeviceCompactionExecutorFactory(device="cpu")))
        db = DB.open(base, o)
        try:
            cfh = db.get_column_family("meta")
            bad = 0
            for which, m in enumerate(model):
                h = cfh if which else None
                for k, v in m.items():
                    if db.get(k, cf=h) != v:
                        bad += 1
            # One in-flight divergence can accrue per kill (the op whose
            # write committed but whose journal line did not), and they
            # persist across rounds unless overwritten.
            assert bad <= rnd + 1, f"round {rnd}: {bad} losses (> {rnd + 1})"
            for h in (None, cfh):
                it = db.new_iterator(cf=h)
                it.seek_to_first()
                n = sum(1 for _ in it.entries())
                assert abs(n - len(model[h is not None])) <= rnd + 1
                del it
        finally:
            db.close()
    shutil.rmtree(base, ignore_errors=True)
