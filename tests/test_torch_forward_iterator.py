"""Tailing iterators (ReadOptions.tailing → ForwardIterator) in
toplingdb_tpu_torch's DB against toplingdb_tpu's, on the CPU.

- the seven cases of tests/test_forward_iterator.py (new writes after
  exhaustion, across flushes, no duplicate for an overwrite behind the
  cursor, seek and the forward-only refusals, a seek past the end, an empty
  DB's tail loop, deletes) run on each package with the reference test's
  assertions and equal observations;
- a writer thread appends sequential keys while a reader thread tails them
  through one tailing iterator bounded to their prefix, beside other
  writes, flushes and compactions on the "cpu" device executor: the
  reader sees every key exactly once and in order.

Tolerance: none.
"""

import threading
import time

import pytest

import toplingdb_tpu.db.db as ref_dbm
from toplingdb_tpu.db.forward_iterator import (
    ForwardIterator as RefForwardIterator,
)
from toplingdb_tpu.options import Options as RefOptions
from toplingdb_tpu.options import ReadOptions as RefReadOptions
from toplingdb_tpu.utils import status as ref_status

import toplingdb_tpu_torch.db.db as dbm
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory,
)
from toplingdb_tpu_torch.db.forward_iterator import ForwardIterator
from toplingdb_tpu_torch.options import Options, ReadOptions
from toplingdb_tpu_torch.utils import status


class Side:
    def __init__(self, ref: bool):
        self.ref = ref
        self.DB = ref_dbm.DB if ref else dbm.DB
        self.ReadOptions = RefReadOptions if ref else ReadOptions
        self.NotSupported = (ref_status if ref else status).NotSupported
        self.ForwardIterator = RefForwardIterator if ref else ForwardIterator

    def options(self, **kw):
        if self.ref:
            return RefOptions(**kw)
        return Options(compaction_executor_factory=(
            DeviceCompactionExecutorFactory(device="cpu")), **kw)

    def tailing(self, db, **kw):
        it = db.new_iterator(self.ReadOptions(tailing=True, **kw))
        assert isinstance(it, self.ForwardIterator)
        return it


def pos(it):
    return (it.key(), it.value()) if it.valid() else None


def sc_tailing_sees_new_writes(s, db, obs):
    db.put(b"a", b"1")
    db.put(b"b", b"2")
    it = s.tailing(db)
    it.seek_to_first()
    obs.append(pos(it))
    it.next()
    obs.append(pos(it))
    it.next()
    obs.append(pos(it))  # exhausted
    db.put(b"c", b"3")
    db.put(b"d", b"4")
    for _ in range(4):  # catch-up resumes after b; then the tail loop
        it.next()
        obs.append(pos(it))
    assert obs == [(b"a", b"1"), (b"b", b"2"), None, (b"c", b"3"),
                   (b"d", b"4"), None, None]


def sc_tailing_across_flush(s, db, obs):
    db.put(b"k1", b"v1")
    it = s.tailing(db)
    it.seek_to_first()
    obs.append(pos(it))
    it.next()
    obs.append(pos(it))
    db.flush()
    db.put(b"k2", b"v2")
    db.flush()
    db.put(b"k3", b"v3")
    it.next()
    obs.append(pos(it))
    it.next()
    obs.append(pos(it))
    assert obs == [(b"k1", b"v1"), None, (b"k2", b"v2"), (b"k3", b"v3")]


def sc_tailing_no_duplicate_on_overwrite(s, db, obs):
    db.put(b"a", b"1")
    it = s.tailing(db)
    it.seek_to_first()
    it.next()
    obs.append(pos(it))
    db.put(b"a", b"updated")  # behind the tail position
    db.put(b"z", b"new")
    it.next()
    obs.append(pos(it))
    assert obs == [None, (b"z", b"new")]


def sc_tailing_seek_and_restrictions(s, db, obs):
    for i in range(10):
        db.put(b"k%02d" % i, b"v")
    it = s.tailing(db)
    it.seek(b"k05")
    obs.append(pos(it))
    for fn in (it.prev, it.seek_to_last):
        with pytest.raises(s.NotSupported):
            fn()
    snap = db.get_snapshot()
    with pytest.raises(s.NotSupported):
        db.new_iterator(s.ReadOptions(tailing=True, snapshot=snap))
    db.release_snapshot(snap)
    assert obs == [(b"k05", b"v")]


def sc_tailing_seek_past_end_then_catch_up(s, db, obs):
    db.put(b"a", b"1")
    it = s.tailing(db)
    it.seek(b"m")
    obs.append(pos(it))
    db.put(b"b", b"2")  # before the seek target: never surfaces
    db.put(b"n", b"3")
    it.next()
    obs.append(pos(it))
    it2 = s.tailing(db)
    it2.seek_to_first()
    obs.append(pos(it2))
    assert obs == [None, (b"n", b"3"), (b"a", b"1")]


def sc_tailing_empty_db_tail_loop(s, db, obs):
    it = s.tailing(db)
    it.seek_to_first()
    obs.append(pos(it))
    db.put(b"x", b"1")
    it.next()
    obs.append(pos(it))
    assert obs == [None, (b"x", b"1")]


def sc_tailing_respects_deletes(s, db, obs):
    db.put(b"a", b"1")
    it = s.tailing(db)
    it.seek_to_first()
    it.next()
    obs.append(pos(it))
    db.put(b"b", b"2")
    db.delete(b"b")
    db.put(b"c", b"3")
    it.next()
    obs.append(pos(it))
    assert obs == [None, (b"c", b"3")]


SCENARIOS = [
    sc_tailing_sees_new_writes,
    sc_tailing_across_flush,
    sc_tailing_no_duplicate_on_overwrite,
    sc_tailing_seek_and_restrictions,
    sc_tailing_seek_past_end_then_catch_up,
    sc_tailing_empty_db_tail_loop,
    sc_tailing_respects_deletes,
]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__[3:] for f in SCENARIOS])
def test_forward_iterator_against_reference(tmp_path, scenario):
    seen = {}
    for name in ("ref", "port"):
        s = Side(name == "ref")
        db = s.DB.open(str(tmp_path / name), s.options())
        obs = []
        scenario(s, db, obs)
        db.close()
        seen[name] = obs
    assert seen["port"] == seen["ref"]


def test_tailer_sees_every_appended_key_once_in_order(tmp_path):
    s = Side(False)
    db = s.DB.open(str(tmp_path / "db"), s.options(
        write_buffer_size=64 << 10, level0_file_num_compaction_trigger=2))
    n = 3000
    seen: list[bytes] = []

    def reader():
        it = db.new_iterator(ReadOptions(tailing=True,
                                         iterate_upper_bound=b"log0"))
        it.seek(b"log/")
        deadline = time.monotonic() + 120
        while len(seen) < n and time.monotonic() < deadline:
            if it.valid():
                seen.append(it.key())
            it.next()  # at the end of the view: the catch-up

    def other():
        for i in range(n):
            db.put(b"data%06d" % (i * 7919 % n), b"x" * 40)

    threads = [threading.Thread(target=reader), threading.Thread(target=other)]
    for t in threads:
        t.start()
    for i in range(n):
        db.put(b"log/%08d" % i, b"e%d" % i)
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    db.wait_for_compactions()
    assert seen == [b"log/%08d" % i for i in range(n)]
    assert db.options.compaction_executor_factory.jobs
    db.close()
