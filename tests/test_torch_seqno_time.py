"""The seqno-to-time mapping and preclude_last_level_data_seconds in
toplingdb_tpu_torch's DB against toplingdb_tpu's, on the CPU.

- a DB opened with default Options, one put, flush, close: both packages'
  directories hold SEQNO_TIME.json with one (seqno, time) pair, the same
  pair;
- SeqnoToTimeMapping against toplingdb_tpu's class on seeded random
  append / query sequences, with capacities small enough that the
  halving runs: equal pairs, lengths and answers;
- tests/test_compaction.py:396 (young data keeps its seqnos through
  compact_range; with the option off they are zeroed) and :441 (the
  sidecar survives a reopen; aged by hand, the data gets the last-level
  treatment) as twins on the device executors: the SST bytes, level sets
  and sidecars are equal;
- a young "bottommost marked" rewrite is skipped, its file unmarked and
  re-marked after the backoff, skipped again while young, and rewritten
  (seqnos zeroed) once the mapping proves it old, in both packages, with
  the same SST bytes;
- sampling on every publishing path of the port (the Python group commit,
  the native write plane, the staged pipelined path) under a scripted
  clock gives the mapping and sidecar the reference's default path gives.

Time enters through time.time(), frozen or scripted by the tests.
Tolerance: none.
"""

import json
import os
import random
import time

import pytest

import toplingdb_tpu.db.db as ref_dbm
from toplingdb_tpu.compaction.executor import (
    DeviceCompactionExecutorFactory as RefFactory,
)
from toplingdb_tpu.options import Options as RefOptions
from toplingdb_tpu.utils.seqno_to_time import (
    SeqnoToTimeMapping as RefMapping,
)

import toplingdb_tpu_torch.db.db as dbm
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory,
)
from toplingdb_tpu_torch.db.write_batch import WriteBatch
from toplingdb_tpu_torch.options import Options
from toplingdb_tpu_torch.utils import statistics as st
from toplingdb_tpu_torch.utils.seqno_to_time import SeqnoToTimeMapping

CLOCK = 1_700_000_000.0


class Side:
    def __init__(self, ref: bool):
        self.ref = ref
        self.DB = ref_dbm.DB if ref else dbm.DB

    def options(self, **kw):
        if self.ref:
            return RefOptions(compaction_executor_factory=RefFactory(
                device="cpu-jax"), **kw)
        return Options(compaction_executor_factory=(
            DeviceCompactionExecutorFactory(device="cpu")), **kw)


@pytest.fixture
def clock(monkeypatch):
    """time.time() reads clock[0] in both packages."""
    now = [CLOCK]
    monkeypatch.setattr(time, "time", lambda: now[0])
    return now


def _sidecar(d):
    with open(os.path.join(d, "SEQNO_TIME.json")) as f:
        return json.load(f)


def _files(db):
    """Level sets and the live SST bytes by name."""
    levels = [[(f.number, f.smallest, f.largest, f.smallest_seqno,
                f.largest_seqno) for f in fl]
              for fl in db.versions.current.files]
    out = {}
    for fl in levels:
        for f in fl:
            name = "%06d.sst" % f[0]
            with open(os.path.join(db.dbname, name), "rb") as fh:
                out[name] = fh.read()
    return levels, out


def _smallest_seqnos(db):
    return [db.table_cache.get_reader(f.number).properties.smallest_seqno
            for _, f in db.versions.current.all_files()]


# ---------------------------------------------------------------------------
# The sidecar on the default path
# ---------------------------------------------------------------------------


def test_default_options_write_the_sidecar(tmp_path):
    """Default Options sample the mapping (period 60 s; the first write
    always samples) and persist it at flush and close, in both
    packages."""
    seen = {}
    for name in ("ref", "port"):
        s = Side(name == "ref")
        d = str(tmp_path / name)
        db = s.DB.open(d, s.options())
        db.put(b"k", b"v")
        db.flush()
        db.close()
        assert os.path.exists(os.path.join(d, "SEQNO_TIME.json")), name
        seen[name] = _sidecar(d)
    assert len(seen["port"]) == len(seen["ref"]) == 1
    assert seen["port"][0][0] == seen["ref"][0][0] == 1


# ---------------------------------------------------------------------------
# The mapping
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_mapping_against_reference(seed):
    rng = random.Random(seed)
    cap = rng.choice([2, 3, 4, 7, 12, 100])
    ref, port = RefMapping(max_capacity=cap), SeqnoToTimeMapping(
        max_capacity=cap)
    seq, t = 0, 1_000
    for _ in range(400):
        if rng.random() < 0.8:
            seq += rng.randrange(0, 40)
            t += rng.randrange(0, 9)
            a = (seq, t)
        else:  # out of order in one axis or both: ignored by both
            a = (max(0, seq - rng.randrange(0, 30)),
                 t - rng.randrange(-3, 5))
        ref.append(*a)
        port.append(*a)
        q_seq = rng.randrange(-5, seq + 20)
        q_t = rng.randrange(995, t + 10)
        assert port.get_proximal_time(q_seq) == ref.get_proximal_time(q_seq)
        assert port.get_proximal_seqno(q_t) == ref.get_proximal_seqno(q_t)
        assert port.to_list() == ref.to_list()
        assert len(port) == len(ref) <= max(2, cap) + 1
    again = SeqnoToTimeMapping(max_capacity=cap)
    again.load(ref.to_list())
    assert again.to_list() == ref.to_list()


# ---------------------------------------------------------------------------
# tests/test_compaction.py:396 and :441 as twins
# ---------------------------------------------------------------------------


def sc_preclude_keeps_young_seqnos(s, d, obs):                    # :396
    with s.DB.open(d, s.options(preclude_last_level_data_seconds=3600,
                                seqno_time_sample_period_sec=0)) as db:
        for i in range(2000):
            db.put(b"k%05d" % i, b"v" * 30)
        db.flush()
        db.seqno_to_time.append(db.versions.last_sequence, int(time.time()))
        db.compact_range(None, None)
        db.wait_for_compactions()
        seqnos = _smallest_seqnos(db)
        assert seqnos and min(seqnos) > 0, \
            "fresh data received last-level seqno zeroing"
        assert db.get(b"k00042") == b"v" * 30
        obs += [seqnos, _files(db)]
    # Control: with the option off the same flow zeroes seqnos.
    with s.DB.open(d + "2", s.options()) as db:
        for i in range(2000):
            db.put(b"k%05d" % i, b"v" * 30)
        db.flush()
        db.compact_range(None, None)
        db.wait_for_compactions()
        seqnos = _smallest_seqnos(db)
        assert seqnos == [0] * len(seqnos)
        obs += [seqnos, _files(db)]


def sc_sidecar_survives_reopen(s, d, obs):                         # :441
    with s.DB.open(d, s.options(preclude_last_level_data_seconds=2)) as db:
        for i in range(500):
            db.put(b"k%04d" % i, b"v" * 20)
        db.flush()
    pairs = _sidecar(d)
    assert pairs and pairs[-1][1] > 0
    obs.append(pairs)
    # Age the samples past the cutoff, reopen, compact: the data is
    # provably old now and gets the last-level treatment.
    with open(os.path.join(d, "SEQNO_TIME.json"), "w") as f:
        f.write(json.dumps([[q, t - 10] for q, t in pairs]))
    with s.DB.open(d, s.options(preclude_last_level_data_seconds=2)) as db:
        assert len(db.seqno_to_time) > 0
        db.compact_range(None, None)
        db.wait_for_compactions()
        seqnos = _smallest_seqnos(db)
        assert seqnos == [0] * len(seqnos) and seqnos
        obs += [seqnos, _files(db)]
    obs.append(_sidecar(d))


SCENARIOS = [sc_preclude_keeps_young_seqnos, sc_sidecar_survives_reopen]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__[3:] for f in SCENARIOS])
def test_preclude_twin_against_reference(tmp_path, clock, scenario):
    seen = {}
    for name in ("ref", "port"):
        obs = []
        scenario(Side(name == "ref"), str(tmp_path / name), obs)
        seen[name] = obs
    assert seen["port"] == seen["ref"]


# ---------------------------------------------------------------------------
# A young marked rewrite: skipped, re-marked, rewritten once old
# ---------------------------------------------------------------------------


def _marked_rewrite(s, d):
    obs = []
    with s.DB.open(d, s.options(preclude_last_level_data_seconds=3600,
                                seqno_time_sample_period_sec=0)) as db:
        want = {}
        for i in range(1000):
            db.put(b"k%04d" % i, b"v" * 24)
            want[b"k%04d" % i] = b"v" * 24
            if i % 3 == 0:
                db.delete(b"k%04d" % (i // 2))
                want[b"k%04d" % (i // 2)] = None
        db.flush()
        db.compact_range()
        db.wait_for_compactions()
        sched = db._compaction_scheduler
        last = db.versions.current.files[-1]
        assert len(last) == 1 and _smallest_seqnos(db)[0] > 0
        f = last[0]
        for _round in range(2):
            f.marked_for_compaction = True
            done = sched.num_completed
            db._maybe_schedule_compaction()
            db.wait_for_compactions()
            # Skipped: unmarked, queued for a re-mark, the file kept.
            obs.append((sched.num_completed - done, f.marked_for_compaction,
                        len(sched._preclude_remark),
                        db.versions.current.files[-1][0].number == f.number))
            assert obs[-1] == (1, False, 1, True)
            sched._preclude_remark = [(0.0, g) for _r, g
                                      in sched._preclude_remark]
        # The mapping proves the data old: the re-marked rewrite runs.
        db.seqno_to_time.load([[db.versions.last_sequence,
                                int(time.time()) - 7200]])
        db._maybe_schedule_compaction()
        db.wait_for_compactions()
        after = db.versions.current.files[-1]
        obs.append((len(sched._preclude_remark), [g.number for g in after],
                    _smallest_seqnos(db)))
        assert after[0].number != f.number
        assert _smallest_seqnos(db) == [0]
        obs.append(_files(db))
        for k, v in want.items():
            assert db.get(k) == v, k
    return obs


def test_young_marked_rewrite_is_skipped_and_remarked(tmp_path, clock):
    ref = _marked_rewrite(Side(True), str(tmp_path / "ref"))
    port = _marked_rewrite(Side(False), str(tmp_path / "port"))
    assert port == ref


# ---------------------------------------------------------------------------
# Sampling on every publishing path
# ---------------------------------------------------------------------------


MODES = {
    "python": (dict(write_plane=False), {}),
    "native": ({}, {}),
    "staged": ({}, dict(enable_pipelined_write=True)),
}


def _sampled(s, d, clock, open_kw, opt_kw):
    stats = st.Statistics() if not s.ref else None
    db = s.DB.open(d, s.options(seqno_time_sample_period_sec=5,
                                statistics=stats, **opt_kw), **open_kw)
    for r in range(30):
        if s.ref:
            from toplingdb_tpu.db.write_batch import WriteBatch as RefBatch

            b = RefBatch()
        else:
            b = WriteBatch()
        for j in range(3):
            b.put(b"k%03d-%d" % (r, j), b"v%d" % r)
        db.write(b)
        clock[0] += 2
    got = db.seqno_to_time.to_list()
    db.flush()
    db.close()
    native = (stats.get_ticker_count(st.WRITE_GROUP_NATIVE_COMMITS)
              if stats is not None else None)
    return got, _sidecar(d), native


@pytest.mark.parametrize("mode", sorted(MODES))
def test_sampling_on_every_write_path(tmp_path, clock, mode):
    open_kw, opt_kw = MODES[mode]
    start = clock[0]
    ref = _sampled(Side(True), str(tmp_path / "ref"), clock, {}, {})
    clock[0] = start
    port = _sampled(Side(False), str(tmp_path / "port"), clock, open_kw,
                    opt_kw)
    assert port[:2] == ref[:2]
    assert len(port[0]) == 10  # a sample every third write of 2 s steps
    if mode == "native":
        assert port[2] == 30  # every group went through the native plane
    elif mode == "python":
        assert port[2] == 0
