"""Wide-column entities in toplingdb_tpu_torch's DB against toplingdb_tpu's,
on the CPU.

- the eight cases of tests/test_wide_columns_typed.py (typed detection, no
  reinterpretation of plain values that start with the magic; get / multi_get
  / iterator unwrap of the default column; flush, compaction and recovery
  keep the type; iterator columns(); a merge over an entity folds its
  default column on the get, iterator and compaction paths; a single
  delete annihilates an entity; an entity in a non-default CF through the
  parsed WriteBatch path; the legacy_wide_column_unwrap gate) run on each
  package, the port's compactions on DeviceCompactionExecutorFactory(
  device="cpu"), the reference's on its device factory ("cpu-jax"), with
  the reference test's assertions and equal observations;
- an entity fill with a string-append merge overlay, overwrites, deletes
  and single deletes, compacted on both device executors: the SST bytes,
  level sets, get / get_entity / multi_get answers and scans (values and
  columns) are equal, and the compaction's outputs hold entity rows.

Tolerance: none.
"""

import os
import random

import pytest

import toplingdb_tpu.db.db as ref_dbm
from toplingdb_tpu.compaction.executor import (
    DeviceCompactionExecutorFactory as RefFactory,
)
from toplingdb_tpu.db import wide_columns as ref_wc
from toplingdb_tpu.db.write_batch import WriteBatch as RefWriteBatch
from toplingdb_tpu.options import Options as RefOptions
from toplingdb_tpu.utils import merge_operator as ref_mo

import toplingdb_tpu_torch.db.db as dbm
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory,
)
from toplingdb_tpu_torch.db import wide_columns as wc
from toplingdb_tpu_torch.db.write_batch import WriteBatch
from toplingdb_tpu_torch.options import Options
from toplingdb_tpu_torch.utils import merge_operator as mo

from test_torch_db import pinned_clock  # noqa: F401


class Side:
    def __init__(self, ref: bool):
        self.ref = ref
        self.DB = ref_dbm.DB if ref else dbm.DB
        self.wc = ref_wc if ref else wc
        self.WriteBatch = RefWriteBatch if ref else WriteBatch
        self.mo = ref_mo if ref else mo

    def options(self, **kw):
        if self.ref:
            return RefOptions(compaction_executor_factory=RefFactory(
                device="cpu-jax"), **kw)
        return Options(compaction_executor_factory=(
            DeviceCompactionExecutorFactory(device="cpu")), **kw)


def _scan(db, cf=None):
    it = db.new_iterator(cf=cf) if cf is not None else db.new_iterator()
    it.seek_to_first()
    out = []
    while it.valid():
        out.append((it.key(), it.value(), it.columns()))
        it.next()
    return out


# ---------------------------------------------------------------------------
# The cases of tests/test_wide_columns_typed.py
# ---------------------------------------------------------------------------


def sc_plain_value_with_magic_prefix_is_not_reinterpreted(s, d, obs):
    db = s.DB.open(d, s.options(create_if_missing=True))
    # _MAGIC + varint32(0) parses as an empty entity under the sniff.
    tricky = s.wc._MAGIC + b"\x00"
    db.put(b"k", tricky)
    obs += [db.get(b"k"), db.multi_get([b"k"])]
    it = db.new_iterator()
    it.seek_to_first()
    obs.append(it.value())
    db.flush()
    db.wait_for_compactions()
    obs.append(db.get(b"k"))
    db.close()
    assert obs == [tricky, [tricky], tricky, tricky]


def sc_entity_get_unwraps_default_column(s, d, obs):
    db = s.DB.open(d, s.options(create_if_missing=True))
    db.put_entity(b"e", {b"": b"dflt", b"name": b"alice"})
    obs += [db.get(b"e"), db.get_entity(b"e"), db.multi_get([b"e"])]
    db.close()
    assert obs == [b"dflt", {b"": b"dflt", b"name": b"alice"}, [b"dflt"]]


def sc_entity_survives_flush_and_compaction(s, d, obs):
    db = s.DB.open(d, s.options(create_if_missing=True))
    for i in range(500):
        db.put_entity(b"e%04d" % i, {b"": b"d%d" % i, b"c": b"x" * 50})
    db.flush()
    db.compact_range(None, None)
    db.wait_for_compactions()
    obs += [db.get(b"e0007"), db.get_entity(b"e0499")]
    db.close()
    db = s.DB.open(d, s.options())  # recovery keeps the type
    obs.append(db.get(b"e0007"))
    db.close()
    assert obs == [b"d7", {b"": b"d499", b"c": b"x" * 50}, b"d7"]


def sc_iterator_columns_and_value(s, d, obs):
    db = s.DB.open(d, s.options(create_if_missing=True))
    db.put(b"a", b"plain")
    db.put_entity(b"b", {b"": b"bd", b"col": b"cv"})
    it = db.new_iterator()
    it.seek_to_first()
    obs.append((it.key(), it.value(), it.columns()))
    it.next()
    obs.append((it.key(), it.value(), it.columns()))
    it.prev()
    obs.append(it.value())
    db.close()
    assert obs == [(b"a", b"plain", {b"": b"plain"}),
                   (b"b", b"bd", {b"": b"bd", b"col": b"cv"}), b"plain"]


def sc_merge_over_entity_folds_default_column(s, d, obs):
    db = s.DB.open(d, s.options(create_if_missing=True,
                                merge_operator=s.mo.StringAppendOperator(
                                    b",")))
    db.put_entity(b"m", {b"": b"base", b"keep": b"k"})
    db.merge(b"m", b"x")
    db.merge(b"m", b"y")
    obs += [db.get(b"m"), db.get_entity(b"m")]  # the get path
    it = db.new_iterator()
    it.seek(b"m")
    obs += [it.value(), it.columns()]  # the iterator path
    # The compaction path: fold down to one entity entry.
    db.flush()
    db.compact_range(None, None)
    db.wait_for_compactions()
    obs += [db.get(b"m"), db.get_entity(b"m")]
    db.close()
    want = [b"base,x,y", {b"": b"base,x,y", b"keep": b"k"}]
    assert obs == want * 3


def sc_single_delete_annihilates_entity(s, d, obs):
    db = s.DB.open(d, s.options(create_if_missing=True))
    db.put_entity(b"s", {b"": b"v"})
    db.single_delete(b"s")
    db.flush()
    db.compact_range(None, None)
    db.wait_for_compactions()
    obs.append(db.get(b"s"))
    db.close()
    assert obs == [None]


def sc_entity_in_non_default_cf_and_parsed_path(s, d, obs):
    """Entity records survive the PARSED WriteBatch path (CF-prefixed
    records decode through entries_cf)."""
    db = s.DB.open(d, s.options(create_if_missing=True))
    cf = db.create_column_family("wide")
    b = s.WriteBatch()
    b.put_entity(b"ek", s.wc.encode_entity({b"": b"cfd", b"c": b"v"}),
                 cf=db._cf_id(cf))
    assert list(b.entries_cf())  # decodes, no Corruption
    db.write(b)
    obs += [db.get(b"ek", cf=cf), db.get_entity(b"ek", cf=cf),
            _scan(db, cf)]
    db.close()
    assert obs[:2] == [b"cfd", {b"": b"cfd", b"c": b"v"}]


def sc_legacy_unwrap_gate(s, d, obs):
    """Databases written before the dedicated type stored entities as a
    VALUE with the magic; the gate restores the old presentation."""
    db = s.DB.open(d, s.options(create_if_missing=True))
    db.put(b"old", s.wc.encode_entity({b"": b"legacy-default"}))
    db.close()
    db = s.DB.open(d, s.options(legacy_wide_column_unwrap=True))
    obs += [db.get(b"old"), db.multi_get([b"old"]), _scan(db)]
    db.close()
    db = s.DB.open(d, s.options())  # the gate off: raw bytes come back
    obs += [db.get(b"old"), _scan(db)]
    db.close()
    raw = s.wc.encode_entity({b"": b"legacy-default"})
    assert obs[0] == b"legacy-default" and obs[1] == [b"legacy-default"]
    assert obs[3] == raw


SCENARIOS = [
    sc_plain_value_with_magic_prefix_is_not_reinterpreted,
    sc_entity_get_unwraps_default_column,
    sc_entity_survives_flush_and_compaction,
    sc_iterator_columns_and_value,
    sc_merge_over_entity_folds_default_column,
    sc_single_delete_annihilates_entity,
    sc_entity_in_non_default_cf_and_parsed_path,
    sc_legacy_unwrap_gate,
]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__[3:] for f in SCENARIOS])
def test_wide_columns_against_reference(tmp_path, scenario):
    seen = {}
    for name in ("ref", "port"):
        obs = []
        scenario(Side(name == "ref"), str(tmp_path / name), obs)
        seen[name] = obs
    assert seen["port"] == seen["ref"]


# ---------------------------------------------------------------------------
# An entity fill compacted on the device executors: the same bytes
# ---------------------------------------------------------------------------


def _entity_db(s, d, n):
    """n entities of three 20-byte columns (the default one included),
    overwritten in part, a merge overlay on a tenth, deletes and single
    deletes, three flushes, then compact_range; returns the answers, the
    level sets and the SST bytes."""
    rng = random.Random(7)
    db = s.DB.open(d, s.options(
        write_buffer_size=1 << 20, disable_auto_compactions=True,
        merge_operator=s.mo.StringAppendOperator(b",")))
    keys = [b"%016d" % (i * 2654435761 % (2 * n)) for i in range(n)]
    for i, k in enumerate(keys):
        db.put_entity(k, {b"": b"d%019d" % i, b"c1": b"a%019d" % i,
                          b"c2": b"b%019d" % i})
    db.flush()
    for i in rng.sample(range(n), n // 10):
        db.merge(keys[i], b"m%d" % i)
    for i in rng.sample(range(n), n // 20):
        db.put(keys[i], b"plain%d" % i)
    db.flush()
    for i in rng.sample(range(n), n // 20):
        db.delete(keys[i])
    for i in rng.sample(range(n), n // 50):
        db.single_delete(keys[i])
    db.put_entity(keys[0], {b"": b"last", b"z": b"z"})
    db.flush()
    before = [db.get_entity(k) for k in keys]
    db.compact_range()
    after = [db.get_entity(k) for k in keys]
    assert after == before
    answers = (after, [db.get(k) for k in keys], db.multi_get(keys),
               _scan(db))
    levels = [[(f.number, f.smallest, f.largest, f.smallest_seqno,
                f.largest_seqno, f.num_entries) for f in fl]
              for fl in db.versions.current.files]
    files = {}
    types: dict[int, int] = {}
    for fl in levels:
        for f in fl:
            with open(os.path.join(d, "%06d.sst" % f[0]), "rb") as fh:
                files[f[0]] = fh.read()
            it = db.table_cache.get_reader(f[0]).new_iterator()
            it.seek_to_first()
            while it.valid():
                t = it.key()[-8]  # the trailer's low byte: the value type
                types[t] = types.get(t, 0) + 1
                it.next()
    db.close()
    return answers, levels, files, types


def test_entity_fill_compacts_to_the_same_bytes(tmp_path, pinned_clock):  # noqa: F811
    ref = _entity_db(Side(True), str(tmp_path / "ref"), 3000)
    port = _entity_db(Side(False), str(tmp_path / "port"), 3000)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert sorted(port[2]) == sorted(ref[2]) and port[2]
    for num in port[2]:
        assert port[2][num] == ref[2][num], num
    # The outputs hold entity rows (kTypeWideColumnEntity, 0x16) beside
    # plain values, as the reference's do.
    assert port[3] == ref[3]
    assert port[3].get(0x16, 0) > 2000 and port[3].get(0x1, 0) > 0
    columns = [c for _k, _v, c in port[0][3]]
    assert sum(len(c) == 3 for c in columns) > 2000
