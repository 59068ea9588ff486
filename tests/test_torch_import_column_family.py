"""Export / import of a column family in the port's DB
(db/import_column_family_job.py) against toplingdb_tpu's, on the CPU.

- the 7 tests of tests/test_import_column_family.py, each run through
  both packages (the port's compactions on
  DeviceCompactionExecutorFactory(device="cpu"), the kernels' plain
  versions): the same outcome in each, and the imported CF's views and
  the export metadata's level layout equal the reference's;
- an export made by the reference imported by the port (then compacted on
  the port's device executor), and an export made by the port imported by
  the reference.

Tolerance: none.
"""

import os
import types

import pytest

import toplingdb_tpu.db.db as ref_dbm
import toplingdb_tpu.db.import_column_family_job as ref_job
import toplingdb_tpu.env as ref_env
from toplingdb_tpu.db.dbformat import REVERSE_BYTEWISE as REF_REVERSE
from toplingdb_tpu.options import Options as RefOptions
from toplingdb_tpu.options import ReadOptions as RefReadOptions
from toplingdb_tpu.utils.status import InvalidArgument as RefInvalidArgument

import toplingdb_tpu_torch.db.db as dbm
import toplingdb_tpu_torch.db.import_column_family_job as job
from toplingdb_tpu_torch.compaction.executor import (
    DeviceCompactionExecutorFactory,
)
from toplingdb_tpu_torch.db.dbformat import REVERSE_BYTEWISE
from toplingdb_tpu_torch.env import default_env
from toplingdb_tpu_torch.options import Options, ReadOptions
from toplingdb_tpu_torch.utils.status import InvalidArgument

REF = types.SimpleNamespace(
    name="ref", DB=ref_dbm.DB, Options=RefOptions, ReadOptions=RefReadOptions,
    job=ref_job, InvalidArgument=RefInvalidArgument, reverse=REF_REVERSE,
    env=ref_env.default_env, extra=lambda: {})
PORT = types.SimpleNamespace(
    name="port", DB=dbm.DB, Options=Options, ReadOptions=ReadOptions,
    job=job, InvalidArgument=InvalidArgument, reverse=REVERSE_BYTEWISE,
    env=default_env,
    extra=lambda: {"compaction_executor_factory":
                   DeviceCompactionExecutorFactory(device="cpu")})
BOTH = pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])


def _open(pkg, path, **kw):
    kw.update(pkg.extra())
    return pkg.DB.open(str(path), pkg.Options(**kw))


def _filled_db(pkg, path, n=500, compact=True):
    db = _open(pkg, path, write_buffer_size=32 * 1024)
    for i in range(n):
        db.put(b"key%05d" % i, b"val%05d" % i)
    db.flush()
    for i in range(0, n, 3):
        db.put(b"key%05d" % i, b"upd%05d" % i)
    db.flush()
    if compact:
        db.compact_range()
    return db


def _scan(pkg, db, cf):
    it = db.new_iterator(pkg.ReadOptions(), cf=cf)
    it.seek_to_first()
    return list(it.entries())


def _want(n):
    return [(b"key%05d" % i, (b"upd%05d" if i % 3 == 0 else b"val%05d") % i)
            for i in range(n)]


def test_export_import_roundtrip(tmp_path):                  # :28
    views = {}
    for pkg in (REF, PORT):
        root = tmp_path / pkg.name
        src = _filled_db(pkg, root / "src")
        meta = pkg.job.export_column_family(src, None, str(root / "exp"))
        assert meta.files and meta.db_comparator_name
        src.close()
        dst = _open(pkg, root / "dst")
        dst.put(b"own", b"data")
        h = dst.create_column_family_with_import("imported",
                                                 str(root / "exp"))
        assert dst.get(b"key00003", cf=h) == b"upd00003"
        assert dst.get(b"key00001", cf=h) == b"val00001"
        assert dst.get(b"own", cf=h) is None
        assert dst.get(b"own") == b"data"
        view = _scan(pkg, dst, h)
        assert len(view) == 500
        dst.close()
        dst = _open(pkg, root / "dst")
        h2 = dst.get_column_family("imported")
        assert h2 is not None
        assert dst.get(b"key00042", cf=h2) == b"upd00042"
        views[pkg.name] = (view, _scan(pkg, dst, h2), meta.db_comparator_name)
        dst.close()
    assert views["port"] == views["ref"]
    assert views["port"][0] == _want(500)


@BOTH
def test_import_with_explicit_metadata_and_move(tmp_path, pkg):  # :58
    src = _filled_db(pkg, tmp_path / "src", n=50)
    meta = pkg.job.export_column_family(src, None, str(tmp_path / "exp"))
    src.close()
    dst = _open(pkg, tmp_path / "dst")
    h = dst.create_column_family_with_import(
        "cf2", str(tmp_path / "exp"), metadata=meta, move_files=True)
    assert dst.get(b"key00049", cf=h) == b"val00049"
    left = [p for p in (tmp_path / "exp").iterdir() if p.suffix == ".sst"]
    assert not left
    assert _scan(pkg, dst, h) == _want(50)
    dst.close()


def test_import_multi_level_layout(tmp_path):                # :72
    layouts = {}
    for pkg in (REF, PORT):
        root = tmp_path / pkg.name
        src = _filled_db(pkg, root / "src", n=300, compact=False)
        src.wait_for_compactions()
        meta = pkg.job.export_column_family(src, None, str(root / "exp"))
        levels = {f.level for f in meta.files}
        src.close()
        dst = _open(pkg, root / "dst")
        h = dst.create_column_family_with_import("cf", str(root / "exp"))
        for i in range(300):
            want = b"upd%05d" % i if i % 3 == 0 else b"val%05d" % i
            assert dst.get(b"key%05d" % i, cf=h) == want
        st = dst.versions.column_families[h.id]
        assert {lvl for lvl, _ in st.current.all_files()} == levels
        layouts[pkg.name] = sorted(
            (lvl, f.num_entries) for lvl, f in st.current.all_files())
        dst.close()
    assert sum(n for _, n in layouts["port"]) == \
        sum(n for _, n in layouts["ref"])


@BOTH
def test_import_comparator_mismatch(tmp_path, pkg):           # :89
    src = _filled_db(pkg, tmp_path / "src", n=20)
    pkg.job.export_column_family(src, None, str(tmp_path / "exp"))
    src.close()
    dst = _open(pkg, tmp_path / "dst", comparator=pkg.reverse)
    with pytest.raises(pkg.InvalidArgument):
        dst.create_column_family_with_import("cf", str(tmp_path / "exp"))
    # A failed import leaves no half-created CF behind.
    assert dst.get_column_family("cf") is None
    dst.close()


@BOTH
def test_import_seqno_visibility(tmp_path, pkg):              # :104
    src = _filled_db(pkg, tmp_path / "src", n=200)
    pkg.job.export_column_family(src, None, str(tmp_path / "exp"))
    src.close()
    dst = _open(pkg, tmp_path / "dst")  # fresh: last_sequence ~ 0
    h = dst.create_column_family_with_import("cf", str(tmp_path / "exp"))
    assert dst.get(b"key00000", cf=h) == b"upd00000"
    dst.put(b"key00000", b"newer", cf=h)
    assert dst.get(b"key00000", cf=h) == b"newer"
    dst.close()


@BOTH
def test_export_dir_must_be_empty(tmp_path, pkg):             # :119
    src = _filled_db(pkg, tmp_path / "src", n=10)
    (tmp_path / "exp").mkdir()
    (tmp_path / "exp" / "junk").write_text("x")
    with pytest.raises(pkg.InvalidArgument):
        pkg.job.export_column_family(src, None, str(tmp_path / "exp"))
    src.close()


@BOTH
def test_metadata_file_roundtrip(tmp_path, pkg):              # :127
    src = _filled_db(pkg, tmp_path / "src", n=30)
    meta = pkg.job.export_column_family(src, None, str(tmp_path / "exp"))
    loaded = pkg.job.ExportImportFilesMetaData.load(str(tmp_path / "exp"),
                                                    src.env)
    assert loaded == meta
    assert loaded.files[0].smallest == meta.files[0].smallest
    src.close()


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("exporter,importer", [(REF, PORT), (PORT, REF)],
                         ids=["ref-to-port", "port-to-ref"])
def test_export_imports_in_the_other_package(tmp_path, exporter, importer):
    src = _open(exporter, tmp_path / "src", write_buffer_size=32 * 1024)
    aux = src.create_column_family("aux")
    for i in range(400):
        src.put(b"key%05d" % i, b"val%05d" % i, cf=aux)
    src.flush()
    for i in range(0, 400, 3):
        src.put(b"key%05d" % i, b"upd%05d" % i, cf=aux)
    src.put(b"default-only", b"x")
    meta = exporter.job.export_column_family(src, aux, str(tmp_path / "exp"))
    src.close()
    names = sorted(os.listdir(tmp_path / "exp"))
    assert names == sorted([f.name for f in meta.files]
                           + [exporter.job.METADATA_FILE])
    assert all(f.file_checksum for f in meta.files)
    loaded = importer.job.ExportImportFilesMetaData.load(
        str(tmp_path / "exp"), importer.env())
    assert [f.name for f in loaded.files] == [f.name for f in meta.files]
    dst = _open(importer, tmp_path / "dst")
    try:
        h = dst.create_column_family_with_import("imported",
                                                 str(tmp_path / "exp"))
        want = _want(400)
        assert _scan(importer, dst, h) == want
        assert dst.get(b"default-only", cf=h) is None
        dst.compact_range()
        assert _scan(importer, dst, h) == want
        v = dst.versions.cf_current(h.id)
        assert not v.files[0] and v.num_files() >= 1
        if importer is PORT:
            factory = dst.options.compaction_executor_factory
            assert [j["cf_id"] for j in factory.jobs] == [h.id]
    finally:
        dst.close()
    with importer.DB.open(str(tmp_path / "dst"),
                          importer.Options(**importer.extra())) as dst:
        assert _scan(importer, dst,
                     dst.get_column_family("imported")) == _want(400)
