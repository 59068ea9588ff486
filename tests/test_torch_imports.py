"""toplingdb_tpu_torch stands alone: importing it and every submodule
loads neither jax nor any toplingdb_tpu module, and no source file of the
port (nor chip_smoke.py) imports either, or touches the process
environment for the reference's route knobs (TPULSM_HOST_SORT,
TPULSM_HOST_MERGE, TPULSM_MESH_*, XLA_FLAGS): the port takes them as
arguments."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "toplingdb_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "toplingdb_tpu")


def _forbidden(name: str) -> bool:
    """True for jax, jaxlib, toplingdb_tpu and their submodules — but not
    toplingdb_tpu_torch."""
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_prefix_rule():
    assert _forbidden("toplingdb_tpu") and _forbidden("toplingdb_tpu.ops")
    assert _forbidden("jax.numpy") and not _forbidden("jaxtyping")
    assert not _forbidden("toplingdb_tpu_torch")
    assert not _forbidden("toplingdb_tpu_torch.ops.kernels")


def test_import_pulls_in_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import importlib, pkgutil\n"
        "import toplingdb_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'toplingdb_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(len(names))\n"
        "print('\\n'.join(sorted(set(sys.modules) - before)))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")
    assert int(lines[0]) >= 20  # every submodule was imported
    loaded = [m for m in lines[1:] if m]
    assert "toplingdb_tpu_torch.ops.device_compaction" in loaded
    assert "toplingdb_tpu_torch.db.import_column_family_job" in loaded
    for m in ("toplingdb_tpu_torch.tools.block_cache_analyzer",
              "toplingdb_tpu_torch.env.async_reads",
              "toplingdb_tpu_torch.utils.persistent_cache"):
        assert m in loaded, m  # the read path's modules are walked too
    # and the thread-status registry of the manual entry points.
    assert "toplingdb_tpu_torch.utils.thread_status" in loaded
    # and the seqno-to-time mapping of the storage slice.
    assert "toplingdb_tpu_torch.utils.seqno_to_time" in loaded
    # and the read-only, tailing and repair modules of the DB.
    for m in ("toplingdb_tpu_torch.db.db_readonly",
              "toplingdb_tpu_torch.db.forward_iterator",
              "toplingdb_tpu_torch.db.repair"):
        assert m in loaded, m
    # and the host twins' pipeline, the mesh plane and distributed GC.
    for m in ("toplingdb_tpu_torch.ops.mesh_compaction",
              "toplingdb_tpu_torch.parallel",
              "toplingdb_tpu_torch.parallel.mesh_plan",
              "toplingdb_tpu_torch.parallel.distributed_gc",
              "toplingdb_tpu_torch.parallel.scaling_probe",
              "toplingdb_tpu_torch.parallel.entry"):
        assert m in loaded, m
    # and the SLO engine, the op trace with its analyzer, the concurrency
    # plane and the SidePlugin layer.
    for m in ("toplingdb_tpu_torch.utils.slo",
              "toplingdb_tpu_torch.utils.trace",
              "toplingdb_tpu_torch.tools.trace_analyzer",
              "toplingdb_tpu_torch.utils.concurrency",
              "toplingdb_tpu_torch.utils.sync_point",
              "toplingdb_tpu_torch.utils.config"):
        assert m in loaded, m
    # and the utilities, the CompactionService, the wrapper Envs and the
    # CUDA probe.
    for m in SLICE22_MODULES:
        assert m in loaded, m
    # and the shared SST store and the replication plane.
    for m in SLICE23_MODULES:
        assert m in loaded, m
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad


SLICE22_MODULES = (
    "toplingdb_tpu_torch.utilities",
    "toplingdb_tpu_torch.utilities.transactions",
    "toplingdb_tpu_torch.utilities.write_batch_with_index",
    "toplingdb_tpu_torch.utilities.checkpoint",
    "toplingdb_tpu_torch.utilities.backup_engine",
    "toplingdb_tpu_torch.utilities.sst_file_writer",
    "toplingdb_tpu_torch.utilities.ttl",
    "toplingdb_tpu_torch.utilities.option_migration",
    "toplingdb_tpu_torch.compaction.compaction_service",
    "toplingdb_tpu_torch.env.overlay",
    "toplingdb_tpu_torch.env.remap",
    "toplingdb_tpu_torch.env.encrypted",
    "toplingdb_tpu_torch.env.io_tracer",
    "toplingdb_tpu_torch.tools.io_tracer_parser",
    "toplingdb_tpu_torch.utils.backend_probe",
)


SLICE23_MODULES = (
    "toplingdb_tpu_torch.storage",
    "toplingdb_tpu_torch.storage.object_store",
    "toplingdb_tpu_torch.storage.shared_env",
    "toplingdb_tpu_torch.storage.gc",
    "toplingdb_tpu_torch.storage.store_server",
    "toplingdb_tpu_torch.replication",
    "toplingdb_tpu_torch.replication.log_shipper",
    "toplingdb_tpu_torch.replication.follower",
    "toplingdb_tpu_torch.replication.router",
)


@pytest.mark.parametrize("module", SLICE23_MODULES)
def test_slice23_modules_read_no_environment(module):
    """Ground rule 4 for the shared store and the replication plane: no
    access to os.environ or os.getenv (Options.shared_store is the store's
    only switch; toplingdb_tpu's DB reads TPULSM_SHARED_STORE)."""
    test_slice22_modules_read_no_environment(module)


@pytest.mark.parametrize("module", SLICE22_MODULES)
def test_slice22_modules_read_no_environment(module):
    """Ground rule 4 for the utilities, the service, the wrapper Envs and
    the CUDA probe: no access to os.environ or os.getenv at all (the
    probe decides nothing by the environment and redirects nothing)."""
    import importlib

    mod = importlib.import_module(module)
    path = mod.__file__
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        assert not _is_environ(node), f"{path}:{node.lineno} os.environ"
        if isinstance(node, ast.Attribute):
            assert node.attr not in ("getenv", "putenv"), \
                f"{path}:{node.lineno} os.{node.attr}"


def _sources():
    for dirpath, _, names in os.walk(PORT):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_neither(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            names = [str(node.args[0].value)]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


KNOBS = ("TPULSM_HOST_SORT", "TPULSM_HOST_MERGE", "XLA_FLAGS")


def _knob(value) -> bool:
    return isinstance(value, str) and (
        value in KNOBS or value.startswith("TPULSM_MESH_"))


def _is_environ(node) -> bool:
    """os.environ, or a bare `environ` imported from os."""
    return ((isinstance(node, ast.Attribute) and node.attr == "environ")
            or (isinstance(node, ast.Name) and node.id == "environ"))


def test_knob_rule():
    src = ("import os\n"
           "a = os.environ.get('TPULSM_HOST_SORT')\n"
           "os.environ['TPULSM_MESH_COMPACT'] = '1'\n"
           "b = os.getenv('XLA_FLAGS')\n"
           "env = {'TPULSM_HOST_MERGE': '0'}\n"
           "c = os.environ.get('TPULSM_PIPELINE')\n")
    assert len(_knob_uses(ast.parse(src))) == 4


def _knob_uses(tree):
    """Every line that names a route knob: a string constant equal to
    one (an environ subscript, get / pop / setdefault / os.getenv
    argument, or an env-dict key), or an environ access with one."""
    hits = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and _knob(node.value):
            hits.add(node.lineno)
        elif (isinstance(node, ast.Subscript) and _is_environ(node.value)
              and isinstance(node.slice, ast.Constant)
              and _knob(node.slice.value)):
            hits.add(node.lineno)
    return sorted(hits)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_sources_read_no_route_knobs(path):
    """Ground rule 4: no module of the port, nor chip_smoke.py, reads or
    writes the process environment for the reference's route knobs."""
    tree = ast.parse(open(path).read(), filename=path)
    assert not _knob_uses(tree), f"{path}: knob at lines {_knob_uses(tree)}"


def test_worker_subprocess_loads_no_jax(tmp_path):
    """The dcompact worker run as a process (a snappy job written with the
    port's own TableBuilder and CompactionParams, device "cpu-jax") loads
    neither jax nor any toplingdb_tpu module."""
    from toplingdb_tpu_torch.compaction.executor import CompactionParams
    from toplingdb_tpu_torch.db.dbformat import (
        InternalKeyComparator,
        make_internal_key,
    )
    from toplingdb_tpu_torch.env import PosixEnv
    from toplingdb_tpu_torch.table.builder import TableBuilder, TableOptions

    inputs = []
    for f in range(2):
        path = str(tmp_path / ("%06d.sst" % (f + 1)))
        w = PosixEnv().new_writable_file(path)
        b = TableBuilder(w, InternalKeyComparator(),
                         TableOptions(block_size=512, compression=1))
        for i in range(300):
            b.add(make_internal_key(b"k%05d" % i, f * 1000 + i + 1, 1),
                  b"v%05d" % i)
        b.finish()
        w.close()
        inputs.append(path)
    job = tmp_path / "job"
    (job / "out").mkdir(parents=True)
    (job / "params.json").write_text(CompactionParams(
        job_id=1, attempt=1, dbname=str(tmp_path),
        output_dir=str(job / "out"), input_files=inputs, output_level=1,
        bottommost=True, max_output_file_size=1 << 30, snapshots=[],
        comparator="tpulsm.BytewiseComparator", merge_operator=None,
        compaction_filter=None, compression=1, block_size=512,
        creation_time=1, device="cpu-jax", lease_sec=0.0).to_json())
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "from toplingdb_tpu_torch.compaction import worker\n"
        f"rc = worker.main(['--job-dir', {str(job)!r}])\n"
        "print(rc)\n"
        "print('\\n'.join(sorted(set(sys.modules) - before)))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")
    assert lines[0] == "0", out.stderr
    loaded = [m for m in lines[1:] if m]
    assert "toplingdb_tpu_torch.ops.pipeline" in loaded
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad
    assert os.listdir(job / "out")


def test_native_planes_load_no_jax(tmp_path):
    """The DB's host planes run in a process (the native library and the
    `tpt_fastget` extension built and loaded by native/__init__.py, a
    natively committed write, a get through the native chain, a scan
    through ops/scan_plane.py) load neither jax nor any toplingdb_tpu
    module."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "from toplingdb_tpu_torch import native\n"
        "from toplingdb_tpu_torch.compaction.executor import (\n"
        "    LocalCompactionExecutorFactory)\n"
        "from toplingdb_tpu_torch.db.db import DB\n"
        "from toplingdb_tpu_torch.options import Options\n"
        f"db = DB.open({str(tmp_path / 'db')!r}, Options(\n"
        "    create_if_missing=True,\n"
        "    compaction_executor_factory=LocalCompactionExecutorFactory()))\n"
        "for i in range(100):\n"
        "    db.put(b'k%03d' % i, b'v')\n"
        "db.flush()\n"
        "assert db.get(b'k007') == b'v' and native.fastget() is not None\n"
        "it = db.new_iterator()\n"
        "it.seek_to_first()\n"
        "assert it._plane is not None and len(list(it.entries())) == 100\n"
        "db.close()\n"
        "print('\\n'.join(sorted(set(sys.modules) - before)))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = [m for m in out.stdout.split("\n") if m]
    assert "toplingdb_tpu_torch.ops.scan_plane" in loaded
    assert "tpt_fastget" in loaded
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad
