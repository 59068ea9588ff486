"""The port's block codecs and compressed tables against toplingdb_tpu's:
the same inputs, made from a seed, through both packages' `fmt.compress`,
`zstd_train_dictionary`, TableBuilder and TableReader. Compressed frames,
dictionaries and SST files must be byte-identical, and each package must
read the other's. Tolerance: bitwise."""

import dataclasses

import numpy as np
import pytest

from toplingdb_tpu.db.dbformat import (
    InternalKeyComparator as RefICMP,
    ValueType,
    make_internal_key,
)
from toplingdb_tpu.env import default_env
from toplingdb_tpu.table import format as ref_fmt
from toplingdb_tpu.table.builder import (
    CompressionOptions as RefCO,
    TableBuilder as RefBuilder,
    TableOptions as RefTO,
)
from toplingdb_tpu.table.reader import TableReader as RefReader
from toplingdb_tpu.utils import codecs as ref_codecs

from toplingdb_tpu_torch.db.dbformat import InternalKeyComparator
from toplingdb_tpu_torch.env import PosixEnv
from toplingdb_tpu_torch.interop import table_options_from_plain
from toplingdb_tpu_torch.table import format as fmt
from toplingdb_tpu_torch.table.builder import (
    CompressionOptions,
    TableBuilder,
    TableOptions,
)
from toplingdb_tpu_torch.table.factory import open_table
from toplingdb_tpu_torch.table.reader import TableReader
from toplingdb_tpu_torch.utils import codecs
from toplingdb_tpu_torch.utils.status import Corruption

REF_ICMP = RefICMP()
ICMP = InternalKeyComparator()

# (compression type, level) pairs: every codec of table/format.py, at its
# default level and where it has them, at others.
CODEC_LEVELS = [
    (fmt.SNAPPY_COMPRESSION, None),
    (fmt.ZLIB_COMPRESSION, None), (fmt.ZLIB_COMPRESSION, 1),
    (fmt.ZLIB_COMPRESSION, 9),
    (fmt.BZIP2_COMPRESSION, None),
    (fmt.LZ4_COMPRESSION, None),
    (fmt.LZ4HC_COMPRESSION, None), (fmt.LZ4HC_COMPRESSION, 4),
    (fmt.LZ4HC_COMPRESSION, 12),
    (fmt.ZSTD_COMPRESSION, None), (fmt.ZSTD_COMPRESSION, -3),
    (fmt.ZSTD_COMPRESSION, 1), (fmt.ZSTD_COMPRESSION, 19),
    (fmt.LZMA_COMPRESSION, None),
]
CTYPES = sorted({c for c, _ in CODEC_LEVELS})
LIB_CODECS = [fmt.SNAPPY_COMPRESSION, fmt.LZ4_COMPRESSION,
              fmt.LZ4HC_COMPRESSION, fmt.ZSTD_COMPRESSION]


def payloads(seed):
    """Compressible text, a structured block-like run, random bytes, and
    the empty string."""
    rng = np.random.default_rng(seed)
    text = b"the quick brown fox " * 200 + bytes(range(256))
    rows = b"".join(b"key%08d|val-%06d-" % (int(k), int(k) % 977)
                    for k in rng.integers(0, 10 ** 8, 300))
    rnd = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    return [text, rows, rnd, b""]


@pytest.mark.parametrize("ctype,level", CODEC_LEVELS)
def test_compress_matches_reference(ctype, level):
    """Same frames from both packages, and each decompresses the other's."""
    for data in payloads(ctype * 100 + (level or 0) + 5):
        mine = fmt.compress(data, ctype, level)
        ref = ref_fmt.compress(data, ctype, level)
        assert mine == ref
        assert fmt.decompress(ref, ctype) == data
        assert ref_fmt.decompress(mine, ctype) == data
        assert fmt.compress_for_block(data, ctype, level) == \
            ref_fmt.compress_for_block(data, ctype, level)


@pytest.mark.parametrize("ctype", CTYPES)
def test_roundtrip_and_fallback(ctype):
    """The reference suite's round trip (tests/test_codecs.py:34): text
    shrinks, empty and incompressible payloads round-trip, and
    compress_for_block keeps a random block raw (the 12.5% rule)."""
    data = b"the quick brown fox " * 200 + bytes(range(256))
    c = fmt.compress(data, ctype)
    assert len(c) < len(data)
    assert fmt.decompress(c, ctype) == data
    assert fmt.decompress(fmt.compress(b"", ctype), ctype) == b""
    rnd = np.random.default_rng(7).integers(0, 255, 4096, np.uint8).tobytes()
    assert fmt.decompress(fmt.compress(rnd, ctype), ctype) == rnd
    assert fmt.compress_for_block(rnd, ctype) == (rnd, fmt.NO_COMPRESSION)


@pytest.mark.parametrize("ctype", CTYPES)
def test_corrupt_payload_raises(ctype):
    """A flipped byte either raises Corruption or decodes to other bytes
    (the reference suite's rule, tests/test_codecs.py:45); a truncated
    frame always raises Corruption."""
    data = b"abcdefgh" * 512
    c = bytearray(fmt.compress(data, ctype))
    c[len(c) // 2] ^= 0xFF
    try:
        assert fmt.decompress(bytes(c), ctype) != data
    except Corruption:
        pass
    with pytest.raises(Corruption):
        fmt.decompress(bytes(fmt.compress(data, ctype)[:3]), ctype)
    with pytest.raises(Corruption):
        fmt.decompress(b"xx", 0x55)  # unknown type byte


def test_zstd_dictionary_matches_reference():
    """Trained dictionaries are byte-identical from the same samples, so
    are the frames compressed with them, and a wrong dictionary raises."""
    rng = np.random.default_rng(11)
    samples = [b"user:%04d:profile:%s:common-suffix-xyz"
               % (int(i), b"ab" * int(rng.integers(1, 8)))
               for i in rng.integers(0, 10000, 500)]
    d = codecs.zstd_train_dictionary(samples, 4096)
    assert d and d == ref_codecs.zstd_train_dictionary(samples, 4096)
    blob = b"user:9999:profile:abab:common-suffix-xyz"
    c = codecs.zstd_compress(blob, 3, d)
    assert c == ref_codecs.zstd_compress(blob, 3, d)
    assert codecs.zstd_decompress(c, d) == blob
    assert ref_codecs.zstd_decompress(c, d) == blob
    with pytest.raises(Corruption):
        codecs.zstd_decompress(c, b"")
    assert codecs.zstd_train_dictionary([], 4096) == b""
    assert codecs.zstd_train_dictionary(samples, 0) == b""


def test_available_reports_each_library():
    for name in ("snappy", "lz4", "zstd"):
        assert codecs.available(name) == ref_codecs.available(name)


def _entries(n, seed):
    rng = np.random.default_rng(seed)
    keys = sorted(set(int(k) for k in rng.integers(0, 10 ** 7, n)))
    return [(make_internal_key(b"key%08d" % k, i + 1, ValueType.VALUE),
             b"value-payload-%06d-%s" % (k % 99991, b"x" * (k % 17)))
            for i, k in enumerate(keys)]


def _write_pair(tmp_path, entries, ref_opts, tag):
    """The same entries through both packages' TableBuilder; returns the
    two paths."""
    env = default_env()
    ref_path = str(tmp_path / f"ref-{tag}.sst")
    w = env.new_writable_file(ref_path)
    b = RefBuilder(w, REF_ICMP, ref_opts)
    for k, v in entries:
        b.add(k, v)
    b.finish()
    w.close()
    port_opts = table_options_from_plain(_plain(ref_opts))
    port_path = str(tmp_path / f"port-{tag}.sst")
    w = PosixEnv().new_writable_file(port_path)
    b = TableBuilder(w, ICMP, port_opts)
    for k, v in entries:
        b.add(k, v)
    b.finish()
    w.close()
    return ref_path, port_path


def _plain(o) -> dict:
    d = {f.name: getattr(o, f.name) for f in dataclasses.fields(o)
         if isinstance(getattr(o, f.name), (bool, int, float, str))}
    d["filter_policy_name"] = o.filter_policy.name() if o.filter_policy \
        else ""
    d["compression_opts"] = dataclasses.asdict(o.compression_opts)
    return d


def _read_all(reader):
    it = reader.new_iterator()
    it.seek_to_first()
    return list(it.entries())


TABLE_CASES = [
    ("snappy", dict(compression=fmt.SNAPPY_COMPRESSION)),
    ("zlib", dict(compression=fmt.ZLIB_COMPRESSION)),
    ("bz2", dict(compression=fmt.BZIP2_COMPRESSION)),
    ("lz4", dict(compression=fmt.LZ4_COMPRESSION)),
    ("lz4hc", dict(compression=fmt.LZ4HC_COMPRESSION)),
    ("zstd", dict(compression=fmt.ZSTD_COMPRESSION)),
    ("zstd-level", dict(compression=fmt.ZSTD_COMPRESSION,
                        compression_opts=RefCO(level=9))),
    ("lzma", dict(compression=fmt.LZMA_COMPRESSION)),
    ("zstd-parallel", dict(compression=fmt.ZSTD_COMPRESSION,
                           compression_parallel_threads=4)),
    ("snappy-parallel", dict(compression=fmt.SNAPPY_COMPRESSION,
                             compression_parallel_threads=4)),
    ("zstd-dict", dict(compression=fmt.ZSTD_COMPRESSION,
                       compression_opts=RefCO(
                           max_dict_bytes=4096,
                           zstd_max_train_bytes=1 << 16))),
    ("zstd-dict-parallel", dict(compression=fmt.ZSTD_COMPRESSION,
                                compression_parallel_threads=4,
                                compression_opts=RefCO(
                                    max_dict_bytes=4096))),
    ("zstd-dict-small-file", dict(compression=fmt.ZSTD_COMPRESSION,
                                  compression_opts=RefCO(
                                      max_dict_bytes=16384))),
]


@pytest.mark.parametrize("tag,kw", TABLE_CASES, ids=[t for t, _ in
                                                      TABLE_CASES])
def test_table_builder_matches_reference(tmp_path, tag, kw):
    """Byte-identical SSTs for each codec, the parallel pool and the ZSTD
    dictionary; each package reads the other's file to the same entries,
    point by point."""
    entries = _entries(3000, seed=len(tag))
    ref_opts = RefTO(block_size=1024, **kw)
    ref_path, port_path = _write_pair(tmp_path, entries, ref_opts, tag)
    assert open(port_path, "rb").read() == open(ref_path, "rb").read()
    port_opts = table_options_from_plain(_plain(ref_opts))
    r = TableReader(PosixEnv().new_random_access_file(ref_path), ICMP,
                    port_opts)
    assert _read_all(r) == entries
    ref_r = RefReader(default_env().new_random_access_file(port_path),
                      REF_ICMP, ref_opts)
    assert _read_all(ref_r) == entries
    assert bool(r._compression_dict) == bool(ref_r._compression_dict)
    if "dict" in tag:
        assert r._compression_dict  # trained and stored
    it = r.new_iterator()
    it.seek_to_last()
    assert it.valid() and (it.key(), it.value()) == entries[-1]
    it.seek_to_first()
    assert it.valid() and (it.key(), it.value()) == entries[0]


def test_dict_training_failure_matches_reference(tmp_path, monkeypatch):
    """A failed ZDICT training (the reference suite's case,
    tests/test_codecs.py:192) disables the dictionary: both packages write
    the same bytes with every block, for the TableBuilder and for the
    columnar writer."""
    from toplingdb_tpu.ops.columnar_io import (
        ColumnarKV as RefKV,
        write_tables_columnar as ref_write,
    )

    from toplingdb_tpu_torch.ops.columnar_io import (
        ColumnarKV,
        write_tables_columnar,
    )

    monkeypatch.setattr(ref_codecs, "zstd_train_dictionary",
                        lambda samples, cap: b"")
    monkeypatch.setattr(codecs, "zstd_train_dictionary",
                        lambda samples, cap: b"")
    ref_opts = RefTO(compression=fmt.ZSTD_COMPRESSION, block_size=512,
                     compression_opts=RefCO(max_dict_bytes=4096,
                                            zstd_max_train_bytes=1 << 16))
    entries = _entries(4000, seed=3)
    ref_path, port_path = _write_pair(tmp_path, entries, ref_opts, "fail")
    assert open(port_path, "rb").read() == open(ref_path, "rb").read()
    r = TableReader(PosixEnv().new_random_access_file(port_path), ICMP,
                    table_options_from_plain(_plain(ref_opts)))
    assert not r._compression_dict
    assert _read_all(r) == entries

    n = 200
    keys = np.frombuffer(
        b"".join(make_internal_key(b"ck%06d" % i, i + 1, ValueType.VALUE)
                 for i in range(n)), dtype=np.uint8).copy()
    vals = np.frombuffer(
        b"".join(b"columnar-value-%06d" % i for i in range(n)),
        dtype=np.uint8).copy()
    cols = (keys, np.arange(n, dtype=np.int32) * 16,
            np.full(n, 16, dtype=np.int32), vals,
            np.arange(n, dtype=np.int32) * 21, np.full(n, 21, dtype=np.int32))
    args = (np.arange(n, dtype=np.int32), np.full(n, -1, dtype=np.int64),
            np.full(n, int(ValueType.VALUE), dtype=np.int32),
            np.arange(1, n + 1, dtype=np.uint64))
    outs = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        counter = [77]

        def alloc():
            counter[0] += 1
            return counter[0]

        if side == "ref":
            files = ref_write(default_env(), str(d), alloc, REF_ICMP,
                              ref_opts, RefKV(*cols), *args, [],
                              creation_time=1)
        else:
            files = write_tables_columnar(
                PosixEnv(), str(d), alloc, ICMP,
                table_options_from_plain(_plain(ref_opts)), ColumnarKV(*cols),
                *args, creation_time=1)
        outs[side] = [open(f[1], "rb").read() for f in files]
    assert outs["port"] == outs["ref"] and outs["port"]


@pytest.mark.parametrize("ctype", [fmt.SNAPPY_COMPRESSION,
                                   fmt.ZSTD_COMPRESSION,
                                   fmt.LZ4_COMPRESSION])
def test_open_table_reads_reference_tables(tmp_path, ctype):
    """open_table dispatches a reference-written compressed block table to
    the port's reader; a corrupted compressed block raises Corruption."""
    entries = _entries(1500, seed=ctype)
    ref_opts = RefTO(block_size=512, compression=ctype)
    ref_path, _ = _write_pair(tmp_path, entries, ref_opts, "open")
    r = open_table(PosixEnv().new_random_access_file(ref_path), ICMP,
                   TableOptions(compression=ctype))
    assert _read_all(r) == entries
    raw = bytearray(open(ref_path, "rb").read())
    raw[40] ^= 0xFF  # inside the first data block
    bad = str(tmp_path / "bad.sst")
    open(bad, "wb").write(bytes(raw))
    r = open_table(PosixEnv().new_random_access_file(bad), ICMP,
                   TableOptions(compression=ctype))
    with pytest.raises(Corruption):
        _read_all(r)


def test_compression_options_cross_as_plain_values():
    o = table_options_from_plain(_plain(RefTO(
        compression=fmt.ZSTD_COMPRESSION,
        compression_opts=RefCO(level=7, max_dict_bytes=16384,
                               zstd_max_train_bytes=1 << 20))))
    assert o.compression_opts == CompressionOptions(
        level=7, max_dict_bytes=16384, zstd_max_train_bytes=1 << 20)
    assert o.compression_opts.train_budget() == 1 << 20
    assert CompressionOptions(max_dict_bytes=100).train_budget() == 10000
    from toplingdb_tpu_torch.utils.status import InvalidArgument

    with pytest.raises(InvalidArgument):
        table_options_from_plain({"compression_opts": {"window": 1}})
