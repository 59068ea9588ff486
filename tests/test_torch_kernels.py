"""The port's kernel plain versions against the JAX package's kernels, on
the same numpy inputs: `gc_rows` against the Pallas gc_rows run in interpret
mode, the merge against the XLA `_merge_runs_perm` and the Pallas
`bitonic_merge_runs` (interpret mode), and `shared_prefix_lengths` against
the Pallas `shared_prefix_lengths` (interpret mode). Tolerance: bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toplingdb_tpu.ops import compaction_kernels as ref_ck
from toplingdb_tpu.ops import pallas_kernels as pk

from toplingdb_tpu_torch.ops import kernels

_SIGN = np.uint32(0x80000000)


def _hi(x):
    return (x >> np.uint64(32)).astype(np.uint32)


def _lo(x):
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _t32(x):
    """u32 numpy words → int32 torch tensor of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


@pytest.mark.parametrize("n_snaps,bucket", [(5, 64), (40, 64), (700, 1024)])
def test_gc_rows_plain_matches_pallas(n_snaps, bucket):
    rng = np.random.default_rng(n_snaps)
    n = 2048
    seq = np.sort(rng.integers(0, 1 << 44, n).astype(np.uint64))[::-1]
    snaps = sorted(int(x) for x in rng.integers(0, 1 << 44, n_snaps))
    snap_hi, snap_lo = ref_ck._split_snapshots(snaps)
    assert len(snap_hi) == bucket
    tomb = np.where(rng.random(n) < 0.3,
                    rng.integers(0, 1 << 44, n).astype(np.uint64),
                    np.uint64(0))
    vtype = rng.choice([0, 1, 2, 7], n).astype(np.int32)
    new_key = rng.random(n) < 0.4
    new_key[0] = True
    pseq = np.roll(seq, 1)
    want = pk.gc_rows(
        jnp.asarray(_hi(seq)), jnp.asarray(_lo(seq)),
        jnp.asarray(_hi(pseq)), jnp.asarray(_lo(pseq)),
        jnp.asarray(new_key), jnp.asarray(_hi(tomb)), jnp.asarray(_lo(tomb)),
        jnp.asarray(vtype), jnp.asarray(snap_hi), jnp.asarray(snap_lo),
        interpret=True,
    )
    got = kernels.gc_rows(
        _t32(_hi(seq)), _t32(_lo(seq)), torch.from_numpy(new_key),
        _t32(_hi(tomb)), _t32(_lo(tomb)), torch.from_numpy(vtype),
        _t32(snap_hi), _t32(snap_lo),
    )
    assert got[0].dtype == torch.int32
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    # Without tombstone words nothing is covered; the rest is unchanged.
    got_nt = kernels.gc_rows(
        _t32(_hi(seq)), _t32(_lo(seq)), torch.from_numpy(new_key), None,
        None, torch.from_numpy(vtype), _t32(snap_hi), _t32(snap_lo),
    )
    assert not got_nt[2].any()
    for i in (0, 1, 3):
        assert torch.equal(got_nt[i], got[i])


def _presorted_runs(rng, p, n_runs, n_cols):
    """[n_cols, p] int32 columns holding n_runs presorted runs bounded by
    the returned [n_runs+1] starts: a block of empty runs, equal keys
    across and within runs (the leading columns take 3 values), and full
    32-bit range in the last column."""
    cuts = np.sort(rng.integers(0, p + 1, n_runs - 1))
    cuts[: n_runs // 2] = cuts[0]
    starts = np.concatenate([[0], cuts, [p]]).astype(np.int32)
    cols = rng.integers(-1, 2, (n_cols, p)).astype(np.int32)
    cols[-1] = rng.integers(-2**31, 2**31, p)
    cols[-1, rng.random(p) < 0.5] = 7  # ties on the whole key
    for r in range(n_runs):
        s, e = starts[r], starts[r + 1]
        if e > s:
            seg = cols[:, s:e]
            cols[:, s:e] = seg[:, np.lexsort(seg[::-1])]
    return cols, starts


_ref_merge = jax.jit(ref_ck._merge_runs_perm, static_argnums=2)


@pytest.mark.parametrize("n_runs", [2, 4, 8])
def test_merge_plain_matches_reference_merges(n_runs):
    rng = np.random.default_rng(n_runs)
    cols, starts = _presorted_runs(rng, 1024, n_runs, 5)
    n_rounds = n_runs.bit_length() - 1
    got = kernels.merge_runs_perm(torch.from_numpy(cols),
                                  torch.from_numpy(starts), n_rounds)
    assert got.dtype == torch.int32
    want_xla = _ref_merge(
        tuple(jnp.asarray(c) for c in cols), jnp.asarray(starts), n_rounds)
    assert np.array_equal(got.numpy(), np.asarray(want_xla))
    u32 = [(c.view(np.uint32) ^ _SIGN) for c in cols]
    want_pallas = pk.bitonic_merge_runs(u32, starts.tolist(), interpret=True)
    assert np.array_equal(got.numpy(), want_pallas)


def _edge_runs(rng, p, n_runs, n_cols, layout):
    """Presorted runs in the layouts the merge kernel's tiling must get
    right: empty runs leading, trailing or in the middle, one run longer
    than all the others together, and keys equal across every run."""
    if layout == "leading_empty":
        cuts = np.concatenate([np.zeros(n_runs // 2, np.int64), np.sort(
            rng.integers(0, p + 1, n_runs - 1 - n_runs // 2))])
    elif layout == "trailing_empty":
        cuts = np.concatenate([np.sort(rng.integers(
            0, p + 1, n_runs - 1 - n_runs // 2)), np.full(n_runs // 2, p)])
    elif layout == "one_long":
        cuts = np.sort(rng.integers(p - p // 8, p + 1, n_runs - 1))
    else:
        cuts = np.sort(rng.integers(0, p + 1, n_runs - 1))
        cuts[1: n_runs // 3] = cuts[0]
    starts = np.concatenate([[0], np.sort(cuts), [p]]).astype(np.int32)
    if layout == "all_equal":
        cols = np.full((n_cols, p), 5, dtype=np.int32)
    else:
        cols = rng.integers(-1, 2, (n_cols, p)).astype(np.int32)
        cols[-1] = rng.integers(-2**31, 2**31, p)
        cols[-1, rng.random(p) < 0.5] = 7
    for r in range(n_runs):
        s, e = starts[r], starts[r + 1]
        if e > s:
            seg = cols[:, s:e]
            cols[:, s:e] = seg[:, np.lexsort(seg[::-1])]
    return cols, starts


@pytest.mark.parametrize("n_runs,n_cols,p,layout", [
    (32, 5, 1000, "middle_empty"),
    (8, 35, 777, "middle_empty"),
    (8, 1, 1025, "middle_empty"),
    (8, 5, 1000, "leading_empty"),
    (8, 5, 1000, "trailing_empty"),
    (4, 5, 999, "one_long"),
    (8, 5, 1000, "all_equal"),
    (32, 3, 600, "all_equal"),
])
def test_merge_plain_matches_xla_edge_layouts(n_runs, n_cols, p, layout):
    rng = np.random.default_rng(n_runs * 100 + n_cols)
    cols, starts = _edge_runs(rng, p, n_runs, n_cols, layout)
    n_rounds = n_runs.bit_length() - 1
    got = kernels.merge_runs_perm(torch.from_numpy(cols),
                                  torch.from_numpy(starts), n_rounds)
    want = _ref_merge(
        tuple(jnp.asarray(c) for c in cols), jnp.asarray(starts), n_rounds)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # The merge is the stable sort of the rows by key.
    assert np.array_equal(got.numpy(), np.lexsort(
        (np.arange(p),) + tuple(cols[::-1])))


@pytest.mark.parametrize("n", [1, 3])
def test_gc_rows_plain_matches_pallas_few_rows(n):
    """n rows (row 0's previous row is row n-1), against the Pallas kernel
    on the same rows padded to its 1024-row block."""
    rng = np.random.default_rng(50 + n)
    seq = np.sort(rng.integers(0, 1 << 44, n).astype(np.uint64))[::-1]
    snaps = sorted(int(x) for x in rng.integers(0, 1 << 44, 20))
    snaps[0] = int(seq[-1])  # a row seqno equal to a snapshot
    snap_hi, snap_lo = ref_ck._split_snapshots(snaps)
    tomb = seq + np.uint64(1)
    tomb[0] = 0
    vtype = np.array([2, 1, 7][:n], dtype=np.int32)
    new_key = np.zeros(n, dtype=bool)
    pad = lambda x: np.concatenate([x, np.zeros(1024 - n, x.dtype)])
    pseq = np.roll(seq, 1)
    want = pk.gc_rows(
        jnp.asarray(pad(_hi(seq))), jnp.asarray(pad(_lo(seq))),
        jnp.asarray(pad(_hi(pseq))), jnp.asarray(pad(_lo(pseq))),
        jnp.asarray(pad(new_key)), jnp.asarray(pad(_hi(tomb))),
        jnp.asarray(pad(_lo(tomb))), jnp.asarray(pad(vtype)),
        jnp.asarray(snap_hi), jnp.asarray(snap_lo), interpret=True,
    )
    got = kernels.gc_rows(
        _t32(_hi(seq)), _t32(_lo(seq)), torch.from_numpy(new_key),
        _t32(_hi(tomb)), _t32(_lo(tomb)), torch.from_numpy(vtype),
        _t32(snap_hi), _t32(snap_lo),
    )
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)[:n])
    if n == 1:
        assert not got[1][0]  # its own predecessor: same stripe, no new key
    else:
        # Row 2's seqno is a snapshot, so its tombstone (seqno + 1) lies in
        # the next stripe and does not cover it.
        assert got[2].tolist() == [False, True, False]
        assert got[3].tolist() == [True, False, True]


def test_wrappers_refuse_other_devices():
    x = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError):
        kernels.gc_rows(x, x, x.bool(), None, None, x, x, x)
    with pytest.raises(NotImplementedError):
        kernels.merge_runs_perm(torch.zeros((2, 4), dtype=torch.int32,
                                            device="meta"), x[:3], 1)
    with pytest.raises(NotImplementedError):
        kernels.shared_prefix_lengths(
            torch.zeros((4, 16), dtype=torch.uint8, device="meta"))


def _key_matrix(keys, k):
    m = np.zeros((len(keys), k), dtype=np.uint8)
    for i, key in enumerate(keys):
        m[i, : len(key)] = np.frombuffer(key, dtype=np.uint8)
    return m, np.array([len(key) for key in keys], dtype=np.int32)


def _prefix_both(m, lens):
    """(port plain version, Pallas interpret run) on the same rows."""
    got = kernels.shared_prefix_lengths(
        torch.from_numpy(m), None if lens is None else torch.from_numpy(lens))
    want = pk.shared_prefix_lengths(m, lens, interpret=True)
    assert got.dtype == torch.int32
    return got.numpy(), want


def _pallas_test_rows(case):
    """The rows of tests/test_pallas_kernels.py's four cases."""
    import random

    if case == "basic":
        keys = sorted(b"key%05d" % (i * 7 % 1000) for i in range(500))
    elif case == "zero_padding":
        return _key_matrix([b"ab", b"ab\x00cd"], 8)
    elif case == "random":
        rng = random.Random(3)
        keys = sorted({rng.randbytes(rng.randint(1, 30)) for _ in range(700)})
    elif case == "single":
        keys = [b"solo"]
    else:
        return np.zeros((0, 32), dtype=np.uint8), np.zeros(0, np.int32)
    return _key_matrix(keys, 32)


@pytest.mark.parametrize("case", ["basic", "zero_padding", "random",
                                  "single", "empty"])
def test_prefix_plain_matches_pallas_reference_cases(case):
    m, lens = _pallas_test_rows(case)
    for kl in (lens, None):
        got, want = _prefix_both(m, kl)
        assert got.shape == (len(m),)
        assert np.array_equal(got, want)
    if case == "zero_padding":
        assert _prefix_both(m, lens)[0].tolist() == [0, 2]


@pytest.mark.parametrize("with_lens", [False, True])
@pytest.mark.parametrize("n", [1, 1000, 3000])
@pytest.mark.parametrize("k", [16, 40, 128])
def test_prefix_plain_matches_pallas_sorted_rows(k, n, with_lens):
    """Sorted rows sharing long prefixes: a constant head, then a
    big-endian counter drawn with repeats, so many rows equal their
    predecessor (the 128 case without lens)."""
    rng = np.random.default_rng(k * 10 + n)
    vals = np.sort(rng.integers(0, max(2, n // 2), n)).astype(np.uint64)
    m = np.full((n, k), ord("p"), dtype=np.uint8)
    m[:, : k // 4] = rng.integers(0, 256, k // 4).astype(np.uint8)
    for j in range(8):
        m[:, k - 1 - j] = ((vals >> np.uint64(8 * j)) & np.uint64(0xFF))
    lens = rng.integers(k // 2, k + 1, n).astype(np.int32) if with_lens \
        else None
    got, want = _prefix_both(m, lens)
    assert np.array_equal(got, want)
    if n > 1 and not with_lens:
        assert (got == kernels.KEY_LANES).any()  # duplicate rows
        assert (got[1:] >= k - 8).all()
