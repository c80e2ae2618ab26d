"""Port parity for V(D)J, tolerance 0: the same seeded inputs through the JAX
package and cellranger_tpu_torch on the CPU.

  * `ops/lookup.py` `SortedTable` (empty table, keys with the top bit set,
    queries past the last key) and the three branches of
    `ops/barcode.py` `whitelist_lookup`; `count_valid_barcodes` with
    misses;
  * `vdj/assembly.py` `_rolling_kmers_2w`, `count_bc_kmers` and
    `count_bc_umi_kmers`, in one chunk and in several, on reads rich in
    G/T (kmers whose low word has its top bit set) and barcodes over the
    whole u32 range;

`run_vdj` and the CLI are in tests/test_torch_vdj_run.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellranger_tpu.ops import barcode as jbarcode
from cellranger_tpu.ops.bucket_table import BucketTable as JBucketTable
from cellranger_tpu.ops.lookup import SortedTable as JSortedTable
from cellranger_tpu.vdj import assembly as jasm
from cellranger_tpu_torch.ops import barcode as tbarcode
from cellranger_tpu_torch.ops.bucket_table import BucketTable
from cellranger_tpu_torch.ops.lookup import SortedTable
from cellranger_tpu_torch.vdj import assembly as tasm


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _u32(a):
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


def _keys(rng, n):
    """Sorted distinct u32 keys, about half of them >= 2^31, with runs that
    crowd a few buckets."""
    k = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    k[: n // 4] = (np.uint64(0xF0000000)
                   + rng.integers(0, 64, n // 4, dtype=np.uint64))
    return np.unique(k.astype(np.uint32))


def _queries(rng, keys, n):
    """Members, near misses, 0, the largest u32 and values past the last
    key."""
    q = [keys[rng.integers(0, len(keys), n)] if len(keys) else
         np.zeros(0, np.uint32),
         rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
         np.array([0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF], np.uint32)]
    if len(keys):
        q.append(keys + np.uint32(1))
        q.append(np.array([keys[-1]], np.uint32) + np.arange(
            1, 5, dtype=np.uint32))
    return np.concatenate(q).astype(np.uint32)


@pytest.mark.parametrize("n_keys,bits", [(0, 22), (1, 22), (3000, 22),
                                         (3000, 8), (40, 4)])
def test_sorted_table_matches_jax(n_keys, bits):
    rng = np.random.default_rng(n_keys + bits)
    keys = _keys(rng, n_keys) if n_keys else np.zeros(0, np.uint32)
    if n_keys == 1:
        keys = np.array([0xFFFFFFF0], np.uint32)
    q = _queries(rng, keys, 500)
    jt = JSortedTable.build(keys, bits=bits)
    tt = SortedTable.build(keys, "cpu", bits=bits)
    assert tt.n_iters == jt.n_iters and tt.bits == jt.bits
    np.testing.assert_array_equal(
        tt.bucket_starts.numpy(), np.asarray(jt.bucket_starts))
    jq = jnp.asarray(q)
    np.testing.assert_array_equal(tt.lower_bound(_u32(q)).numpy(),
                                  np.asarray(jt.lower_bound(jq)))
    jh, ji = jt.membership(jq)
    th, ti = tt.membership(_u32(q))
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if len(keys):
        assert th.any() and not th.all()


def test_whitelist_lookup_all_branches_match_jax():
    rng = np.random.default_rng(3)
    wl = _keys(rng, 2000)
    q = _queries(rng, wl, 800)
    jq, tq = jnp.asarray(q), _u32(q)
    vals = np.arange(len(wl), dtype=np.uint32)
    tables = [
        (JBucketTable.build_exact(wl, vals, entries=8, fields=3),
         BucketTable.build_exact(wl, vals, "cpu", entries=8, fields=3)),
        (JSortedTable.build(wl), SortedTable.build(wl, "cpu")),
        (jnp.asarray(wl), _u32(wl)),
    ]
    for jwl, twl in tables:
        jh, ji = jbarcode.whitelist_lookup(jq, jwl)
        th, ti = tbarcode.whitelist_lookup(tq, twl)
        assert ti.dtype == torch.int32
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert th.any() and not th.all()


def test_count_valid_barcodes_with_misses_matches_jax():
    rng = np.random.default_rng(4)
    W = 97
    idx = rng.integers(-1, W, 5000).astype(np.int32)
    idx[:50] = -1
    valid = rng.random(5000) < 0.8
    want = np.asarray(jbarcode.count_valid_barcodes(
        jnp.asarray(idx), jnp.asarray(valid), W))
    got = tbarcode.count_valid_barcodes(torch.from_numpy(idx),
                                        torch.from_numpy(valid), W)
    assert got.dtype == torch.int32 and got.shape == (W,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() == (valid & (idx >= 0)).sum()


def _reads(seed, n, L=60, n_bc=7, n_umi=5):
    """Reads rich in G/T (code 2, 3), a few N bases and short reads; many
    reads share a (barcode, UMI) and repeat a few source sequences, so
    (barcode, UMI, kmer) rows repeat; barcodes span the u32 range."""
    rng = np.random.default_rng(seed)
    src = rng.choice(4, (6, L + 30), p=[0.1, 0.1, 0.4, 0.4]).astype(np.uint8)
    which = rng.integers(0, 6, n)
    off = rng.integers(0, 30, n)
    rna = src[which[:, None], off[:, None] + np.arange(L)[None, :]]
    nmask = np.ones((n, L), bool)
    nmask[rng.random((n, L)) < 0.01] = False
    short = rng.random(n) < 0.1
    nmask[short, L // 2:] = False
    bcs = rng.integers(0, 1 << 32, n_bc, dtype=np.uint64).astype(np.uint32)
    bcs[0] = 0xFFFFFFFF
    bc = bcs[rng.integers(0, n_bc, n)]
    umi = rng.integers(0, n_umi, n).astype(np.uint32) * np.uint32(0x9E3779B9)
    return bc, umi, rna, nmask


def test_rolling_kmers_2w_matches_jax():
    _, _, rna, nmask = _reads(1, 50, L=91)
    jh, jl, jv = jax.jit(jasm._rolling_kmers_2w)(jnp.asarray(rna),
                                                  jnp.asarray(nmask))
    th, tl, tv = tasm._rolling_kmers_2w(rna, nmask, device="cpu")
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert (np.asarray(jl)[np.asarray(jv)] >= 1 << 31).any()


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


# (chunk, ranks per kmer key): one chunk; several; several with the
# reads' (barcode, UMI) ranks split over passes
CHUNKINGS = [(1 << 20, None), (700, None), (97, None), (700, 4)]


@pytest.mark.parametrize("chunk,ranks", CHUNKINGS)
def test_count_bc_kmers_matches_jax(chunk, ranks, monkeypatch):
    bc, _, rna, nmask = _reads(2, 400)
    if ranks:
        monkeypatch.setattr(tasm, "RANKS_PER_KEY", ranks)
    want = jasm.count_bc_kmers(bc, rna, nmask, chunk=chunk)
    got = tasm.count_bc_kmers(bc, rna, nmask, chunk=chunk, device="cpu")
    _same(got, want)
    assert (want[1] & np.uint64(1 << 31)).any()
    if chunk == CHUNKINGS[0][0]:
        assert want[2].sum() < rna.shape[0] * (rna.shape[1] - 19)


@pytest.mark.parametrize("chunk,ranks", CHUNKINGS)
def test_count_bc_umi_kmers_matches_jax(chunk, ranks, monkeypatch):
    bc, umi, rna, nmask = _reads(3, 400)
    if ranks:
        monkeypatch.setattr(tasm, "RANKS_PER_KEY", ranks)
    want = jasm.count_bc_umi_kmers(bc, umi, rna, nmask, chunk=chunk)
    got = tasm.count_bc_umi_kmers(bc, umi, rna, nmask, chunk=chunk,
                                  device="cpu")
    _same(got, want)
    assert (want[3] > 1).any()


def test_kmer_counts_of_no_valid_kmer_match_jax():
    bc, umi, rna, nmask = _reads(5, 20)
    nmask[:] = False
    _same(tasm.count_bc_umi_kmers(bc, umi, rna, nmask, device="cpu"),
          jasm.count_bc_umi_kmers(bc, umi, rna, nmask))
    _same(tasm.count_bc_kmers(bc, rna, nmask, device="cpu"),
          jasm.count_bc_kmers(bc, rna, nmask))
