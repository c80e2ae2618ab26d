"""Port parity for the device primitives of cellranger_tpu_torch: encode's
device half, bucket-table queries, the trimmer, and the helpers that
stand in for jnp.nonzero(size=), .at[].set(mode="drop"), multi-key
lax.sort and lax.top_k.  Same numpy inputs to both packages; tolerance 0.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cellranger_tpu.ops import encode as jenc
from cellranger_tpu.ops.bucket_table import BucketTable as JaxBucketTable
from cellranger_tpu.ops.trim import make_trimmer as jax_make_trimmer
from cellranger_tpu_torch.ops import encode as tenc
from cellranger_tpu_torch.ops.bucket_table import BucketTable
from cellranger_tpu_torch.ops.tensor_ops import (compact_indices, lexsort,
                                                 scatter_drop)
from cellranger_tpu_torch.ops.trim import TSO_SEQ, make_trimmer

U32 = 0xFFFFFFFF


def _t(a):
    """numpy uint32 -> torch int64 u32 values; other dtypes as they are."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("length", [12, 16])
def test_encode_device_half(length):
    rng = np.random.default_rng(length)
    codes = rng.integers(0, 4, (257, length)).astype(np.uint8)
    want = np.asarray(jenc.pack_codes(jnp.asarray(codes), length))
    got = tenc.pack_codes(torch.from_numpy(codes), length)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        tenc.unpack_codes(got, length).numpy(),
        np.asarray(jenc.unpack_codes(jnp.asarray(want), length)))
    np.testing.assert_array_equal(
        tenc.revcomp_packed(got, length).numpy(),
        np.asarray(jenc.revcomp_packed(jnp.asarray(want), length))
        .astype(np.int64))
    # the numpy half is the JAX package's
    np.testing.assert_array_equal(tenc.pack_codes_np(codes, length),
                                  jenc.pack_codes_np(codes, length))


@pytest.mark.parametrize("probe_rows", [1, 2])
def test_bucket_table_queries(probe_rows):
    rng = np.random.default_rng(probe_rows)
    # duplicate-heavy keys force overflow (dropped or spilled entries),
    # and keys near 2^32 exercise the wrapping hash
    keys = np.concatenate([
        rng.integers(0, 2**32 - 1, 3000, dtype=np.uint64),
        np.repeat(rng.integers(2**31, 2**32 - 1, 40, dtype=np.uint64), 12),
    ]).astype(np.uint32)
    vals = rng.integers(0, 2**32, len(keys), dtype=np.uint64).astype(np.uint32)
    rows, bits = BucketTable.build_rows(keys, vals, entries=8, fields=2,
                                        probe_rows=probe_rows)
    jrows, jbits = JaxBucketTable.build_rows(keys, vals, entries=8, fields=2,
                                             probe_rows=probe_rows)
    np.testing.assert_array_equal(rows, jrows)
    assert bits == jbits
    jt = JaxBucketTable(rows=jnp.asarray(rows), bits=bits, entries=8,
                        fields=2, probe_rows=probe_rows)
    tt = BucketTable.from_rows(rows, bits, "cpu", entries=8, fields=2,
                               probe_rows=probe_rows)
    q = np.concatenate([[U32], keys[::7], rng.integers(0, 2**32, 500,
                                                       dtype=np.uint64)
                        .astype(np.uint32)]).astype(np.uint32)
    q = q[:len(q) // 4 * 4].reshape(-1, 4)       # [N, 4] queries
    jhit, jval = jt.lookup(jnp.asarray(q))
    thit, tval = tt.lookup(_t(q))
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(tval.numpy(),
                                  np.asarray(jval).astype(np.int64))
    assert np.asarray(jhit).any()
    jm, jv = jt.membership(jnp.asarray(q))
    tm, tv = tt.membership(_t(q))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("case", ["duplicates", "overflow", "empty_key",
                                  "random"])
def test_bucket_table_build_matches_jax(case):
    """BucketTable.build on the inputs of tests/test_bucket_table.py: the
    same rows as the JAX table's and the same lookups."""
    rng = np.random.default_rng(3)
    kw = {}
    if case == "duplicates":
        keys = np.asarray([7, 7, 7, 9, 9, 1234567], np.uint32)
        vals = np.asarray([10, 11, 12, 20, 21, 30], np.uint32)
        q = np.asarray([7, 9, 1234567, 42], np.uint32)
    elif case == "overflow":
        keys = np.full(20, 99, np.uint32)
        vals = np.arange(20, dtype=np.uint32)
        q = np.asarray([99], np.uint32)
        kw = dict(entries=4, probe_rows=1)
    elif case == "empty_key":
        keys = vals = np.asarray([1, 2, 3], np.uint32)
        q = np.asarray([U32, 1, 2, 3], np.uint32)
    else:
        keys = rng.integers(0, 2**32 - 1, 5000, dtype=np.uint64) \
            .astype(np.uint32)
        vals = np.arange(len(keys), dtype=np.uint32)
        q = np.concatenate([keys[::3], rng.integers(0, 2**32 - 1, 300,
                                                    dtype=np.uint64)
                            .astype(np.uint32)])
        kw = dict(entries=8, fields=2)
    jt = JaxBucketTable.build(keys, vals, **kw)
    tt = BucketTable.build(keys, vals, "cpu", **kw)
    assert (tt.bits, tt.entries, tt.fields, tt.probe_rows) \
        == (jt.bits, jt.entries, jt.fields, jt.probe_rows)
    np.testing.assert_array_equal(tt.rows.numpy().astype(np.uint32),
                                  np.asarray(jt.rows))
    jhit, jval = jt.lookup(jnp.asarray(q))
    thit, tval = tt.lookup(_t(q))
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(tval.numpy(),
                                  np.asarray(jval).astype(np.int64))
    if case == "overflow":
        assert thit.numpy().sum() == 4
    if case == "empty_key":
        assert not thit.numpy()[0].any()


def _adapter_reads(rng, B, L):
    """Reads with TSO prefixes (some mutated), polyA tails, both, Ns."""
    tso = np.frombuffer(TSO_SEQ, np.uint8)
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    mask = np.ones((B, L), bool)
    tso_codes = tenc.encode_seqs(tso)[0]
    for b in range(B):
        kind = b % 6
        if kind in (0, 2):                          # TSO at a random offset
            off = int(rng.integers(-10, 20))
            for j in range(len(tso_codes)):
                if 0 <= off + j < L:
                    reads[b, off + j] = tso_codes[j]
            if b % 12 == 0:
                reads[b, rng.integers(0, L, 3)] ^= 1
        if kind in (1, 2):                          # polyA tail
            reads[b, L - int(rng.integers(10, 40)):] = 0
        if kind == 3:
            mask[b, rng.integers(0, L, 8)] = False  # N bases
        if kind == 4:
            mask[b, int(rng.integers(L // 2, L)):] = False  # short read
    return reads, mask


@pytest.mark.parametrize("L", [91, 60])
def test_trimmer_matches_jax(L):
    rng = np.random.default_rng(L)
    reads, mask = _adapter_reads(rng, 240, L)
    want = jax_make_trimmer(L)(jnp.asarray(reads), jnp.asarray(mask))
    got = make_trimmer(L)(torch.from_numpy(reads), torch.from_numpy(mask))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(
            got[k].numpy(), np.asarray(want[k]).astype(got[k].numpy().dtype),
            err_msg=k)
    assert np.asarray(want["matched_tso"]).sum() > 40
    assert (np.asarray(want["polya_trimmed"]) > 0).sum() > 40


@pytest.mark.parametrize("size", [1, 5, 40, 200])
def test_compact_and_scatter_match_jax(size):
    rng = np.random.default_rng(size)
    B = 97
    mask = rng.random(B) < 0.3
    want = np.asarray(jnp.nonzero(jnp.asarray(mask), size=size,
                                  fill_value=B)[0])
    got = compact_indices(torch.from_numpy(mask), size, B)
    np.testing.assert_array_equal(got.numpy(), want)
    init = rng.integers(-50, 50, B).astype(np.int32)
    vals = rng.integers(100, 200, size).astype(np.int32)
    want_s = np.asarray(jnp.asarray(init).at[jnp.asarray(want)].set(
        jnp.asarray(vals), mode="drop"))
    got_s = scatter_drop(torch.from_numpy(init), got, torch.from_numpy(vals))
    np.testing.assert_array_equal(got_s.numpy(), want_s)


def test_lexsort_matches_multikey_sort():
    rng = np.random.default_rng(0)
    n = 5000
    # small key spaces (many ties) plus the 0xFFFFFFFF sentinel, which
    # must sort last
    cols = [rng.choice(np.array([0, 1, 2**31, 2**32 - 2, U32], np.uint64), n)
            .astype(np.uint32) for _ in range(4)]
    for k in (1, 2, 3, 4):
        keys = cols[:k]
        perm = lexsort(*(_t(c) for c in keys)).numpy()
        want = np.lexsort(tuple(reversed(keys)))   # stable too
        np.testing.assert_array_equal(perm, want)
        jsorted = jax.lax.sort(tuple(jnp.asarray(c) for c in keys),
                               num_keys=k)
        for c, js in zip(keys, jsorted):
            np.testing.assert_array_equal(c[perm], np.asarray(js))


def test_stable_descending_sort_is_top_k_order():
    """lax.top_k breaks ties to the lower index; torch.topk does not
    promise that, so the aligner takes a stable descending sort."""
    rng = np.random.default_rng(1)
    votes = rng.integers(0, 4, (512, 48)).astype(np.int32)
    jv, ji = jax.lax.top_k(jnp.asarray(votes), 3)
    tv, ti = torch.sort(torch.from_numpy(votes), stable=True, dim=1,
                        descending=True)
    np.testing.assert_array_equal(tv[:, :3].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti[:, :3].numpy(), np.asarray(ji))
