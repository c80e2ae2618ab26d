"""Port parity: UMI dedup and the device molecule state of
cellranger_tpu_torch against the JAX package (ops/dedup.py,
parallel/executor.py MoleculeState with its host flush, and
Executor(None).dedup_partitions) and against the plain-python mark_dups.rs
oracle in tests/ref_dedup.py.  Tolerance 0.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cellranger_tpu.ops.dedup import dedup_molecules as jax_dedup
from cellranger_tpu.ops.dedup import exact_merge as jax_exact_merge
from cellranger_tpu.ops.dedup import lex3_search as jax_lex3_search
from cellranger_tpu.parallel.executor import Executor as JaxExecutor
from cellranger_tpu.parallel.executor import MoleculeState as JaxMoleculeState
from cellranger_tpu_torch.ops.dedup import (dedup_molecules, exact_merge,
                                            lex3_search)
from cellranger_tpu_torch.parallel.molecule_state import (MoleculeState,
                                                          dedup_partitions)

from ref_dedup import dedup_spec

UMI_LEN = 12


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _rows(rng, n, n_bc=6, n_gene=4, umi_space=None):
    """Reads from a small key space: duplicate triples, 1-Hamming UMI
    neighbours (correction), and one UMI under several genes (low
    support)."""
    bc = rng.integers(0, n_bc, n).astype(np.uint32)
    gene = rng.integers(0, n_gene, n).astype(np.uint32)
    if umi_space is None:
        base = rng.integers(0, 1 << 24, 6).astype(np.uint32)
        umi = base[rng.integers(0, len(base), n)]
        flip = rng.random(n) < 0.3          # 1-base UMI errors
        pos = rng.integers(0, UMI_LEN, n).astype(np.uint32)
        d = rng.integers(1, 4, n).astype(np.uint32)
        umi = np.where(flip, umi ^ (d << (2 * (UMI_LEN - 1 - pos))), umi)
    else:
        umi = rng.integers(0, umi_space, n).astype(np.uint32)
    return bc, gene, umi.astype(np.uint32)


@pytest.mark.parametrize("seed,weighted", [(0, False), (1, False),
                                           (2, True), (3, True)])
def test_dedup_matches_jax_and_oracle(seed, weighted):
    rng = np.random.default_rng(seed)
    N = 1024
    bc, gene, umi = _rows(rng, 900)
    valid = np.zeros(N, bool)
    valid[:900] = True
    pad = lambda a: np.pad(a, (0, N - len(a)))  # noqa: E731
    reads = (rng.integers(1, 5, N).astype(np.uint32) if weighted else None)
    want = jax_dedup(jnp.asarray(pad(bc)), jnp.asarray(pad(gene)),
                     jnp.asarray(pad(umi)), jnp.asarray(valid), UMI_LEN,
                     reads=None if reads is None else jnp.asarray(reads))
    got = dedup_molecules(_t(pad(bc)), _t(pad(gene)), _t(pad(umi)),
                          torch.from_numpy(valid), UMI_LEN,
                          reads=None if reads is None else _t(reads))
    assert set(got) == set(want)
    for k in sorted(want):
        np.testing.assert_array_equal(
            got[k].numpy().astype(np.int64),
            np.asarray(want[k]).astype(np.int64), err_msg=k)
    if reads is None:
        mols, low = dedup_spec(zip(bc.tolist(), gene.tolist(), umi.tolist()),
                               UMI_LEN)
        mv = got["mol_valid"].numpy()
        tab = {(b, g, u): r for b, g, u, r in zip(
            got["mol_bc"].numpy()[mv].tolist(),
            got["mol_gene"].numpy()[mv].tolist(),
            got["mol_umi"].numpy()[mv].tolist(),
            got["mol_reads"].numpy()[mv].tolist())}
        assert tab == {k: v for k, v in mols.items() if k not in low}
        assert low, "the fixture exercises low-support marking"
    assert (got["raw_corr_umi"] != got["raw_umi"]).any()


def test_exact_merge_matches_jax():
    rng = np.random.default_rng(4)
    C, n = 2048, 1500
    bc, gene, umi = _rows(rng, C, umi_space=40)
    rows = np.stack([bc, gene, umi,
                     rng.integers(1, 9, C).astype(np.uint32)], 1)
    want_rows, want_n = jax_exact_merge(jnp.asarray(rows), jnp.int32(n))
    got_rows, got_n = exact_merge(_t(rows), n)
    assert int(got_n) == int(want_n)
    np.testing.assert_array_equal(got_rows.numpy(),
                                  np.asarray(want_rows).astype(np.int64))


def test_lex3_search_matches_jax():
    rng = np.random.default_rng(5)
    k = np.stack(_rows(rng, 700, umi_space=30), 1)
    k = np.unique(k, axis=0)                   # sorted lexicographically
    q = np.concatenate([k[::3], np.stack(_rows(rng, 200, umi_space=40), 1)])
    want = jax_lex3_search(*(jnp.asarray(k[:, i]) for i in range(3)),
                           *(jnp.asarray(q[:, i]) for i in range(3)))
    got = lex3_search(*(_t(k[:, i]) for i in range(3)),
                      *(_t(q[:, i]) for i in range(3)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].numpy().any() and not got[1].numpy().all()


def _drain(rng, n_rows, cap, umi_space=9):
    bc, gene, umi = _rows(rng, n_rows, n_bc=7, n_gene=5, umi_space=umi_space)
    mol = np.full((cap, 3), 0xFFFFFFFF, np.uint32)
    mol[:n_rows] = np.stack([bc, gene, umi], 1)
    return mol, n_rows


@pytest.mark.parametrize("max_cap", [1 << 14, 1 << 12])
def test_molecule_state_matches_jax(max_cap):
    """Append-only absorbs with loose bounds; the small cap forces the
    merge-on-pressure path."""
    rng = np.random.default_rng(max_cap)
    jst = JaxMoleculeState(max_cap, UMI_LEN, min_capacity=1024)
    tst = MoleculeState(max_cap, UMI_LEN, "cpu", min_capacity=1024)
    for _ in range(8):
        mol, n = _drain(rng, 900, 1024)
        jst.absorb(jnp.asarray(mol), jnp.int32(n), upper=1024)
        tst.absorb(_t(mol), torch.tensor(n), upper=1024)
        assert tst.n == jst.n and tst.cap == jst.cap
    assert not jst.flushed
    want = [np.asarray(a) for a in jst.finalize()]
    got = tst.finalize()
    o_w = np.lexsort((want[2], want[1], want[0]))
    o_g = np.lexsort((got[2], got[1], got[0]))
    for w, g in zip(want, got):
        assert g.dtype == np.uint32
        np.testing.assert_array_equal(g[o_g], w[o_w])


def _flushing_states(max_cap, seed=7, drains=6):
    """JAX and port states fed the same drains; max_cap small enough that
    the distinct triples overflow it and flush to the host."""
    rng = np.random.default_rng(seed)
    jst = JaxMoleculeState(max_cap, UMI_LEN, min_capacity=1024)
    tst = MoleculeState(max_cap, UMI_LEN, "cpu", min_capacity=1024)
    big = MoleculeState(1 << 16, UMI_LEN, "cpu", min_capacity=1024)
    for _ in range(drains):
        mol, n = _drain(rng, 1000, 1024, umi_space=1 << 20)
        jst.absorb(jnp.asarray(mol), jnp.int32(n), upper=1024)
        for st in (tst, big):
            st.absorb(_t(mol), torch.tensor(n), upper=1024)
    return jst, tst, big


def test_molecule_state_overflow_is_not_ported():
    """The overflow past max_capacity (formerly NotImplementedError) now
    flushes the merged state to the host, as the JAX package does: the
    flushed rows are the JAX state's, reads-weighted."""
    jst, tst, _big = _flushing_states(1 << 11)
    assert jst.flushed and tst.flushed
    assert len(tst.flushed) == len(jst.flushed)
    for g, w in zip(tst.flushed, jst.flushed):
        np.testing.assert_array_equal(g, np.asarray(w))
    want = jst.finalize()
    got = tst.finalize()
    for g, w in zip(got, want):
        assert g.dtype == np.uint32
        np.testing.assert_array_equal(g, np.asarray(w))


def test_flushed_state_dedups_to_the_unflushed_molecules():
    """Flushed rows through dedup_partitions give the molecules of a
    state that never flushed, and the JAX package's."""
    jst, tst, big = _flushing_states(1 << 11, seed=8)
    rows = tst.finalize()
    jrows = [np.asarray(a) for a in jst.finalize()]
    got = list(dedup_partitions([rows], UMI_LEN, "cpu", keep_raw=False))
    want = list(JaxExecutor(None).dedup_partitions([tuple(jrows)], UMI_LEN,
                                                   keep_raw=False))
    assert not big.flushed
    ref = big.finalize()
    g = {k: np.concatenate([d[k] for d in got]) for k in got[0]}
    w = {k: np.concatenate([d[k] for d in want]) for k in want[0]}
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    o = np.lexsort((ref[2], ref[1], ref[0]))
    for k, r in zip(("mol_bc", "mol_gene", "mol_umi", "mol_reads"), ref):
        np.testing.assert_array_equal(g[k], r[o], err_msg=k)


@pytest.mark.parametrize("keep_raw,weighted", [(True, False), (False, False),
                                               (True, True)])
def test_dedup_partitions_matches_jax(keep_raw, weighted):
    """Barcode-disjoint partitions, coalesced into several device calls
    (small chunk_limit), against Executor(None).dedup_partitions."""
    rng = np.random.default_rng(11 + weighted)
    bc, gene, umi = _rows(rng, 3000, n_bc=9, n_gene=4)
    parts = []
    for p in range(4):
        m = bc % 4 == p
        part = (bc[m], gene[m], umi[m])
        if weighted:
            part += (rng.integers(1, 5, m.sum()).astype(np.uint32),)
        parts.append(part)
    want = list(JaxExecutor(None).dedup_partitions(
        parts, UMI_LEN, chunk_limit=1000, keep_raw=keep_raw))
    got = list(dedup_partitions(parts, UMI_LEN, "cpu", chunk_limit=1000,
                                keep_raw=keep_raw))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    if keep_raw:
        assert any((g["raw_corr_umi"] != g["raw_umi"]).any() for g in got)
        assert any(g["raw_low"].any() for g in got)


def test_run_count_overflow_matches_jax(tmp_path, monkeypatch):
    """A count-only run whose molecule state overflows (cap lowered to
    1024 rows) takes the host flush + partition dedup and still equals
    the JAX package's run, which never overflows here."""
    from cellranger_tpu_torch.pipeline import count as tcount
    from cellranger_tpu_torch.parallel import molecule_state
    from cellranger_tpu_torch.testing.fixtures import build_synthetic_run
    from test_torch_count import _run_both

    calls = []
    real = molecule_state.MoleculeState.flush_to_host

    def counted(self):
        calls.append(self.n)
        return real(self)

    monkeypatch.setattr(tcount, "MOLECULE_STATE_CAP", 1024)
    monkeypatch.setattr(molecule_state.MoleculeState, "flush_to_host",
                        counted)
    fx = build_synthetic_run(str(tmp_path / "fx"), n_cells=20)
    s = _run_both(tmp_path, fx["fq1"], fx["fq2"], fx["ref"], fx["wl"], 256)
    assert calls, "the overflow path did not run"
    assert s["total_molecules"] == int(fx["truth"].sum())
