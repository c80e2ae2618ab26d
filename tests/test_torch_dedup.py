"""Port parity: UMI dedup and the device molecule state of
cellranger_tpu_torch against the JAX package (ops/dedup.py,
parallel/executor.py MoleculeState) and against the plain-python
mark_dups.rs oracle in tests/ref_dedup.py.  Tolerance 0.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cellranger_tpu.ops.dedup import dedup_molecules as jax_dedup
from cellranger_tpu.ops.dedup import exact_merge as jax_exact_merge
from cellranger_tpu.ops.dedup import lex3_search as jax_lex3_search
from cellranger_tpu.parallel.executor import MoleculeState as JaxMoleculeState
from cellranger_tpu_torch.ops.dedup import (dedup_molecules, exact_merge,
                                            lex3_search)
from cellranger_tpu_torch.parallel.molecule_state import MoleculeState

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


def test_molecule_state_overflow_is_not_ported():
    rng = np.random.default_rng(7)
    st = MoleculeState(1 << 11, UMI_LEN, "cpu", min_capacity=1024)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        for _ in range(6):
            mol, n = _drain(rng, 1000, 1024, umi_space=1 << 20)
            st.absorb(_t(mol), torch.tensor(n), upper=1024)
