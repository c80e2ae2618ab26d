"""Port parity for the cross-device barcode shuffle dedup:
cellranger_tpu_torch.parallel.shuffle.make_sharded_dedup against the JAX
package's (its all_to_all under shard_map on the 8 virtual CPU devices of
tests/conftest.py), on the inputs of tests/test_shuffle.py: every per-
device output array equal, n_molecules and overflow included, with a
slack that fits and with one that overflows.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cellranger_tpu.ops.dedup import dedup_molecules as jax_dedup
from cellranger_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cellranger_tpu.parallel.shuffle import (
    make_sharded_dedup as jax_make_sharded_dedup)
from cellranger_tpu_torch.parallel.mesh import make_mesh, split
from cellranger_tpu_torch.parallel.shuffle import make_sharded_dedup

N_DEV = 8
UMI_LEN = 6


def _inputs(case):
    """tests/test_shuffle.py's two cases: 3,000 valid rows over 40
    barcodes with forced 1-HD UMI collisions (slack 8), and every row of
    one barcode (slack 1: one destination bucket overflows)."""
    if case == "fits":
        rng = np.random.default_rng(42)
        per_chip = 512
        N = N_DEV * per_chip
        bc = rng.integers(0, 40, N).astype(np.uint32)
        gene = rng.integers(0, 5, N).astype(np.uint32)
        umi = (rng.integers(0, 1 << (2 * UMI_LEN), N).astype(np.uint32)
               & np.uint32(0b110011001100))
        valid = np.zeros(N, bool)
        valid[:3000] = True
        return per_chip, 8.0, (bc, gene, umi, valid)
    rng = np.random.default_rng(1)
    per_chip = 256
    N = N_DEV * per_chip
    umi = rng.integers(0, 1 << 12, N).astype(np.uint32)
    return per_chip, 1.0, (np.zeros(N, np.uint32), np.zeros(N, np.uint32),
                           umi, np.ones(N, bool))


def _molecules(dd):
    v = np.asarray(dd["mol_valid"]).astype(bool)
    return {(int(b), int(g), int(u)): int(r) for b, g, u, r in zip(
        *(np.asarray(dd[k])[v] for k in ("mol_bc", "mol_gene", "mol_umi",
                                         "mol_reads")))}


@pytest.mark.parametrize("case", ["fits", "overflow"])
def test_sharded_dedup_matches_jax(case):
    per_chip, slack, (bc, gene, umi, valid) = _inputs(case)
    jdd = jax_make_sharded_dedup(jax_make_mesh(N_DEV), per_chip, UMI_LEN,
                                 slack=slack)(
        jnp.asarray(bc), jnp.asarray(gene), jnp.asarray(umi),
        jnp.asarray(valid))
    mesh = make_mesh(devices=["cpu"] * N_DEV)
    tdd = make_sharded_dedup(mesh, per_chip, UMI_LEN, slack=slack)(
        *(split(mesh, a.astype(np.int64)) for a in (bc, gene, umi)),
        split(mesh, valid))
    assert set(tdd) == set(jdd)
    for k in sorted(jdd):
        want = np.asarray(jdd[k])
        got = tdd[k].numpy()
        assert got.shape == want.shape, k
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=k)
    overflow = int(tdd["overflow"].sum())
    if case == "fits":
        assert overflow == 0
        single = jax_dedup(jnp.asarray(bc), jnp.asarray(gene),
                           jnp.asarray(umi), jnp.asarray(valid), UMI_LEN)
        assert _molecules(tdd) == _molecules(single)
        assert int(tdd["n_molecules"].sum()) == len(_molecules(single))
    else:
        assert overflow > 0
