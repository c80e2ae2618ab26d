"""Read-depth subsampling metrics — the SUBSAMPLE_READS stage analog
(mro/rna/_slfe_cells_reporter.mro:61; lib/python/cellranger/subsample.py:430).

The reference subsamples usable reads at fixed rates and reports
sequencing saturation and median genes per cell at each depth (the web
summary's saturation / genes-per-cell curves). Operating on the deduped
molecule table makes this exact and cheap: a molecule with k reads
survives rate r with its read count thinned binomially (seeded RNG, as the
reference pins np.random seeds for reproducibility).

Verbatim copy of cellranger_tpu/analysis/subsample.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import numpy as np

DEFAULT_RATES = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)


def compute_target_depths(max_target: float, num_targets: int) -> np.ndarray:
    """Sorted distinct nonzero integer subsampling depths up to max_target
    (subsample.py:140-159): num_targets+1 linspace points from 0, unique,
    zeros dropped."""
    distinct = np.unique(np.linspace(0, max_target, num_targets + 1,
                                     dtype=int))
    return distinct[distinct > 0]


def subsample_metrics(mol_bc: np.ndarray, mol_gene: np.ndarray,
                      mol_reads: np.ndarray, cell_bc_idx: np.ndarray,
                      rates=DEFAULT_RATES, seed: int = 0) -> dict:
    """-> {rate: {subsampled_reads, saturation, median_genes_per_cell,
    median_umis_per_cell}} plus flat key/value entries for the summary."""
    mol_bc = np.asarray(mol_bc, np.int64)
    mol_gene = np.asarray(mol_gene, np.int64)
    mol_reads = np.asarray(mol_reads, np.int64)
    cell_set = np.zeros(int(mol_bc.max()) + 2 if len(mol_bc) else 1, bool)
    cell_bc_idx = np.asarray(cell_bc_idx, np.int64)
    if len(cell_bc_idx):
        cell_set[cell_bc_idx] = True
    in_cell = cell_set[mol_bc] if len(mol_bc) else np.zeros(0, bool)

    out: dict = {"curves": {}}
    for r in rates:
        if r >= 1.0:
            surv = mol_reads
        else:
            # REFERENCE-IDENTICAL sampling (subsample.py:592,614
            # _run_subsample_task): each task reseeds MT19937(1) and draws
            # one binomial per molecule in file order, so the survival
            # vector — and every downstream metric — matches the
            # reference bit-for-bit on the same molecule table
            # (oracle-checked in tests/test_oracle_conformance.py)
            rs = np.random.RandomState(1)
            surv = rs.binomial(mol_reads, np.full(len(mol_reads), r))
        obs = surv > 0
        n_reads = int(surv.sum())
        n_mol = int(obs.sum())
        sat = 1.0 - n_mol / n_reads if n_reads else 0.0

        oc = obs & in_cell
        med_genes = med_umis = 0.0
        if oc.any() and len(cell_bc_idx):
            bcs, genes = mol_bc[oc], mol_gene[oc]
            # distinct (bc, gene) pairs via packed int64 keys —
            # np.unique(axis=0) row-sorts and was ~2.3s of a 1M-read e2e
            # reporting phase; the packed 1-D unique is ~50x faster and
            # identical (gene indices fit 2^31)
            pair_k = np.unique((bcs << 31) | genes)
            gpc = np.bincount(pair_k >> 31,
                              minlength=len(cell_set))[cell_bc_idx]
            upc = np.bincount(bcs, minlength=len(cell_set))[cell_bc_idx]
            med_genes = float(np.median(gpc))
            med_umis = float(np.median(upc))
        out["curves"][float(r)] = dict(
            subsampled_reads=n_reads, saturation=sat,
            median_genes_per_cell=med_genes, median_umis_per_cell=med_umis)
        key = f"{int(round(r * 100))}pct"
        out[f"subsampled_saturation_{key}"] = sat
        out[f"subsampled_median_genes_per_cell_{key}"] = med_genes
    return out
