"""Barnyard (multi-genome) GEM classification — the multigenome.py analog
(lib/python/cellranger/analysis/multigenome.py): per called cell, sum UMIs
per genome; the GEM is assigned to its dominant genome unless the minor
genome carries enough signal, in which case it is a Multiplet. Observed
multiplet counts are doubled for the inferred rate (same-genome doublets
are unobservable — the standard barnyard correction).

Verbatim copy of cellranger_tpu/analysis/multigenome.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import numpy as np

MULTIPLET_MIN_COUNTS = 10   # analysis/constants.py:48 DEFAULT_MULTIPLET_THRESHOLD
MULTIPLET_MIN_FRAC = 0.10


def classify_gems(counts_per_genome: np.ndarray, genomes: list[str]):
    """counts_per_genome: [cells, n_genomes] UMI sums. Returns (calls
    list[str], summary dict)."""
    n, g = counts_per_genome.shape
    order = np.argsort(-counts_per_genome, axis=1)
    top = order[:, 0]
    calls = []
    for i in range(n):
        c = counts_per_genome[i]
        major = int(top[i])
        minor = int(order[i, 1]) if g > 1 else major
        total = c.sum()
        if (g > 1 and c[minor] >= MULTIPLET_MIN_COUNTS
                and total > 0 and c[minor] / total >= MULTIPLET_MIN_FRAC):
            calls.append("Multiplet")
        else:
            calls.append(genomes[major])
    observed = sum(1 for c in calls if c == "Multiplet")
    per_genome = {gn: sum(1 for c in calls if c == gn) for gn in genomes}
    # purity: mean major-genome fraction among single-genome calls
    purities = []
    for i in range(n):
        if calls[i] != "Multiplet" and counts_per_genome[i].sum() > 0:
            purities.append(counts_per_genome[i, top[i]]
                            / counts_per_genome[i].sum())
    summary = dict(
        observed_multiplets=observed,
        observed_multiplet_rate=observed / max(n, 1),
        inferred_multiplet_rate=min(1.0, 2 * observed / max(n, 1)),
        cells_per_genome=per_genome,
        mean_purity=float(np.mean(purities)) if purities else 1.0,
    )
    return calls, summary
