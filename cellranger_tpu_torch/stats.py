"""Small statistics utilities (the `stats` crate analog,
lib/rust/stats/src/nx.rs:6 + reservoir_sampling.rs:21).

`nx` computes N50-style length statistics (the smallest length L such
that pieces >= L cover at least x% of the total); `reservoir_sample`
draws a uniform fixed-size sample from a stream in one pass with a
seeded generator so results are reproducible.

Verbatim copy of cellranger_tpu/stats.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

from typing import Iterable, Iterator, TypeVar

import numpy as np

T = TypeVar("T")


def nx(lengths, x: float = 0.5) -> int:
    """N{x}: with x=0.5 this is N50 — the length L such that pieces of
    length >= L together span >= x of the total span. 0 for empty."""
    if not 0.0 < x <= 1.0:
        raise ValueError(f"x must be in (0, 1], got {x}")
    a = np.sort(np.asarray(list(lengths), dtype=np.int64))[::-1]
    if a.size == 0 or a.sum() == 0:
        return 0
    cum = np.cumsum(a)
    return int(a[np.searchsorted(cum, x * cum[-1])])


def n50(lengths) -> int:
    return nx(lengths, 0.5)


def reservoir_sample(stream: Iterable[T], k: int, seed: int = 0) -> list[T]:
    """Uniform k-sample from a stream of unknown length (Algorithm R),
    single pass, O(k) memory, deterministic under `seed`."""
    rng = np.random.default_rng(seed)
    out: list[T] = []
    for i, item in enumerate(stream):
        if i < k:
            out.append(item)
        else:
            j = int(rng.integers(0, i + 1))
            if j < k:
                out[j] = item
    return out
