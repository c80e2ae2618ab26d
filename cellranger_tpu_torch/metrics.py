"""Mergeable metrics algebra — the `metric` crate analog
(lib/rust/metric/src/lib.rs:197 `trait Metric`, SimpleHistogram,
CountMetric, PercentMetric, MeanMetric, JsonReporter :367).

The reference's stages emit per-chunk metric structs whose join() merges
them as monoids; here per-batch/per-chip metrics merge the same way, and
the device-side representation is a flat int array so a mesh `psum` IS the
merge (parallel/mesh.py psums the scalar dict; histograms merge host-side
or as fixed-width device bincounts).

Verbatim copy of cellranger_tpu/metrics.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, is_dataclass

import numpy as np


class CountMetric:
    """Additive counter (metric/src/lib.rs CountMetric)."""

    __slots__ = ("count",)

    def __init__(self, count: int = 0):
        self.count = int(count)

    def increment(self, n: int = 1):
        self.count += int(n)

    def merge(self, other: "CountMetric"):
        self.count += other.count
        return self

    def report(self):
        return self.count

    def __eq__(self, o):
        return isinstance(o, CountMetric) and o.count == self.count

    def __repr__(self):
        return f"CountMetric({self.count})"


class MeanMetric:
    """Streaming mean as (total, weight) — exact under merge."""

    __slots__ = ("total", "weight")

    def __init__(self, total: float = 0.0, weight: float = 0.0):
        self.total = float(total)
        self.weight = float(weight)

    def record(self, value: float, weight: float = 1.0):
        self.total += value * weight
        self.weight += weight

    def merge(self, other: "MeanMetric"):
        self.total += other.total
        self.weight += other.weight
        return self

    def report(self):
        return self.total / self.weight if self.weight else 0.0


class PercentMetric:
    """Numerator/denominator pair (metric PercentMetric): fraction under
    report, exact integer algebra under merge."""

    __slots__ = ("numerator", "denominator")

    def __init__(self, numerator: int = 0, denominator: int = 0):
        self.numerator = int(numerator)
        self.denominator = int(denominator)

    def increment(self, hit: bool):
        self.numerator += bool(hit)
        self.denominator += 1

    def add(self, num: int, den: int):
        self.numerator += int(num)
        self.denominator += int(den)

    def merge(self, other: "PercentMetric"):
        self.numerator += other.numerator
        self.denominator += other.denominator
        return self

    def report(self):
        return self.numerator / self.denominator if self.denominator else 0.0


class SimpleHistogram:
    """Sparse key -> count histogram (metric SimpleHistogram). Merge is a
    key-wise sum; supports vectorized observation from numpy arrays."""

    __slots__ = ("counts",)

    def __init__(self, counts: dict | None = None):
        self.counts: dict = dict(counts) if counts else {}

    def observe(self, key, n: int = 1):
        self.counts[key] = self.counts.get(key, 0) + int(n)

    def observe_array(self, keys: np.ndarray, weights: np.ndarray | None = None):
        u, inv = np.unique(np.asarray(keys), return_inverse=True)
        w = (np.bincount(inv, weights=None if weights is None
                         else np.asarray(weights, np.float64),
                         minlength=len(u)))
        for k, c in zip(u.tolist(), w.tolist()):
            self.counts[k] = self.counts.get(k, 0) + int(c)

    def merge(self, other: "SimpleHistogram"):
        for k, c in other.counts.items():
            self.counts[k] = self.counts.get(k, 0) + c
        return self

    def report(self):
        return {k: self.counts[k] for k in sorted(self.counts)}

    def total(self):
        return sum(self.counts.values())

    def quantile(self, q: float):
        """Weighted quantile over keys (keys must be numeric)."""
        if not self.counts:
            return 0
        ks = np.array(sorted(self.counts))
        ws = np.array([self.counts[k] for k in ks], np.float64)
        cum = np.cumsum(ws)
        return ks[np.searchsorted(cum, q * cum[-1], side="left").clip(0, len(ks) - 1)]


METRIC_TYPES = (CountMetric, MeanMetric, PercentMetric, SimpleHistogram)


def merge_metrics(a, b):
    """Merge two metric values / dicts / dataclasses of metrics (the
    #[derive(Metric)] analog: field-wise monoid merge). ints/floats add;
    Metric objects merge; dicts/dataclasses recurse. Returns the merged a."""
    if isinstance(a, METRIC_TYPES):
        return a.merge(b)
    if isinstance(a, dict):
        for k, v in b.items():
            a[k] = merge_metrics(a[k], v) if k in a else v
        return a
    if is_dataclass(a):
        for f in fields(a):
            setattr(a, f.name,
                    merge_metrics(getattr(a, f.name), getattr(b, f.name)))
        return a
    if isinstance(a, (int, float, np.integer, np.floating)):
        return a + b
    raise TypeError(f"not a mergeable metric: {type(a)}")


def report_metrics(m, prefix: str = "") -> dict:
    """Flatten metrics into a {name: value} JSON-ready dict — the
    JsonReporter analog (metric/src/lib.rs:367)."""
    out = {}
    if isinstance(m, METRIC_TYPES):
        out[prefix.rstrip("_")] = m.report()
    elif isinstance(m, dict):
        for k, v in m.items():
            out.update(report_metrics(v, f"{prefix}{k}_"))
    elif is_dataclass(m):
        for f in fields(m):
            out.update(report_metrics(getattr(m, f.name), f"{prefix}{f.name}_"))
    else:
        out[prefix.rstrip("_")] = m
    return out
