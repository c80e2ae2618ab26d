"""RTL probe set CSV parsing (the ProbeSetReference input,
lib/rust/cr_types/src/probe_set.rs:423-426: '#key=value' metadata headers,
then gene_id,probe_seq,probe_id,included,region rows; all probe sequences
share one length).

Verbatim copy of cellranger_tpu/io/probe_set.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass, field

import numpy as np

from ..ops import encode


@dataclass
class ProbeSet:
    metadata: dict
    probe_ids: list[str]
    gene_ids: list[str]          # per probe
    sequences: list[str]         # per probe
    included: np.ndarray         # bool per probe
    regions: list[str]
    probe_len: int

    # derived
    genes: list[str] = field(default_factory=list)       # distinct, ordered
    probe_gene_idx: np.ndarray | None = None

    @staticmethod
    def from_csv(path: str) -> "ProbeSet":
        metadata = {}
        rows = []
        with open(path) as f:
            header = None
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("#"):
                    if "=" in line:
                        k, v = line[1:].split("=", 1)
                        metadata[k.strip()] = v.strip()
                    continue
                parts = [p.strip() for p in line.split(",")]
                if header is None:
                    header = parts
                    required = {"gene_id", "probe_seq", "probe_id"}
                    if not required <= set(header):
                        raise ValueError(
                            f"probe set CSV needs columns {sorted(required)}")
                    continue
                rows.append(dict(zip(header, parts)))
        if not rows:
            raise ValueError("probe set CSV has no probes")
        seqs = [r["probe_seq"].upper() for r in rows]
        plen = len(seqs[0])
        if any(len(s) != plen for s in seqs):
            raise ValueError("all probe sequences must share one length")
        ps = ProbeSet(
            metadata=metadata,
            probe_ids=[r["probe_id"] for r in rows],
            gene_ids=[r["gene_id"] for r in rows],
            sequences=seqs,
            included=np.asarray(
                [r.get("included", "TRUE").upper() != "FALSE" for r in rows]),
            regions=[r.get("region", "") for r in rows],
            probe_len=plen,
        )
        seen = {}
        gidx = []
        for g in ps.gene_ids:
            if g not in seen:
                seen[g] = len(seen)
                ps.genes.append(g)
            gidx.append(seen[g])
        ps.probe_gene_idx = np.asarray(gidx, np.int32)
        return ps

    def half_tables(self):
        """((lhs_hi, lhs_lo, probe_idx) sorted, (rhs...)) packed half-seq
        tables. Halves longer than 16bp split into two u32 keys (hi = first
        half of the half, lo = rest), lexicographic over (hi, lo)."""
        half = self.probe_len // 2
        rhs_start = (self.probe_len + 1) // 2

        def build(get):
            his, los = [], []
            for s in self.sequences:
                hseq = get(s)
                codes, valid = encode.encode_str(hseq)
                if not valid.all():
                    raise ValueError(f"non-ACGT base in probe: {hseq}")
                hi_len = min(len(codes), 16)
                his.append(encode.pack_codes_np(codes[:hi_len], hi_len))
                lo = codes[hi_len:]
                los.append(encode.pack_codes_np(lo, len(lo)) if len(lo) else 0)
            his = np.asarray(his, np.uint32)
            los = np.asarray(los, np.uint32)
            order = np.lexsort((np.arange(len(his)), los, his))
            return his[order], los[order], order.astype(np.int32)

        lhs = build(lambda s: s[:half])
        rhs = build(lambda s: s[rhs_start:])
        return lhs, rhs, half, rhs_start
