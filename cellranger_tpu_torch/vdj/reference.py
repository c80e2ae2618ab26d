"""V(D)J segment reference (the vdj_reference crate analog).

Parses the 10x-style regions.fa where each header carries pipe-separated
metadata: >id|display_name record_id|gene_name|region_type|chain_type|chain|
isotype|allele (lib/rust/vdj_reference/src/lib.rs). We need id, gene name,
region type (L-REGION+V-REGION / D-REGION / J-REGION / C-REGION / 5'UTR)
and chain (TRA/TRB/IGH/IGK/IGL...).

Verbatim copy of cellranger_tpu/vdj/reference.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..io.gtf import read_fasta


@dataclass
class Segment:
    id: str
    gene_name: str
    region: str      # V | D | J | C | UTR
    chain: str       # TRA, TRB, IGH, ...
    seq: bytes


REGION_MAP = {
    "L-REGION+V-REGION": "V",
    "V-REGION": "V",
    "D-REGION": "D",
    "J-REGION": "J",
    "C-REGION": "C",
    "5'UTR": "UTR",
}


@dataclass
class VdjReference:
    segments: list[Segment]

    def by_region(self, region: str) -> list[Segment]:
        return [s for s in self.segments if s.region == region]

    @staticmethod
    def from_fasta(path: str) -> "VdjReference":
        seqs = read_fasta(path)
        segments = []
        for header, seq in seqs.items():
            parts = header.split("|")
            if len(parts) >= 6:
                gene = parts[3] if len(parts) > 3 else parts[1]
                region = REGION_MAP.get(parts[4], parts[4])
                chain = parts[5] if len(parts) > 5 else ""
            else:
                # simple headers: "name region chain" is also accepted
                sub = header.split()
                gene = sub[0]
                region = sub[1] if len(sub) > 1 else "V"
                chain = sub[2] if len(sub) > 2 else ""
            segments.append(Segment(header.split("|")[0], gene, region,
                                    chain, seq))
        return VdjReference(segments)
