"""Contig annotation: V/J segment hits, CDR3, productivity, clonotypes
(the vdj_ann + enclone_ranger role, simplified: kmer-prefiltered local
alignment against the segment reference, CDR3 between the conserved V-end
cysteine codon and the J FGXG/WGXG motif, productive = in-frame + no stop).

Verbatim copy of cellranger_tpu/vdj/annotate.py: the port keeps its own copy of
every jax-free module it needs and imports nothing of that package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .reference import Segment, VdjReference

KSEED = 16
CODON = {
    "TTT": "F", "TTC": "F", "TTA": "L", "TTG": "L", "CTT": "L", "CTC": "L",
    "CTA": "L", "CTG": "L", "ATT": "I", "ATC": "I", "ATA": "I", "ATG": "M",
    "GTT": "V", "GTC": "V", "GTA": "V", "GTG": "V", "TCT": "S", "TCC": "S",
    "TCA": "S", "TCG": "S", "CCT": "P", "CCC": "P", "CCA": "P", "CCG": "P",
    "ACT": "T", "ACC": "T", "ACA": "T", "ACG": "T", "GCT": "A", "GCC": "A",
    "GCA": "A", "GCG": "A", "TAT": "Y", "TAC": "Y", "TAA": "*", "TAG": "*",
    "CAT": "H", "CAC": "H", "CAA": "Q", "CAG": "Q", "AAT": "N", "AAC": "N",
    "AAA": "K", "AAG": "K", "GAT": "D", "GAC": "D", "GAA": "E", "GAG": "E",
    "TGT": "C", "TGC": "C", "TGA": "*", "TGG": "W", "CGT": "R", "CGC": "R",
    "CGA": "R", "CGG": "R", "AGT": "S", "AGC": "S", "AGA": "R", "AGG": "R",
    "GGT": "G", "GGC": "G", "GGA": "G", "GGG": "G",
}


def translate(nt: str) -> str:
    return "".join(CODON.get(nt[i:i + 3], "X")
                   for i in range(0, len(nt) - 2, 3))


def _kmers(s: str, k: int = KSEED):
    return {s[i:i + k] for i in range(len(s) - k + 1)}


def local_align(a: str, b: str, match=2, mismatch=-2, gap=-3):
    """Small host Smith-Waterman; returns (score, a_start, a_end, b_start,
    b_end)."""
    n, m = len(a), len(b)
    H = np.zeros((n + 1, m + 1), np.int32)
    best = (0, 0, 0)
    for i in range(1, n + 1):
        ai = a[i - 1]
        row = H[i]
        prev = H[i - 1]
        for j in range(1, m + 1):
            s = match if ai == b[j - 1] else mismatch
            v = max(0, prev[j - 1] + s, prev[j] + gap, row[j - 1] + gap)
            row[j] = v
            if v > best[0]:
                best = (v, i, j)
    score, bi, bj = best
    # crude traceback-free start estimate via re-scan
    i, j = bi, bj
    while i > 0 and j > 0 and H[i][j] > 0:
        diag = H[i - 1][j - 1]
        up = H[i - 1][j]
        left = H[i][j - 1]
        if diag >= up and diag >= left:
            i, j = i - 1, j - 1
        elif up >= left:
            i -= 1
        else:
            j -= 1
    return int(score), i, bi, j, bj


@dataclass
class SegmentHit:
    segment: Segment
    score: int
    contig_start: int
    contig_end: int
    seg_start: int = 0
    seg_end: int = 0

    def variants(self, contig: str) -> frozenset | None:
        """Somatic-variant evidence: (germline position, read base) pairs
        where the contig differs from the segment over the aligned span
        (the shared-mutation signal of enclone's graded joins,
        clonotype_assigner/src/assigner.rs:139 -> enclone_ranger).
        Returns None when the ungapped walk looks structurally off
        (likely an indel alignment) — then no evidence is claimed."""
        s = self.segment.seq.decode()
        n = min(self.contig_end - self.contig_start,
                self.seg_end - self.seg_start)
        if n <= 0:
            return frozenset()
        out = []
        for i in range(n):
            cb = contig[self.contig_start + i]
            sb = s[self.seg_start + i]
            if cb != sb:
                out.append((self.seg_start + i, cb))
        if len(out) > max(2, n // 10):
            return None
        return frozenset(out)


@dataclass
class ContigAnnotation:
    contig_seq: str
    chain: str | None = None
    v: SegmentHit | None = None
    j: SegmentHit | None = None
    c: SegmentHit | None = None
    cdr3_nt: str | None = None
    cdr3_aa: str | None = None
    productive: bool = False
    full_length: bool = False


def best_hit(contig: str, segments: list[Segment], min_score=40):
    ck = _kmers(contig)
    best = None
    for seg in segments:
        s = seg.seq.decode()
        if not (ck & _kmers(s)):
            continue
        score, cs, ce, ss, se = local_align(contig, s)
        if score >= min_score and (best is None or score > best.score):
            best = SegmentHit(seg, score, cs, ce, ss, se)
    return best


def find_cdr3(contig: str, v_end: int, j_start: int, j_end: int):
    """CDR3 = conserved Cys codon near the V end .. FG.G/WG.G motif in J.
    Returns (nt, aa) or (None, None)."""
    # candidate conserved-Cys codons near the V end, tried latest-first (the
    # reference anchors by V reading frame; we try frames until the J motif
    # agrees)
    lo = max(0, v_end - 60)
    cands = [i for i in range(lo, min(v_end + 9, len(contig) - 2))
             if contig[i:i + 3] in ("TGT", "TGC")]
    for cys in reversed(cands):
        # search FG.G / WG.G in the J region, in frame with cys (CDR3 >= 4 aa)
        for i in range(max(j_start, cys + 9), min(j_end, len(contig) - 11)):
            if (i - cys) % 3 != 0:
                continue
            aa = translate(contig[i:i + 12])
            if len(aa) >= 4 and aa[0] in "FW" and aa[1] == "G" and aa[3] == "G":
                nt = contig[cys:i + 3]
                return nt, translate(nt)
    return None, None


def annotate_contig(contig: str, ref: VdjReference) -> ContigAnnotation:
    ann = ContigAnnotation(contig_seq=contig)
    v = best_hit(contig, ref.by_region("V"))
    j = best_hit(contig, ref.by_region("J"), min_score=24)
    c = best_hit(contig, ref.by_region("C"), min_score=24)
    ann.v, ann.j, ann.c = v, j, c
    if v is not None:
        ann.chain = v.segment.chain
    elif j is not None:
        ann.chain = j.segment.chain
    if v is not None and j is not None and v.contig_end <= j.contig_end:
        ann.full_length = True
        nt, aa = find_cdr3(contig, v.contig_end, j.contig_start, j.contig_end)
        ann.cdr3_nt, ann.cdr3_aa = nt, aa
        if aa and "*" not in aa and len(nt) % 3 == 0:
            ann.productive = True
    return ann


# ---- probabilistic shared-mutation join (the enclone_ranger model the
# assigner stage shells out to, assigner.rs:139; the crate itself is not
# vendored, so the criterion is implemented from the published method:
# two candidate subclonotypes join when the probability that their SHARED
# V-region somatic mutations arose independently is small, with every
# CDR3 mismatch multiplying the probability) ----
JOIN_V_EFF_LEN = 300          # effective comparable V-segment positions
JOIN_CDR3_PENALTY = 80.0      # p multiplier per CDR3 nt mismatch
JOIN_LOG10_P_MAX = -4.0       # join iff log10(p) <= this
JOIN_MIN_MUTATIONS = 2        # below this SHM evidence, use the
                              # frequency gate (naive cells / TCR)


def _hyp_log10_sf(k: int, m1: int, m2: int, n: int) -> float:
    """log10 P(X >= k) for X ~ Hypergeometric(n, m1, m2): the chance two
    unrelated cells with m1 and m2 mutations over n positions share >= k
    of them by coincidence."""
    import math
    if k <= 0:
        return 0.0
    lo, hi = min(m1, m2), max(m1, m2)
    if k > lo:
        return float("-inf")
    lg = math.lgamma

    def lchoose(a, b):
        if b < 0 or b > a:
            return float("-inf")
        return lg(a + 1) - lg(b + 1) - lg(a - b + 1)

    denom = lchoose(n, hi)
    terms = [lchoose(lo, j) + lchoose(n - lo, hi - j) - denom
             for j in range(k, lo + 1)]
    m = max(terms)
    if m == float("-inf"):
        return float("-inf")
    s = sum(math.exp(t - m) for t in terms)
    return (m + math.log(s)) / math.log(10)


def shared_mutation_join_log10p(ev_a: frozenset, ev_b: frozenset,
                                cdr3_mm: int,
                                n_eff: int = JOIN_V_EFF_LEN) -> float:
    """log10 join probability for two subclonotypes' V-mutation evidence
    sets ((position, base) pairs) at cdr3_mm CDR3 nt mismatches."""
    import math
    shared = len(ev_a & ev_b)
    return (_hyp_log10_sf(shared, len(ev_a), len(ev_b), n_eff)
            + cdr3_mm * math.log10(JOIN_CDR3_PENALTY))


def _cluster_cdr3s(seqs: list[str], max_mm: int,
                   counts: dict[str, int] | None = None,
                   evidence: dict[str, frozenset] | None = None
                   ) -> dict[str, str]:
    """Union-find clustering of same-length CDR3 nt sequences within
    Hamming distance max_mm; returns seq -> representative (the
    lexicographically smallest member, so output is deterministic).

    Join criterion per candidate pair of CLUSTERS (enclone semantics):
      * with informative SHM evidence on both sides (>= JOIN_MIN_MUTATIONS
        V-region mutations each), the probabilistic shared-mutation model
        decides: join iff log10 P(shared | independent) + mismatch
        penalty <= JOIN_LOG10_P_MAX — strong shared mutations join even
        co-dominant clones, disjoint mutations refuse even minor ones;
      * otherwise the PAIRING-REFINEMENT frequency gate: a near-identical
        CDR3 only merges when one side is a MINOR variant (<= 1/4 the
        cells of the other) — hypermutation / sequencing-error variants
        are rare relative to the true clone, while two co-dominant
        variants are distinct germline clones."""
    parent = {s: s for s in seqs}

    def find(s):
        while parent[s] != s:
            parent[s] = parent[parent[s]]
            s = parent[s]
        return s

    # cluster-level cell counts: the gate compares the CLUSTERS being
    # joined, not the two sequences, so a rare variant cannot transitively
    # bridge two co-dominant clones (it attaches to whichever major it
    # meets first in deterministic sorted order)
    ccount = {s: (counts or {}).get(s, 1) for s in seqs}
    cev = {s: (evidence or {}).get(s) for s in seqs}
    ss = sorted(set(seqs))
    for i, a in enumerate(ss):
        for b in ss[i + 1:]:
            d = sum(x != y for x, y in zip(a, b))
            if d <= max_mm:
                ra, rb = find(a), find(b)
                if ra == rb:
                    continue
                ea, eb = cev[ra], cev[rb]
                if (ea is not None and eb is not None
                        and len(ea) >= JOIN_MIN_MUTATIONS
                        and len(eb) >= JOIN_MIN_MUTATIONS):
                    if (shared_mutation_join_log10p(ea, eb, d)
                            > JOIN_LOG10_P_MAX):
                        continue  # coincidence not excluded: refuse
                elif counts is not None:
                    ca, cb = ccount[ra], ccount[rb]
                    if min(ca, cb) > max(1, max(ca, cb) // 4):
                        continue  # co-dominant clones: refuse the join
                root, child = min(ra, rb), max(ra, rb)
                parent[child] = root
                ccount[root] = ccount[root] + ccount[child]
                if cev[root] is not None and cev[child] is not None:
                    cev[root] = cev[root] | cev[child]
                else:
                    cev[root] = cev[root] or cev[child]
    return {s: find(s) for s in ss}


def _variant_clusters(key, bcs, cell_vars) -> list[list[str]]:
    """Split one chain-set group of cells by conflicting V-region somatic
    variants (enclone graded joins, assigner.rs:139).  Two cells CONFLICT
    when some shared chain carries different bases at the same germline
    position AND no identical shared variant supports the join; cells
    without informative evidence attach to the largest cluster."""
    chain_ids = {(ch, v, j) for ch, v, j, _nt in key}
    sig = {}
    for bc in bcs:
        d = cell_vars.get(bc, {})
        m = {}
        informative = False
        for ck in chain_ids:
            vs = d.get(ck)
            if vs:                       # non-empty and not None
                informative = True
                for pos, base in vs:
                    m[(ck, pos)] = base
        sig[bc] = m if informative else None

    def conflict(ma, mb):
        common = ma.keys() & mb.keys()
        shared = sum(1 for k in common if ma[k] == mb[k])
        clash = sum(1 for k in common if ma[k] != mb[k])
        return clash >= 1 and shared == 0

    clusters: list[list[str]] = []
    for bc in sorted(b for b in bcs if sig[b]):
        for cl in clusters:
            if not any(conflict(sig[bc], sig[m]) for m in cl):
                cl.append(bc)
                break
        else:
            clusters.append([bc])
    if len(clusters) <= 1:
        return [sorted(bcs)]
    clusters.sort(key=lambda c: (-len(c), c[0]))
    clusters[0].extend(b for b in bcs if not sig[b])
    return [sorted(c) for c in clusters]


def group_clonotypes(cells: dict[str, list[ContigAnnotation]],
                     fuzzy: bool = True):
    """{barcode: [annotations]} -> clonotypes.

    fuzzy=True is the enclone-depth refinement
    (lib/rust/clonotype_assigner/src/assigner.rs drives enclone_ranger):
    within cells sharing (chain, V gene, J gene, CDR3 length), CDR3 nt
    sequences within ~10% Hamming distance (somatic hypermutation / seq
    error) cluster to one representative; cells whose productive chain set
    is then identical join one clonotype, and a cell whose chains are a
    strict SUBSET of exactly one larger clonotype merges into it
    (single-chain dropout handling). fuzzy=False keeps exact-CDR3 keys."""
    per_cell = {}
    # per-cell V-region somatic-variant evidence per chain identity
    # (enclone graded joins: shared variants merge, conflicting split)
    cell_vars: dict = {}
    # per exact chain (incl. CDR3 nt): the union of V-mutation evidence
    # across its cells — the input to the probabilistic join model
    chain_ev: dict = {}
    for bc, anns in cells.items():
        chains = set()
        for a in anns:
            if not (a.productive and a.cdr3_nt):
                continue
            ch = (a.chain or "",
                  a.v.segment.gene_name if a.v else "",
                  a.j.segment.gene_name if a.j else "",
                  a.cdr3_nt)
            chains.add(ch)
            if a.v is not None:
                ck = ch[:3]
                # duck-typed hits without coords claim no evidence
                vs = (a.v.variants(a.contig_seq)
                      if hasattr(a.v, "variants") else None)
                if vs is not None:
                    chain_ev[ch] = chain_ev.get(ch, frozenset()) | vs
                d = cell_vars.setdefault(bc, {})
                if ck in d:
                    prev = d[ck]
                    d[ck] = (None if (prev is None or vs is None)
                             else prev | vs)
                else:
                    d[ck] = vs
        if chains:
            per_cell[bc] = chains
    # pre-fuzzy EXACT chain sets define exact subclonotypes within a
    # clonotype (enclone's exact_subclonotype_id: identical CDR3 nt +
    # V/J per chain)
    exact_per_cell = {bc: tuple(sorted(chains))
                      for bc, chains in per_cell.items()}

    if fuzzy:
        # cluster CDR3s within (chain, v, j, len) buckets, counting the
        # cells behind each variant for the pairing-refinement gate
        buckets: dict = {}
        variant_cells: dict = {}
        for chains in per_cell.values():
            for key in chains:
                ch, v, j, nt = key
                buckets.setdefault((ch, v, j, len(nt)), set()).add(nt)
                variant_cells[key] = variant_cells.get(key, 0) + 1
        rep = {}
        for (ch, v, j, ln), seqs in buckets.items():
            mm = max(1, ln // 10)
            cnt = {nt: variant_cells[(ch, v, j, nt)] for nt in seqs}
            ev = {nt: chain_ev[(ch, v, j, nt)] for nt in seqs
                  if (ch, v, j, nt) in chain_ev}
            for s, r in _cluster_cdr3s(sorted(seqs), mm,
                                       counts=cnt,
                                       evidence=ev).items():
                rep[(ch, v, j, s)] = r
        per_cell = {bc: {(ch, v, j, rep[(ch, v, j, nt)])
                         for (ch, v, j, nt) in chains}
                    for bc, chains in per_cell.items()}

    keyed: dict = {}
    for bc, chains in per_cell.items():
        keyed.setdefault(tuple(sorted(chains)), []).append(bc)

    if fuzzy and len(keyed) > 1:
        # subset merge: a key that is a strict subset of exactly ONE other
        # key absorbs into it (dropout of a chain in some cells)
        keys = sorted(keyed, key=lambda k: (-len(keyed[k]), k))
        merged_into = {}
        for k in keys:
            supers = [o for o in keys
                      if o is not k and set(k) < set(o)
                      and o not in merged_into]
            if len(supers) == 1:
                merged_into[k] = supers[0]
            elif len(supers) > 1:
                # ambiguous: absorb only into a DOMINANT superset (unique
                # max frequency) — the enclone light-chain-only heuristic
                freqs = sorted((len(keyed[o]) for o in supers), reverse=True)
                if freqs[0] > freqs[1]:
                    merged_into[k] = max(supers, key=lambda o: len(keyed[o]))
        for k, sup in merged_into.items():
            while sup in merged_into:
                sup = merged_into[sup]
            if sup != k:
                keyed[sup].extend(keyed.pop(k))

    if fuzzy:
        # onesie filter (enclone's FILTER for single-chain artifacts): a
        # STANDALONE single-chain clonotype supported by one cell is a
        # likely fragment/doublet remnant and is dropped — unless its
        # chain appears in no multi-chain clonotype (then it is the only
        # evidence for that chain and survives)
        multi_chain_members = {c for k in keyed if len(k) > 1 for c in k}
        keyed = {k: bcs for k, bcs in keyed.items()
                 if not (len(k) == 1 and len(bcs) == 1
                         and k[0] in multi_chain_members)}

    if fuzzy:
        # graded-join split (assigner.rs:139 -> enclone_ranger shared-
        # mutation evidence): cells in one chain-set group whose V-region
        # variants CONFLICT (same germline position, different base, with
        # no shared variant backing the join) become distinct clonotypes;
        # cells without informative variants follow the dominant cluster
        split_keyed = []
        for key, bcs in keyed.items():
            for cluster in _variant_clusters(key, bcs, cell_vars):
                split_keyed.append((key, cluster))
        items = split_keyed
    else:
        items = list(keyed.items())

    out = []
    order = sorted(items, key=lambda kv: (-len(kv[1]), kv[0],
                                          sorted(kv[1])))
    for key, bcs in order:
        # exact subclonotypes: members grouped by their pre-fuzzy chain
        # sets, largest first (enclone exact_subclonotype numbering)
        by_exact: dict = {}
        for bc in bcs:
            by_exact.setdefault(exact_per_cell[bc], []).append(bc)
        exacts = [dict(exact_subclonotype_id=i + 1,
                       chains=[dict(chain=ch, v_gene=v, j_gene=j,
                                    cdr3_nt=nt)
                               for ch, v, j, nt in ekey],
                       barcodes=sorted(ebcs), frequency=len(ebcs))
                  for i, (ekey, ebcs) in enumerate(
                      sorted(by_exact.items(),
                             key=lambda kv: (-len(kv[1]), kv[0])))]
        out.append(dict(
            clonotype_id=f"clonotype{len(out) + 1}",
            chains=[dict(chain=ch, v_gene=v, j_gene=j, cdr3_nt=nt)
                    for ch, v, j, nt in key],
            barcodes=sorted(bcs), frequency=len(bcs),
            exact_subclonotypes=exacts))
    return out
