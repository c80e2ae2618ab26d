"""UMI correction + duplicate marking as sorted-segment device ops.

Port of cellranger_tpu/ops/dedup.py (the reference's mark_dups.rs as
fixed-shape batched array ops):

  * correct_umis (mark_dups.rs:19-59): each distinct (bc, gene, umi) moves
    to the 1-Hamming neighbour UMI with strictly greater read count, or
    equal count and lexicographically larger UMI;
  * the two-phase count movement (mark_dups.rs:227-247): one read of each
    corrected UMI moves before low-support determination, the rest after;
  * determine_low_support_umigenes (mark_dups.rs:87-108): within each
    (bc, umi) the top gene by read count survives; a tie for the max marks
    every gene low-support.

Every multi-key `lax.sort` of the JAX package becomes `lexsort`: stable
sorts over keys packed two to an int64.  Where rows with equal keys carry
different payloads, everything downstream reduces over the run (segment
sums and maxima, scatter-max by row id), so the result does not depend on
their order.  Keys are u32 values in int64; invalid rows carry the
0xFFFFFFFF sentinel, which sorts last.
"""

from __future__ import annotations

import torch

from .tensor_ops import (U32_MAX, first_of_run, lexsort, seg_ids,
                         segment_max, segment_sum)


def _ceil_log2(n: int) -> int:
    b = 1
    while (1 << b) < n:
        b += 1
    return b


def lex3_search(k1, k2, k3, q1, q2, q3):
    """Leftmost index where sorted (k1, k2, k3) >= the query tuple (all u32
    values).  Returns (idx int64, found bool)."""
    N = k1.shape[0]
    iters = _ceil_log2(max(N, 2)) + 1
    lo = torch.zeros(q1.shape, dtype=torch.int64, device=q1.device)
    hi = torch.full(q1.shape, N, dtype=torch.int64, device=q1.device)
    for _ in range(iters):
        mid = (lo + hi) >> 1
        midc = torch.clamp(mid, 0, N - 1)
        a, b, c = k1[midc], k2[midc], k3[midc]
        lt = (a < q1) | ((a == q1) & ((b < q2) | ((b == q2) & (c < q3))))
        lt = lt & (mid < hi)
        lo = torch.where(lt, mid + 1, lo)
        hi = torch.where(lt, hi, mid)
    idx = torch.clamp(lo, 0, N - 1)
    found = (lo < N) & (k1[idx] == q1) & (k2[idx] == q2) & (k3[idx] == q3)
    return idx, found


def exact_merge(rows: torch.Tensor, n):
    """Merge identical (bc, gene, umi) triples of a molecule buffer,
    summing read counts.  rows: int64 [C, 4] (bc, gene, umi, reads) as
    u32 values, live rows [0, n).  Returns (rows', n') with the merged
    triples sorted by (bc, gene, umi) and compacted to the front; the tail
    is sentinel.  n' is a 0-d device tensor."""
    C = rows.shape[0]
    dev = rows.device
    live = torch.arange(C, device=dev) < n
    bc = torch.where(live, rows[:, 0], U32_MAX)
    gene = torch.where(live, rows[:, 1], U32_MAX)
    umi = torch.where(live, rows[:, 2], U32_MAX)
    w = torch.where(live, rows[:, 3], 0)
    o = lexsort(bc, gene, umi)
    bc_s, gene_s, umi_s, w_s = bc[o], gene[o], umi[o], w[o]
    valid_s = bc_s != U32_MAX
    new_t = first_of_run(bc_s, gene_s, umi_s)
    tid = seg_ids(new_t)
    reads = segment_sum(torch.where(valid_s, w_s, 0), tid, C) & 0xFFFFFFFF
    is_repr = new_t & valid_s
    dst = torch.where(is_repr, tid, C)        # C = drop
    out = torch.full((C + 1, 4), U32_MAX, dtype=torch.int64, device=dev)
    out[dst] = torch.stack([bc_s, gene_s, umi_s, reads[tid]], 1)
    return out[:C], is_repr.sum()


def dedup_molecules(bc, gene, umi, valid, umi_len: int, reads=None):
    """Full UMI correction + low-support marking + molecule counting.

    Inputs (all [N]): bc, gene, umi u32 values (int64), valid bool, and
    optionally reads (u32 weight per row; None = one read per row).
    Returns a dict of [N] tensors: mol_bc/mol_gene/mol_umi sorted by (bc,
    gene, corrected umi), mol_reads, mol_valid (representative and not
    low-support), n_molecules, and the raw-triple views raw_*.
    """
    N = bc.shape[0]
    dev = bc.device
    sent = U32_MAX
    bc = torch.where(valid, bc, sent)
    gene = torch.where(valid, gene, sent)
    umi = torch.where(valid, umi, sent)
    w = (torch.ones(N, dtype=torch.int64, device=dev) if reads is None
         else reads.to(torch.int64))

    # ---- phase 0: sort triples, count reads per distinct (bc, gene, umi) ----
    o = lexsort(bc, gene, umi)
    bc_s, gene_s, umi_s, w_s = bc[o], gene[o], umi[o], w[o]
    valid_s = bc_s != sent
    new_triple = first_of_run(bc_s, gene_s, umi_s)
    tid = seg_ids(new_triple)
    reads_per_triple = segment_sum(torch.where(valid_s, w_s, 0), tid, N)
    cnt = reads_per_triple[tid]              # [N] count of own triple
    is_repr = new_triple & valid_s

    # ---- phase 1: UMI correction per distinct triple ----
    # umi_len position-masked keys per row: two triples are 1-Hamming
    # neighbours iff they share a masked key, so within each sorted
    # (bc-gene-segment, pos, masked-umi) run all members are mutual
    # neighbours and each member's best neighbour is the run's lex-max
    # (count, umi) excluding itself (the run's top-2).
    new_bg = first_of_run(bc_s, gene_s)
    sid = seg_ids(new_bg)                    # (bc, gene) segment id < N
    L = umi_len
    posu = torch.arange(L, dtype=torch.int64, device=dev)
    shifts = 2 * (L - 1 - posu)
    maskv = (~(3 << shifts)) & 0xFFFFFFFF                    # [L]
    hi = (sid[None, :] * L + posu[:, None]).reshape(-1)
    hi = torch.where(valid_s.repeat(L), hi, U32_MAX)
    lo = (umi_s[None, :] & maskv[:, None]).reshape(-1)       # [L*N]
    c_cnt = cnt.repeat(L)
    c_umi = umi_s.repeat(L)
    c_row = torch.arange(N, device=dev).repeat(L)
    o1 = lexsort(hi, lo)
    shi, slo, scnt, sumi, srow = hi[o1], lo[o1], c_cnt[o1], c_umi[o1], \
        c_row[o1]
    K = L * N
    rid = seg_ids(first_of_run(shi, slo))
    val = shi != U32_MAX
    cnt_v = torch.where(val, scnt, 0)
    m1c = segment_max(cnt_v, rid, K)
    at_m1c = cnt_v == m1c[rid]
    m1u = segment_max(torch.where(at_m1c, sumi, 0), rid, K)
    is_m1 = at_m1c & (sumi == m1u[rid]) & val
    n_m1 = segment_sum(is_m1.to(torch.int64), rid, K)
    m2c = segment_max(torch.where(is_m1, 0, cnt_v), rid, K)
    at_m2c = (cnt_v == m2c[rid]) & ~is_m1
    m2u = segment_max(torch.where(at_m2c, sumi, 0), rid, K)
    self_is_unique_max = is_m1 & (n_m1[rid] == 1)
    cand_c = torch.where(self_is_unique_max, m2c[rid], m1c[rid])
    cand_u = torch.where(self_is_unique_max, m2u[rid], m1u[rid])
    cand_c = torch.where(val, cand_c, 0)
    cand_u = torch.where(val, cand_u, 0)
    # fold the L per-position candidates back to their origin row: count
    # major first, then umi among candidates at that count
    zeros = torch.zeros(N, dtype=torch.int64, device=dev)
    best_c = zeros.scatter_reduce(0, srow, cand_c, "amax", include_self=True)
    at_max = cand_c == best_c[srow]
    best_u = zeros.scatter_reduce(0, srow, torch.where(at_max, cand_u, 0),
                                  "amax", include_self=True)
    take_mut = (best_c > cnt) | ((best_c == cnt) & (best_u > umi_s))
    best_umi = torch.where(take_mut, best_u, umi_s)
    corr_umi = torch.where(valid_s, best_umi, sent)
    is_corrected = corr_umi != umi_s

    # ---- phase 2+3: low-support determination on intermediate counts ----
    # entry A = (bc, raw_umi, gene, c - corrected); entry B = (bc,
    # corr_umi, gene, corrected ? 1 : 0); representative rows only
    corr_r = is_corrected & is_repr
    cntA = torch.where(is_repr, cnt - corr_r.to(torch.int64), 0)
    cntB = corr_r.to(torch.int64)
    e_bc = torch.cat([torch.where(is_repr, bc_s, sent),
                      torch.where(corr_r, bc_s, sent)])
    e_umi = torch.cat([torch.where(is_repr, umi_s, sent),
                       torch.where(corr_r, corr_umi, sent)])
    e_gene = torch.cat([torch.where(is_repr, gene_s, sent),
                        torch.where(corr_r, gene_s, sent)])
    e_cnt = torch.cat([cntA, cntB])
    E = 2 * N
    o2 = lexsort(e_bc, e_umi, e_gene)
    eb, eu, eg, ec = e_bc[o2], e_umi[o2], e_gene[o2], e_cnt[o2]
    evalid = eb != sent
    e_new3 = first_of_run(eb, eu, eg)
    e_t3 = seg_ids(e_new3)
    merged = segment_sum(torch.where(evalid, ec, 0), e_t3, E)
    e_t2 = seg_ids(first_of_run(eb, eu))
    mc = merged[e_t3]
    is_e_repr = e_new3 & evalid
    seg_max = segment_max(torch.where(is_e_repr, mc, -1), e_t2, E)
    seg_n_at_max = segment_sum(
        (is_e_repr & (mc == seg_max[e_t2])).to(torch.int64), e_t2, E)
    tie = seg_n_at_max[e_t2] >= 2
    low = evalid & (tie | (mc < seg_max[e_t2]))

    # distinct-entry-triple table for the join, keyed (bc, umi, gene)
    tb = torch.where(is_e_repr, eb, sent)
    tu = torch.where(is_e_repr, eu, sent)
    tg = torch.where(is_e_repr, eg, sent)
    ot = lexsort(tb, tu, tg)
    tb, tu, tg, tlow = tb[ot], tu[ot], tg[ot], low[ot].to(torch.int64)

    # ---- phase 4: per original triple, is its corrected key low-support?
    # sort-join: table rows tag 0, query rows tag 1
    K2 = E + N
    jb = torch.cat([tb, bc_s])
    ju = torch.cat([tu, corr_umi])
    jg = torch.cat([tg, gene_s])
    jtag = torch.cat([torch.zeros(E, dtype=torch.int64, device=dev),
                      torch.ones(N, dtype=torch.int64, device=dev)])
    jlow = torch.cat([tlow, torch.zeros(N, dtype=torch.int64, device=dev)])
    jpay = torch.cat([torch.zeros(E, dtype=torch.int64, device=dev),
                      torch.arange(N, device=dev)])
    o3 = lexsort(jb, ju, jg, jtag)
    jb2, ju2, jg2, jt2, jl2, jp2 = (jb[o3], ju[o3], jg[o3], jtag[o3],
                                    jlow[o3], jpay[o3])
    ar2 = torch.arange(K2, device=dev)
    new2 = first_of_run(jb2, ju2, jg2)
    run_start2 = torch.cummax(torch.where(new2, ar2, 0), 0).values
    posf2 = torch.cummax(torch.where(jt2 == 0, ar2, -1), 0).values
    got = (posf2 >= run_start2) & (jt2 == 1)
    lowv = got & (jl2[torch.clamp_min(posf2, 0)] > 0)
    low_support = torch.zeros(N, dtype=torch.int64, device=dev).scatter_reduce(
        0, jp2, torch.where(jt2 == 1, lowv, False).to(torch.int64), "amax",
        include_self=True) > 0
    low_support = low_support & valid_s

    # ---- phase 5: final molecule table by (bc, gene, corrected umi) ----
    o4 = lexsort(bc_s, gene_s, corr_umi)
    fb, fg, fu = bc_s[o4], gene_s[o4], corr_umi[o4]
    fcnt = torch.where(is_repr, cnt, 0)[o4]
    flow = low_support.to(torch.int64)[o4]
    fvalid = fb != sent
    f_new = first_of_run(fb, fg, fu)
    fid = seg_ids(f_new)
    mol_reads = segment_sum(torch.where(fvalid, fcnt, 0), fid, N)
    mol_low = segment_max(torch.where(fvalid, flow, 0), fid, N)
    f_repr = f_new & fvalid
    mol_valid = f_repr & (mol_low[fid] == 0)
    return dict(
        mol_bc=fb, mol_gene=fg, mol_umi=fu,
        mol_reads=mol_reads[fid], mol_valid=mol_valid,
        n_molecules=mol_valid.sum(),
        raw_bc=bc_s, raw_gene=gene_s, raw_umi=umi_s,
        raw_corr_umi=corr_umi, raw_low=low_support, raw_is_repr=is_repr,
        raw_reads=torch.where(is_repr, cnt, 0),
    )
