"""Device read trimming: TSO (5') and polyA (3') adapter removal.

Port of cellranger_tpu/ops/trim.py `make_trimmer` (aligner.rs:101-166
adapter defs + score thresholds).  The read buffer is never moved:
trimming masks bases out of `nmask`, and the aligner skips masked bases.

  * polyA (3', non-internal): best gapless score against any read suffix
    is max_p [ #A in [p,L) - #non-A in [p,L) ], one reversed cumsum; the
    leftmost maximal suffix start wins.
  * TSO (5', anywhere): gapless sliding score over every overlap offset
    (+1 match / -1 mismatch, masked bases mismatch), trimming through the
    adapter's end.
"""

from __future__ import annotations

import numpy as np
import torch

TSO_SEQ = b"AAGCAGTGGTATCAACGCAGAGTACATGGG"   # aligner.rs:86
_CODE = {65: 0, 67: 1, 71: 2, 84: 3}
TSO_2BIT = np.asarray([_CODE[b] for b in TSO_SEQ], np.int32)

DEFAULT_TRIM_MIN_SCORE = 20   # cellranger.rs:278-279
TSO_METRIC_MIN_SCORE = 20     # aligner.rs:180 MIN_TSO_SCORE


def make_trimmer(read_len: int, polya_min: int | None = DEFAULT_TRIM_MIN_SCORE,
                 tso_min: int | None = DEFAULT_TRIM_MIN_SCORE):
    """Build trim(rna uint8 [B, L], nmask bool [B, L]) -> dict with
    nmask (trimmed), retain_start, retain_end, tso_score, matched_tso,
    tso_trimmed, polya_trimmed."""
    L = read_len
    K = len(TSO_2BIT)
    D = L + K - 1  # adapter start offsets -K+1 .. L-1
    n_olap_np = np.asarray(
        [sum(1 for j in range(K) if 0 <= d + j < L)
         for d in (np.arange(D) - (K - 1))], np.int32)

    def trim(rna, nmask):
        B = rna.shape[0]
        dev = rna.device
        # ---- polyA suffix score ----
        contrib = torch.where(nmask, torch.where(rna == 0, 1, -1), 0)
        suff = torch.cumsum(contrib.flip(1), 1).flip(1)      # [B, L] s(p)
        pa_best, pa_start = torch.max(suff, 1)               # first max
        pa_hit = (pa_best >= polya_min) if polya_min is not None \
            else torch.zeros(B, dtype=torch.bool, device=dev)
        retain_end = torch.where(pa_hit, pa_start, L)

        # ---- TSO sliding score: K shifted adds ----
        # score[d] = 2 * #matches(read[d+j] == tso[j]) - overlap(d)
        acc = torch.zeros((B, D), dtype=torch.int32, device=dev)
        for j in range(K):
            m_j = ((rna == int(TSO_2BIT[j])) & nmask).to(torch.int32)
            acc[:, K - 1 - j:K - 1 - j + L] += m_j
        n_olap = torch.from_numpy(n_olap_np).to(dev)
        score_d = 2 * acc - n_olap[None, :]
        ts_best, d_arg = torch.max(score_d, 1)
        d_best = d_arg - (K - 1)
        ts_hit = (ts_best >= tso_min) if tso_min is not None \
            else torch.zeros(B, dtype=torch.bool, device=dev)
        retain_start = torch.where(ts_hit, torch.clamp(d_best + K, 0, L), 0)

        retain_end = torch.maximum(retain_end, retain_start)
        pos = torch.arange(L, device=dev)[None, :]
        new_mask = nmask & (pos >= retain_start[:, None]) \
            & (pos < retain_end[:, None])
        return dict(
            nmask=new_mask,
            retain_start=retain_start,
            retain_end=retain_end,
            tso_score=ts_best,
            matched_tso=ts_best >= TSO_METRIC_MIN_SCORE,
            tso_trimmed=retain_start,
            polya_trimmed=L - retain_end,
        )

    return trim
