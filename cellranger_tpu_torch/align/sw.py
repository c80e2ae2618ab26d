"""Banded Smith-Waterman rescue: CUDA kernel wrapper + plain version.

Port of cellranger_tpu/align/sw.py `banded_sw`.  Each read is aligned
against a window that starts BAND//2 before its candidate diagonal, in a
16-wide band, with match +1, mismatch -1, linear gap 2 and a floor at 0
(constants.py:31-34).  Returns the best cell (score, end_i, end_d).

`banded_sw` dispatches on the device of its inputs: CPU tensors go to
`banded_sw_ref` (plain torch, one [B, 16] band row per read position);
CUDA tensors go to the hand-written kernel in csrc/sw.cu (a group of
lanes per read, rows staged through shared memory; its header has the
design), with no fallback.  `LAUNCHES` counts kernel launches.
`sw_traceback_host` is the host DP with a traceback to a CIGAR, for one
read.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (SW_GAP_EXTEND, SW_MATCH_SCORE,
                         SW_MISMATCH_SCORE)

BAND = 16
GAP = -SW_GAP_EXTEND  # positive penalty
NEG = -(1 << 20)
MAX_KERNEL_READ_LEN = 2047  # the kernel's packed best-cell key (csrc/sw.cu)

LAUNCHES = 0


def banded_sw_ref(read_codes, read_mask, win_codes, win_mask):
    """Plain torch version, same recurrence and masking order as the
    kernel (see csrc/sw.cu).  Returns (score, end_i, end_d) int32 [B]."""
    B, L = read_codes.shape
    dev = read_codes.device
    d_idx = torch.arange(BAND, dtype=torch.int32, device=dev)
    gp_d = GAP * d_idx
    h = torch.zeros((B, BAND), dtype=torch.int32, device=dev)
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    bi = torch.zeros(B, dtype=torch.int32, device=dev)
    bd = torch.zeros(B, dtype=torch.int32, device=dev)
    neg_col = torch.full((B, 1), NEG, dtype=torch.int32, device=dev)
    r_all = read_codes.to(torch.int32)
    w_all = win_codes.to(torch.int32)
    for i in range(L):
        r = r_all[:, i:i + 1]
        w = w_all[:, i:i + BAND]
        active = read_mask[:, i:i + 1] & win_mask[:, i:i + BAND]
        s = torch.where(w == r, SW_MATCH_SCORE, SW_MISMATCH_SCORE)
        s = torch.where(active, s, NEG).to(torch.int32)
        diag = h + s
        vert = torch.cat([h[:, 1:], neg_col], dim=1) - GAP
        pre = torch.clamp_min(torch.maximum(diag, vert), 0)
        # max-plus prefix scan along the band: t[d] = max(pre[d],
        # t[d-1] - GAP), as a cummax of pre + GAP*d
        t = torch.cummax(pre + gp_d, dim=1).values - gp_d
        h = torch.where(active, t, 0).to(torch.int32)
        # smaller d wins ties within a row (argmax takes the first max)
        row_best, row_d = torch.max(h, dim=1)
        better = row_best > best
        best = torch.where(better, row_best, best)
        bi = torch.where(better, i, bi).to(torch.int32)
        bd = torch.where(better, row_d.to(torch.int32), bd)
    return best, bi, bd


def _check(read_codes, read_mask, win_codes, win_mask):
    ts = (read_codes, read_mask, win_codes, win_mask)
    if any(t.dim() != 2 for t in ts):
        raise ValueError("banded_sw takes 2-D [B, L] / [B, L+16] tensors")
    B, L = read_codes.shape
    W = win_codes.shape[1]
    if W != L + BAND:
        raise ValueError(f"window width {W} != read length {L} + {BAND}")
    if tuple(read_mask.shape) != (B, L) or tuple(win_mask.shape) != (B, W) \
            or win_codes.shape[0] != B:
        raise ValueError("banded_sw: mismatched shapes "
                         f"{[tuple(t.shape) for t in ts]}")
    if read_codes.dtype != torch.uint8 or win_codes.dtype != torch.uint8:
        raise TypeError("banded_sw: codes must be uint8")
    if read_mask.dtype != torch.bool or win_mask.dtype != torch.bool:
        raise TypeError("banded_sw: masks must be bool")
    if len({t.device for t in ts}) != 1:
        raise ValueError("banded_sw: inputs on different devices")


def banded_sw(read_codes, read_mask, win_codes, win_mask):
    """Batched banded SW: read_codes uint8 [B, L] (base codes, below 128),
    read_mask bool [B, L], win_codes uint8 [B, L+16], win_mask bool
    [B, L+16].  Returns (score, end_i, end_d) int32 [B]."""
    global LAUNCHES
    _check(read_codes, read_mask, win_codes, win_mask)
    dev = read_codes.device
    if dev.type == "cpu":
        return banded_sw_ref(read_codes, read_mask, win_codes, win_mask)
    if dev.type != "cuda":
        raise ValueError(f"banded_sw: unsupported device {dev}")
    ts = (read_codes, read_mask, win_codes, win_mask)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("banded_sw: inputs must be contiguous")
    from .. import kernels

    B, L = read_codes.shape
    if not 1 <= L <= MAX_KERNEL_READ_LEN:
        raise ValueError(f"banded_sw kernel: read length {L} outside "
                         f"[1, {MAX_KERNEL_READ_LEN}]")
    outs = torch.empty((3, B), dtype=torch.int32, device=dev).unbind(0)
    lib = kernels.library()         # a failed build raises, also for B = 0
    if B == 0:
        return tuple(outs)
    # the launch goes to the inputs' card, which need not be the current
    # one (a mesh of several cards steps slice i on card i)
    with torch.cuda.device(dev):
        rc = lib.crt_banded_sw(
            *(t.data_ptr() for t in ts), B, L,
            *(o.data_ptr() for o in outs),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"banded_sw kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return tuple(outs)


def sw_traceback_host(read: np.ndarray, rmask: np.ndarray, win: np.ndarray,
                      wmask: np.ndarray):
    """Host DP and traceback for one read, with the kernel's scoring and
    band (window position j of read row i in [i, i + BAND)): returns
    (score, CIGAR as [(length, op)] with ops M, I, D, read start, window
    start).  Each row's diagonal and up moves are computed at once; the
    left move depends on the cell before it, so the row is then walked
    cell by cell.  A cell takes the first best of (diagonal, up, left,
    0); a masked read row or window cell stays 0."""
    read, win = np.asarray(read), np.asarray(win)
    L, W = len(read), len(win)
    H = np.zeros((L + 1, W + 1), np.int64)
    move = np.zeros((L + 1, W + 1), np.int8)   # 0 stop, 1 M, 2 I, 3 D
    best, bi, bj = 0, 0, 0
    for i in range(1, L + 1):
        lo, hi = max(1, i), min(W + 1, i + BAND)
        if not rmask[i - 1] or lo >= hi:
            continue
        score = np.where(win[lo - 1:hi - 1] == read[i - 1], SW_MATCH_SCORE,
                         SW_MISMATCH_SCORE)
        diag = H[i - 1, lo - 1:hi - 1] + score
        up = H[i - 1, lo:hi] - GAP
        for k, j in enumerate(range(lo, hi)):
            if not wmask[j - 1]:
                continue
            cands = (int(diag[k]), int(up[k]), int(H[i, j - 1]) - GAP, 0)
            v = max(cands)
            H[i, j] = v
            move[i, j] = cands.index(v) + 1 if v > 0 else 0
            if v > best:
                best, bi, bj = v, i, j
    ops = []
    i, j = bi, bj
    while i > 0 and j > 0 and move[i, j]:
        op = "MID"[move[i, j] - 1]
        ops.append(op)
        i, j = i - (op != "D"), j - (op != "I")
    cigar: list[tuple[int, str]] = []
    for op in reversed(ops):
        if cigar and cigar[-1][1] == op:
            cigar[-1] = (cigar[-1][0] + 1, op)
        else:
            cigar.append((1, op))
    return int(best), cigar, i, j
