"""A numpy model of the lane algorithm of csrc/sw.cu.

The CUDA kernel runs only on the card, so its arithmetic is mirrored here
step for step, with the lanes of a read as an array axis: mask folded into
the code byte (code | 0x80), 4 band cells in each of a read's 4 lanes,
`vert` from the right neighbour, the serial scan inside a lane, the
exclusive prefix maximum across lanes as the kernel takes it (every left
neighbour fetched with one shuffle each; a lane with no such neighbour
gets its own value back and a NEG term takes it out), and the packed
best-cell key (score << 20 | (0xFFFF - row) << 4 | (15 - d)) reduced once
at the end.  The CPU tests hold this model against
`align.sw.banded_sw_ref`; on the card chip_smoke.py holds the kernel
itself against the same plain version.
"""

from __future__ import annotations

import numpy as np

from ..align.sw import BAND, GAP, NEG

CPL = 4           # band cells per lane, as in csrc/sw.cu
G = BAND // CPL   # lanes per read


def _shfl_up(x: np.ndarray, delta: int) -> np.ndarray:
    """__shfl_up_sync within a group: lanes below `delta` keep their own
    value."""
    y = x.copy()
    y[:, delta:] = x[:, :-delta]
    return y


def banded_sw_lanes(read, rmask, win, wmask):
    """(score, end_i, end_d) int64 [B] as the kernel computes them."""
    B, L = read.shape
    rf_all = np.where(rmask, read, read | 0x80).astype(np.int64)
    wf_all = np.where(wmask, win, win | 0x80).astype(np.int64)
    g = np.arange(G)[None, :]
    h = np.zeros((B, G, CPL), np.int64)
    bestkey = np.full((B, G), (0xFFFF << 4) | (BAND - 1), np.int64)
    rowkey = np.broadcast_to((0xFFFF << 4) | (BAND - 1 - g * CPL),
                             (B, G)).copy()
    for i in range(L):
        rf = rf_all[:, i][:, None, None]
        wv = wf_all[:, i:i + BAND].reshape(B, G, CPL)
        up = np.full((B, G), NEG, np.int64)
        up[:, :-1] = h[:, 1:, 0]                  # __shfl_down_sync by 1
        act = (rf | wv) < 0x80
        s = np.where(act, np.where(rf == wv, 1, -1), NEG)
        vert = np.concatenate([h[:, :, 1:], up[:, :, None]], axis=2) - GAP
        t = np.maximum(np.maximum(h + s, vert), 0)
        for c in range(1, CPL):
            t[:, :, c] = np.maximum(t[:, :, c - 1] - GAP, t[:, :, c])
        u = t[:, :, CPL - 1] + GAP * CPL * g
        x = _shfl_up(u, 1)
        x[:, 0] = NEG
        for k in range(2, G):
            x = np.maximum(_shfl_up(u, k) + np.where(g >= k, 0, NEG), x)
        cin = x - GAP * CPL * (g - 1) - GAP
        for c in range(CPL):
            t[:, :, c] = np.maximum(cin - GAP * c, t[:, :, c])
        h = np.where(act, t, 0)
        for c in range(CPL):
            bestkey = np.maximum(bestkey, (h[:, :, c] << 20) + (rowkey - c))
        rowkey -= BAND
    k = bestkey.max(axis=1)
    return k >> 20, 0xFFFF - ((k >> 4) & 0xFFFF), BAND - 1 - (k & 15)
