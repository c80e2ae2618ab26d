"""Port parity: the banded Smith-Waterman of cellranger_tpu_torch against
the JAX package's Pallas kernel (interpret mode on the CPU).

On the CPU the port's `banded_sw` runs its plain torch version; the CUDA
kernel itself is checked against that plain version on the card by
chip_smoke.py.  Tolerance 0: the recurrence is integer.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cellranger_tpu.align.sw import banded_sw as jax_banded_sw
from cellranger_tpu.align.sw import sw_traceback_host as jax_traceback
from cellranger_tpu.ops import encode as jenc
from cellranger_tpu_torch.align import sw
from cellranger_tpu_torch.testing.fixtures import sw_inputs


@pytest.mark.parametrize("L", [91, 28])
def test_banded_sw_matches_jax(L):
    B = 300                                 # not a multiple of 128
    read, rmask, win, wmask = sw_inputs(L, B, L)
    want = jax_banded_sw(jnp.asarray(read), jnp.asarray(rmask),
                         jnp.asarray(win), jnp.asarray(wmask))
    before = sw.LAUNCHES
    got = sw.banded_sw(*(torch.from_numpy(a) for a in
                         (read, rmask, win, wmask)))
    assert sw.LAUNCHES == before == 0, "no kernel launch on the CPU"
    for name, w, g in zip(("score", "end_i", "end_d"), want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    # the planted alignments score high: the test exercises real paths
    planted = (np.arange(B) % 4 < 3) & (np.arange(B) % 5 != 4)
    assert (got[0].numpy()[planted] > L // 2).mean() > 0.8


def test_banded_sw_rejects_bad_inputs():
    read, rmask, win, wmask = (torch.from_numpy(a)
                               for a in sw_inputs(1, 8, 28))
    with pytest.raises(ValueError, match="window width"):
        sw.banded_sw(read, rmask, win[:, :-1], wmask[:, :-1])
    with pytest.raises(TypeError, match="uint8"):
        sw.banded_sw(read.to(torch.int32), rmask, win, wmask)
    with pytest.raises(TypeError, match="bool"):
        sw.banded_sw(read, rmask.to(torch.uint8), win, wmask)
    with pytest.raises(ValueError, match="mismatched"):
        sw.banded_sw(read, rmask[:4], win, wmask)
    assert sw.LAUNCHES == 0


def _sw_case(read: bytes, win: bytes, L: int):
    """One read and its window as tests/test_sw.py builds them."""
    rc, rv = jenc.encode_str(read)
    wc, wv = jenc.encode_str(win)
    W = L + sw.BAND
    r, rm = np.zeros(L, np.uint8), np.zeros(L, bool)
    w, wm = np.zeros(W, np.uint8), np.zeros(W, bool)
    r[:len(rc)], rm[:len(rc)] = rc[:L], rv[:L]
    w[:len(wc)], wm[:len(wc)] = wc[:W], wv[:W]
    return r, rm, w, wm


def _sw_test_cases():
    """The cases of tests/test_sw.py: an exact match, 64 reads with
    mismatches and a third of them with an inserted or deleted base, and a
    read with a 2-base deletion."""
    rng = np.random.default_rng(0)
    seq = bytes(rng.choice(list(b"ACGT"), 40).astype(np.uint8))
    cases = [_sw_case(seq, b"AC" * (sw.BAND // 4) + seq + b"GT" * 10, 40)]
    rng, L = np.random.default_rng(1), 48
    for t in range(64):
        win = bytes(rng.choice(list(b"ACGT"), L + sw.BAND).astype(np.uint8))
        off = int(rng.integers(4, sw.BAND - 4))
        frag = bytearray(win[off:off + L])
        for _ in range(int(rng.integers(0, 6))):
            frag[int(rng.integers(L))] = int(rng.choice(list(b"ACGT")))
        if t % 3 == 1:
            del frag[int(rng.integers(5, L - 5))]
            frag.append(ord("A"))
        elif t % 3 == 2:
            frag.insert(int(rng.integers(5, L - 5)), ord("C"))
            frag.pop()
        cases.append(_sw_case(bytes(frag), win, L))
    g = bytes(np.random.default_rng(5).choice(list(b"ACGT"), 120)
              .astype(np.uint8))
    half = sw.BAND // 2
    read = (g[half:half + 20] + g[half + 22:half + 50])[:48]
    cases.append(_sw_case(read, g[:48 + sw.BAND], 48))
    return cases


def test_sw_traceback_host_matches_jax():
    """The port's host DP and traceback equal the JAX package's on every
    case of tests/test_sw.py (score, CIGAR, read and window starts), and
    the deletion read's CIGAR holds a D."""
    cases = _sw_test_cases()
    got = [sw.sw_traceback_host(*c) for c in cases]
    assert got == [jax_traceback(*c) for c in cases]
    assert got[0][:2] == (40, [(40, "M")])
    assert "D" in "".join(op for _, op in got[-1][1]) and got[-1][0] >= 40
    assert {op for g in got for _, op in g[1]} == {"M", "I", "D"}
    # and the scores are the plain banded SW's, as the kernel is held to
    batch = [np.stack(x) for x in zip(*cases[1:-1])]
    score = sw.banded_sw(*(torch.from_numpy(a) for a in batch))[0]
    assert score.tolist() == [g[0] for g in got[1:-1]]
