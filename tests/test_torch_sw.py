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
