"""The arithmetic of the CUDA Smith-Waterman kernel, held on the CPU.

The kernel (cellranger_tpu_torch/csrc/sw.cu) cannot run without the card,
so `testing.sw_lane_model.banded_sw_lanes` mirrors its lane algorithm in
numpy: folded mask bytes, four cells per lane, the cross-lane scan and the
packed best-cell key.  Here the model must equal the plain torch version
(`banded_sw_ref`) over several seeds and shapes, and the plain version must equal
the JAX package's Pallas kernel (interpret mode) on the adversarial inputs
that chip_smoke.py gives the kernel on the card.  Tolerance 0.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cellranger_tpu.align.sw import banded_sw as jax_banded_sw
from cellranger_tpu_torch.align import sw
from cellranger_tpu_torch.testing.fixtures import (sw_adversarial_inputs,
                                                   sw_inputs)
from cellranger_tpu_torch.testing.sw_lane_model import banded_sw_lanes

GENERATORS = {"random": sw_inputs, "adversarial": sw_adversarial_inputs}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", sorted(GENERATORS))
@pytest.mark.parametrize("B,L", [(257, 33), (300, 91), (64, 150), (1, 91),
                                 (17, 20), (40, 16)])
def test_lane_model_equals_plain_version(B, L, kind, seed):
    args = GENERATORS[kind](seed * 1000 + B + L, B, L)
    want = sw.banded_sw_ref(*(torch.from_numpy(a) for a in args))
    got = banded_sw_lanes(*args)
    for name, g, w in zip(("score", "end_i", "end_d"), got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)


@pytest.mark.parametrize("L", [91, 33])
def test_plain_version_matches_jax_on_adversarial_inputs(L):
    B = 264                                 # every kind 33 times
    args = sw_adversarial_inputs(L, B, L)
    want = jax_banded_sw(*(jnp.asarray(a) for a in args))
    got = sw.banded_sw(*(torch.from_numpy(a) for a in args))
    for name, w, g in zip(("score", "end_i", "end_d"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    score = got[0].numpy()
    kind = np.arange(B) % 8
    assert (score[kind == 2] == 0).all()            # fully masked reads
    assert (score[kind == 5] == L).all()            # one base throughout
    assert (score[kind <= 1] > L // 2).mean() > 0.8  # planted indels align
    # ties: a one-base read ends at the first row that reaches L, at d = 0
    assert (got[1].numpy()[kind == 5] == L - 1).all()
    assert (got[2].numpy()[kind == 5] == 0).all()

