"""The port's jax-free threefry PRNG (cellranger_tpu_torch/analysis/prng.py)
against `jax.random` (JAX 0.9, jax_threefry_partitionable on): keys,
splits, raw bits, uniform floats, randint and choice (with and without p)
are equal bit for bit for seeds 0, 1, 7 and 2**31 - 1 and odd shapes;
normal is within 4 ulp (measured at most 3 ulp: XLA's float32 log1p is
its own approximation, which erf_inv reads)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cellranger_tpu_torch.analysis import prng

SEEDS = (0, 1, 7, 2**31 - 1)
SHAPES = ((), (1,), (7,), (3, 5), (301, 13))
NORMAL_MAX_ULP = 4


def _ulp_diff(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_bits_uniform_equal_jax(seed):
    jk = jax.random.PRNGKey(seed)
    k = prng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(jk), k)
    for num in (2, 3, 5):
        np.testing.assert_array_equal(np.asarray(jax.random.split(jk, num)),
                                      prng.split(k, num))
    # the key chain kmeans_fit walks: split, then split the carried key
    jkey, kkey = jk, k
    for _ in range(4):
        jkey, jsub = jax.random.split(jkey)
        kkey, ksub = prng.split(kkey)
        np.testing.assert_array_equal(np.asarray(jsub), ksub)
    for shape in SHAPES:
        np.testing.assert_array_equal(
            np.asarray(jax.random.bits(jk, shape, jnp.uint32)),
            prng.bits(k, shape))
        ju = np.asarray(jax.random.uniform(jk, shape))
        u = prng.uniform(k, shape)
        assert _ulp_diff(ju, u) == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_ulps_of_jax(seed):
    k = prng.PRNGKey(seed)
    for shape in SHAPES + ((2000, 20),):
        jn = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
        n = prng.normal(k, shape)
        assert n.dtype == np.float32 and n.shape == jn.shape
        assert _ulp_diff(jn, n) <= NORMAL_MAX_ULP, shape


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_and_choice_equal_jax(seed):
    jk = jax.random.PRNGKey(seed)
    k = prng.PRNGKey(seed)
    for shape in SHAPES:
        for n in (1, 2, 3, 200, 1000, 70_000, 2**31 - 1):
            jr = np.asarray(jax.random.randint(jk, shape, 0, n))
            r = prng.randint(k, shape, 0, n)
            assert jr.dtype == r.dtype
            np.testing.assert_array_equal(jr, r)
            np.testing.assert_array_equal(
                np.asarray(jax.random.choice(jk, n, shape)),
                prng.choice(k, n, shape))
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(jk, shape, -5, 17)),
            prng.randint(k, shape, -5, 17))
        # k-means++ seeding draws one index with p = d2 / sum(d2)
        for n in (5, 16, 17, 1000, 4097):
            p = np.random.default_rng(n).random(n).astype(np.float32) ** 3
            p[::7] = 0.0
            p /= p.sum()
            np.testing.assert_array_equal(
                np.asarray(jax.random.choice(jk, n, shape,
                                             p=jnp.asarray(p))),
                prng.choice(k, n, shape, p=p))


@pytest.mark.parametrize("n", [1, 15, 16, 17, 255, 256, 257, 4097, 70_001])
def test_cumsum_follows_xla_cpu_order(n):
    p = np.random.default_rng(n).random(n).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jnp.cumsum(jnp.asarray(p))),
                                  prng.xla_cumsum(p))
