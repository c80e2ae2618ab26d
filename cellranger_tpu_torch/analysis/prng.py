"""Threefry-2x32 random numbers that equal `jax.random`'s, without jax.

The JAX package's secondary analysis draws its PCA start basis, its
k-means++ seeds and its t-SNE start from `jax.random` keys
(analysis/pca.py:28-29, kmeans.py:22-38, tsne.py:110-111).  A
`torch.Generator` gives other, equally valid numbers, which turn into
another PCA basis and other k-means seeds; this module computes the same
numbers as JAX 0.9 with `jax_threefry_partitionable` on (its default), so
that the port's labels can equal the JAX package's.

Everything runs in numpy on the host: the draws are small (a `[f, k]`
normal matrix, one index per seeding step, an `[n, 2]` start) and are
uploaded by the caller.  A key is a uint32 array of shape (2,); it is the
port's explicit generator.

Where each function comes from (jax 0.9):
  PRNGKey   `_src/prng.py` `threefry_seed`
  split     `_src/prng.py` `_threefry_split_foldlike` over `iota_2x32_shape`
  bits      `_src/prng.py` `_threefry_random_bits_partitionable` (32-bit)
  uniform   `_src/random.py` `_uniform`
  normal    `_src/random.py` `_normal_real`: sqrt(2) * erf_inv(u) with
            erf_inv the Giles polynomial XLA evaluates in float32
  randint   `_src/random.py` `_randint` (int32 results)
  choice    `_src/random.py` `choice`, with replacement, with and without p
"""

from __future__ import annotations

import math

import numpy as np

_M32 = np.uint64(0xFFFFFFFF)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of counter pairs (x1, x2) under
    the key (k1, k2); uint32 in, uint32 out, wrapping like XLA's u32."""
    k1 = np.asarray(k1, np.uint32).reshape(1)
    k2 = np.asarray(k2, np.uint32).reshape(1)
    ks = [k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA)]
    shape = np.shape(x1)
    x = [np.asarray(x1, np.uint32).reshape(-1) + ks[0],
         np.asarray(x2, np.uint32).reshape(-1) + ks[1]]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0].reshape(shape), x[1].reshape(shape)


def _iota_2x32(shape) -> tuple[np.ndarray, np.ndarray]:
    """(hi, lo) uint32 halves of a uint64 iota over `shape`."""
    idx = np.arange(math.prod(shape), dtype=np.uint64).reshape(shape)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & _M32).astype(np.uint32))


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 (jax's name)
    """jax.random.PRNGKey(seed) for a 32-bit seed (jax without x64)."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise OverflowError(f"seed {seed} does not fit in int32")
    return np.asarray([0, seed & 0xFFFFFFFF], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """jax.random.split(key, num) -> uint32 [num, 2]."""
    hi, lo = _iota_2x32((num,))
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return np.stack([b1, b2], axis=1)


def bits(key: np.ndarray, shape=()) -> np.ndarray:
    """32 random bits per element (jax.random.bits(key, shape, uint32))."""
    hi, lo = _iota_2x32(tuple(shape))
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return b1 ^ b2


def uniform(key: np.ndarray, shape=(), minval=0.0,
            maxval=1.0) -> np.ndarray:
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    minval, maxval = np.float32(minval), np.float32(maxval)
    b = (bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = b.view(np.float32) - np.float32(1.0)
    return np.maximum(minval, floats * (maxval - minval) + minval)


# Giles' single-precision erfinv, the coefficients XLA's ErfInv uses
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """float32 erf^-1 by the polynomial XLA evaluates, its Horner steps
    fused multiply-adds as XLA:CPU emits them.  XLA's float32 log1p is
    its own approximation, so the result can differ from jax's in the
    last bits (tests/test_torch_prng.py states the measured bound)."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore"):
        w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    w64 = w.astype(np.float64)
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = np.where(lt, np.float32(c_lt), np.float32(c_ge))
        # the float32 product is exact in float64, so this rounds like an
        # fma except for a rare double rounding
        p = (c.astype(np.float64) + p.astype(np.float64) * w64) \
            .astype(np.float32)
    out = (p * x).astype(np.float32)
    edge = np.abs(x) == np.float32(1.0)
    return np.where(edge, x * np.float32(np.inf), out).astype(np.float32)


def normal(key: np.ndarray, shape=()) -> np.ndarray:
    """jax.random.normal(key, shape, float32)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, np.float32(1.0))
    return (np.float32(np.sqrt(2)) * erf_inv(u)).astype(np.float32)


def randint(key: np.ndarray, shape, minval: int, maxval: int) -> np.ndarray:
    """jax.random.randint(key, shape, minval, maxval) with int32 results
    (jax without x64); the double-width modulus and its u32 wrap kept."""
    k1, k2 = split(key)
    higher = bits(k1, shape).astype(np.uint64)
    lower = bits(k2, shape).astype(np.uint64)
    span = np.uint64(1 if maxval <= minval else (maxval - minval) & 0xFFFFFFFF)
    mult = np.uint64(2 ** 16) % span
    mult = (mult * mult & _M32) % span
    off = ((higher % span) * mult & _M32) + lower % span
    off = (off & _M32) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


_SCAN_BASE = 16


def xla_cumsum(p: np.ndarray) -> np.ndarray:
    """float32 `jnp.cumsum` in XLA:CPU's summation order: its rewrite of a
    long scan cuts the array into rows of 16 (zero-padded at the end),
    scans each row in order, scans the row totals the same way, and adds
    the preceding rows' total to each row."""
    p = np.asarray(p, np.float32)
    n = len(p)
    if n <= _SCAN_BASE:
        return np.cumsum(p, dtype=np.float32)
    rows = -(-n // _SCAN_BASE)
    q = np.zeros(rows * _SCAN_BASE, np.float32)
    q[:n] = p
    inner = np.cumsum(q.reshape(rows, _SCAN_BASE), axis=1, dtype=np.float32)
    totals = xla_cumsum(inner[:, -1])
    inner[1:] += totals[:-1, None]
    return inner.reshape(-1)[:n]


def choice(key: np.ndarray, n: int, shape=(), p: np.ndarray | None = None):
    """jax.random.choice(key, n, shape, replace=True, p=p) -> int32 indices.

    With `p`, JAX draws r = cumsum(p)[-1] * (1 - u) and takes the first
    index whose cumulative sum reaches r."""
    if p is None:
        return randint(key, shape, 0, n)
    p = np.asarray(p, np.float32)
    if p.shape != (n,):
        raise ValueError(f"p has shape {p.shape}, expected ({n},)")
    cum = xla_cumsum(p)
    r = cum[-1] * (np.float32(1.0) - uniform(key, shape))
    return np.searchsorted(cum, r, side="left").astype(np.int32)
