"""The reference's fold permutation, reproduced bit for bit in numpy.

The reference draws its cross-validation folds with
``jax.random.permutation(jax.random.PRNGKey(seed), n)``
(``grid_search_ridge``). A port that drew other folds could choose another
ridge penalty, so the models would differ. This module repeats that draw:
the Threefry-2x32 hash (20 rounds, Salmon et al. 2011), JAX's
partitionable key split and 32-bit random bits, and its shuffle, which
sorts ``arange(n)`` by fresh random 32-bit keys (a stable sort)
``ceil(3 ln n / ln(2^32 - 1))`` times: once for n <= 1625, twice above.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray,
                 x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counter pairs ``(x0, x1)`` (uint32 arrays of
    one shape) under ``key``; returns the two hashed uint32 words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0],
             np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = x[0] ^ _rotl(x[1], r)
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> Tuple[int, int]:
    """The raw key of ``jax.random.PRNGKey(seed)``: the seed's high and
    low 32 bits."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (seed >> 32, seed & 0xFFFFFFFF)


def _counters(n: int) -> Tuple[np.ndarray, np.ndarray]:
    idx = np.arange(n, dtype=np.uint64)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(key: Tuple[int, int], num: int = 2):
    """``jax.random.split(key, num)`` in partitionable mode: key ``i`` is
    the hash of the counter ``i``."""
    b0, b1 = threefry2x32(key, *_counters(num))
    return [(int(b0[i]), int(b1[i])) for i in range(num)]


def random_bits32(key: Tuple[int, int], n: int) -> np.ndarray:
    """``n`` 32-bit random words (``jax.random.bits``, partitionable)."""
    b0, b1 = threefry2x32(key, *_counters(n))
    return b0 ^ b1


def permutation(seed: int, n: int) -> np.ndarray:
    """``jax.random.permutation(jax.random.PRNGKey(seed), n)`` as int64."""
    x = np.arange(n, dtype=np.int64)
    rounds = int(math.ceil(3 * math.log(max(1, n))
                           / math.log(np.iinfo(np.uint32).max)))
    key = prng_key(seed)
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits32(sub, n), kind="stable")]
    return x
