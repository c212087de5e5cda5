"""Threefry-2x32 uniforms in numpy, equal bit for bit to
``jax.random.uniform(jax.random.PRNGKey(seed), (n, 2), jnp.float32)``.

The matcher's hypotheses are driven by one pair-independent (H, 2) draw
(``matching/ransac.hypothesis_uniforms``), and kmeans++ seeding by
``split``, ``randint`` and Gumbel draws (``clustering/kmeans.py``);
reproducing JAX's stream lets the port draw exactly what the JAX package
draws, with no JAX at run time. The layout is JAX's partitionable threefry (``jax_threefry_partitionable``,
the default since JAX 0.5): key words ``(0, seed)``;
element ``e`` of the flattened array is hashed from the 64-bit counter
``e`` as the word pair ``(e >> 32, e & 0xffffffff)``; its 32 random bits
are the XOR of the two output words; the float is built from the top 23
bits in [1, 2) and shifted to [0, 1). Element ``e`` depends on ``e``
alone, so a draw of length ``n`` is a prefix of every longer draw.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: tuple[int, int], x0: np.ndarray,
                 x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The 20-round Threefry-2x32 block function on uint32 word arrays."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = x0.astype(np.uint32) + ks[0]
        x1 = x1.astype(np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


Key = tuple  # (k0, k1): two 32-bit words, ``jax.random.key_data`` of a key


def key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed."""
    if not 0 <= seed < 2 ** 32:
        # JAX without 64-bit mode keys only 32-bit seeds
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    return (0, int(seed))


def _blocks(k: Key, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Threefry of the 64-bit counters 0 .. n-1 under ``k``."""
    e = np.arange(n, dtype=np.uint64)
    return threefry2x32(k, (e >> np.uint64(32)).astype(np.uint32),
                        (e & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(k: Key, num: int = 2) -> list[Key]:
    """``jax.random.split(k, num)``: key ``i`` is the block of counter i."""
    y0, y1 = _blocks(k, num)
    return [(int(a), int(b)) for a, b in zip(y0, y1)]


def random_bits(k: Key, shape: tuple[int, ...]) -> np.ndarray:
    """32 random bits an element of ``shape`` (``jax.random.bits``)."""
    y0, y1 = _blocks(k, int(np.prod(shape, dtype=np.int64)))
    return (y0 ^ y1).reshape(shape)


def uniform_from(k: Key, shape: tuple[int, ...], minval: float = 0.0,
                 maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``."""
    mant = (random_bits(k, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = mant.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, _fma32(floats, hi - lo, lo))


def _fma32(a: np.ndarray, b: np.float32, c: np.float32) -> np.ndarray:
    """``a * b + c`` rounded once to float32, as XLA's fused multiply-add
    computes ``uniform``'s scaling. The product of two float32 is exact in
    float64; the sum's float64 rounding error ``e`` (TwoSum) decides the
    one case where rounding twice differs: a float64 sum that lands exactly
    halfway between two float32."""
    p = a.astype(np.float64) * np.float64(b)
    c64 = np.float64(c)
    s = p + c64
    v = s - p
    e = (p - (s - v)) + (c64 - v)
    r = s.astype(np.float32)
    toward = np.nextafter(r, np.where(s > r.astype(np.float64), np.inf,
                                      -np.inf).astype(np.float32))
    mid = (r.astype(np.float64) + toward.astype(np.float64)) / 2.0
    tie = (s == mid) & (e != 0)
    # t = s + e lies on toward's side of the midpoint iff e points there
    pick = tie & ((e > 0) == (toward > r))
    return np.where(pick, toward, r).astype(np.float32)


def uniform(seed: int, shape: tuple[int, ...]) -> np.ndarray:
    """float32 uniforms in [0, 1) of ``shape`` for ``PRNGKey(seed)``."""
    return uniform_from(key(seed), shape)


def randint(k: Key, shape: tuple[int, ...], minval: int,
            maxval: int) -> np.ndarray:
    """``jax.random.randint(k, shape, minval, maxval)`` in int32: two
    32-bit draws from the two halves of ``split(k)``, folded into the span
    by JAX's modular arithmetic (its uint32 products wrap as JAX's do)."""
    lo_i, hi_i = np.int64(minval), np.int64(maxval)
    lo_i = np.clip(lo_i, -2 ** 31, 2 ** 31 - 1)
    hi_i = np.clip(hi_i, -2 ** 31, 2 ** 31 - 1)
    k1, k2 = split(k)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = np.uint32(1 if hi_i <= lo_i else (hi_i - lo_i) & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        mult = np.uint32(2 ** 16) % span
        mult = (mult * mult) % span
        offset = (higher % span) * mult + (lower % span)
        offset = offset % span
        return (np.int32(lo_i) + offset.astype(np.int32)).astype(np.int32)


def gumbel(k: Key, shape: tuple[int, ...]) -> np.ndarray:
    """Standard Gumbel noise as ``jax.random.gumbel(k, shape)`` draws it
    (see the module note on its last ulp)."""
    u = uniform_from(k, shape, np.finfo(np.float32).tiny, 1.0)
    inner = (-np.log(u.astype(np.float64))).astype(np.float32)
    return (-np.log(inner.astype(np.float64))).astype(np.float32)


def categorical(k: Key, logits: np.ndarray) -> int:
    """``jax.random.categorical(k, logits)`` over a 1-D float32 ``logits``:
    the Gumbel-max index (first index on ties, as ``argmax``)."""
    logits = np.asarray(logits, np.float32)
    return int(np.argmax(gumbel(k, logits.shape) + logits))
