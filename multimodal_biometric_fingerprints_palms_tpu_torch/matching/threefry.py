"""Threefry-2x32 uniforms in numpy, equal bit for bit to
``jax.random.uniform(jax.random.PRNGKey(seed), (n, 2), jnp.float32)``.

The matcher's hypotheses are driven by one pair-independent (H, 2) draw
(``ransac.hypothesis_uniforms``); reproducing JAX's stream lets the port
sample exactly the hypotheses the JAX package samples, with no JAX at run
time. The layout is JAX's partitionable threefry (``jax_threefry_partitionable``,
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


def uniform(seed: int, shape: tuple[int, ...]) -> np.ndarray:
    """float32 uniforms in [0, 1) of ``shape`` for ``PRNGKey(seed)``."""
    if not 0 <= seed < 2 ** 32:
        # JAX without 64-bit mode keys only 32-bit seeds
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    n = int(np.prod(shape, dtype=np.int64))
    e = np.arange(n, dtype=np.uint64)
    y0, y1 = threefry2x32((0, seed),
                          (e >> np.uint64(32)).astype(np.uint32),
                          (e & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    bits = y0 ^ y1
    mant = (bits >> np.uint32(9)) | np.uint32(0x3F800000)
    return (mant.view(np.float32) - np.float32(1.0)).reshape(shape)
