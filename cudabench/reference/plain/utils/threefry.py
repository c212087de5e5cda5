# Frozen copy of the port's ``utils/threefry.py`` for the benchmark's reference:
# the CUDA wrappers are removed and every dispatcher calls the plain
# twin on any device. Edit only to follow a change of semantics.
"""Threefry-2x32 draws equal bit for bit to ``jax.random``'s, as
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

Training adds ``fold_in``, flax's ``fold_in_static`` (how a module path
picks its dropout key), ``bernoulli`` and ``normal_tensor``. One block
function serves every draw: int64 arithmetic masked to 32 bits, which runs
alike on numpy arrays (the host's scalars) and on tensors (the dropout
masks and the augmentation noise, drawn on the card). ``split``,
``fold_in``, ``random_bits``, ``uniform_from``, ``randint`` and
``bernoulli`` take one key or a batch of keys, an (..., 2) array of words;
a tensor of keys draws on its device.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF


def threefry2x32(k0, k1, x0, x1):
    """The 20-round Threefry-2x32 block function in int64 arithmetic masked
    to 32 bits: the same code on numpy arrays and on tensors (on any
    device), each holding uint32 words; keys broadcast against counters."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


Key = tuple  # (k0, k1): two 32-bit words, ``jax.random.key_data`` of a key


def key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed."""
    if not 0 <= seed < 2 ** 32:
        # JAX without 64-bit mode keys only 32-bit seeds
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    return (0, int(seed))


def _words(k):
    """A key, or a batch of keys as an (..., 2) numpy array or tensor, as
    int64 words (..., 2) of the same kind."""
    if isinstance(k, torch.Tensor):
        return k.to(torch.int64)
    return np.asarray(k, np.int64)


def _single(k) -> bool:
    return not isinstance(k, (np.ndarray, torch.Tensor))


def _stack(kk, y0, y1):
    return (torch.stack if isinstance(kk, torch.Tensor) else np.stack)(
        [y0, y1], -1)


def _blocks(kk, n: int):
    """Threefry of the 64-bit counters 0 .. n-1 under each key of the words
    ``kk`` (..., 2): two word arrays of shape ``kk.shape[:-1] + (n,)``."""
    if isinstance(kk, torch.Tensor):
        e = torch.arange(n, dtype=torch.int64, device=kk.device)
    else:
        e = np.arange(n, dtype=np.int64)
    return threefry2x32(kk[..., :1], kk[..., 1:], e >> 32, e & _M32)


def split(k, num: int = 2):
    """``jax.random.split(k, num)``: key ``i`` is the block of counter i.
    A list of keys for one key; (..., num, 2) words for a batch of keys."""
    kk = _words(k)
    y0, y1 = _blocks(kk, num)
    if _single(k):
        return [(int(a), int(b)) for a, b in zip(y0, y1)]
    return _stack(kk, y0, y1)


def random_bits(k, shape: tuple[int, ...]):
    """32 random bits an element of ``shape`` (``jax.random.bits``) under
    each key of ``k``: ``batch + shape`` uint32 in numpy, or int64 on the
    device of a tensor of keys."""
    kk = _words(k)
    y0, y1 = _blocks(kk, int(np.prod(shape, dtype=np.int64)))
    bits = (y0 ^ y1).reshape(tuple(kk.shape[:-1]) + tuple(shape))
    return bits if isinstance(kk, torch.Tensor) else bits.astype(np.uint32)


def _unit(bits):
    """Floats in [0, 1) from the top 23 of 32 random bits, exactly."""
    mant = (bits >> 9) | 0x3F800000
    if isinstance(mant, torch.Tensor):
        return mant.to(torch.int32).view(torch.float32) - 1.0
    return mant.astype(np.uint32).view(np.float32) - np.float32(1.0)


def uniform_from(k, shape: tuple[int, ...], minval: float = 0.0,
                 maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(k, shape, float32, minval, maxval)`` under
    each key of ``k`` (numpy)."""
    floats = _unit(random_bits(k, shape))
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


def randint(k, shape: tuple[int, ...], minval: int,
            maxval: int) -> np.ndarray:
    """``jax.random.randint(k, shape, minval, maxval)`` in int32 under each
    key of ``k`` (numpy): two 32-bit draws from the two halves of
    ``split(k)``, folded into the span by JAX's modular arithmetic (its
    uint32 products wrap as JAX's do)."""
    lo_i, hi_i = np.int64(minval), np.int64(maxval)
    lo_i = np.clip(lo_i, -2 ** 31, 2 ** 31 - 1)
    hi_i = np.clip(hi_i, -2 ** 31, 2 ** 31 - 1)
    halves = split(np.asarray(k, np.int64))
    higher = random_bits(halves[..., 0, :], shape)
    lower = random_bits(halves[..., 1, :], shape)
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


def fold_in(k, data):
    """``jax.random.fold_in(k, data)``: the block of the word pair ``(0,
    data)``. A key for one key and an int; (..., 2) words where ``k`` is a
    batch or ``data`` an array (broadcast against each other)."""
    kk = _words(k)
    if isinstance(kk, torch.Tensor):
        d = torch.as_tensor(data, dtype=torch.int64, device=kk.device) & _M32
    else:
        d = np.asarray(data, np.int64) & _M32
    y0, y1 = threefry2x32(kk[..., 0], kk[..., 1], d * 0, d)
    if _single(k) and np.ndim(data) == 0:
        return (int(y0), int(y1))
    return _stack(kk, y0, y1)


def fold_in_static(k: Key, data: tuple) -> Key:
    """flax's ``_fold_in_static``: the first 4 bytes (big-endian) of the
    SHA-1 of the strings (UTF-8) and ints (big-endian, fewest bytes) of
    ``data``, folded into ``k``. A module's ``make_rng`` folds in its path
    and its call count: ``("projection_head", "Dropout_0", 1)``."""
    if not data:
        return k
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"expected int or str, got {x!r}")
    return fold_in(k, int.from_bytes(m.digest()[:4], byteorder="big"))


def bernoulli(k, p: float, shape: tuple[int, ...]):
    """``jax.random.bernoulli(k, p, shape)``: float32 uniforms below
    ``float32(p)``; a bool tensor on the keys' device for a tensor key."""
    return _unit(random_bits(k, shape)) < np.float32(p)


_NORMAL_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))   # normal's u


# --- draws on a device ---------------------------------------------------

def _on(keys, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(keys, np.int64).reshape(-1, 2),
                           device=device)


def random_bits_tensor(keys, n: int, device) -> torch.Tensor:
    """(len(keys), n) int64 tensor on ``device``: row ``i`` is
    ``random_bits(keys[i], (n,))``, computed there."""
    return random_bits(_on(keys, device), (n,))


def normal_tensor(keys, shape: tuple[int, ...], device) -> torch.Tensor:
    """(len(keys),) + ``shape`` float32 standard normals on ``device``, row
    ``i`` ``jax.random.normal(keys[i], shape)``: the uniform on (-1, 1) from
    the top 23 bits (its scaling rounded once, through float64), then
    ``sqrt(2) * erfinv(u)`` in float32. The bits are JAX's; ``erfinv`` may
    differ from XLA's in the last place."""
    kk = _on(keys, device)
    floats = _unit(random_bits(kk, shape)).to(torch.float64)
    lo = float(_NORMAL_LO)
    span = float(np.float32(1.0) - _NORMAL_LO)
    u = torch.clamp((floats * span + lo).to(torch.float32), min=lo)
    return torch.erfinv(u) * float(np.float32(np.sqrt(2)))
