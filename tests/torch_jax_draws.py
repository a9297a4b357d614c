"""JAX's default PRNG (threefry2x32, partitionable) in NumPy, for the
port's tests.

The bit engines' tests feed the JAX package's own draws to the port. A
jitted JAX draw helper costs about a second of compile per new shape, so
the keys, splits, fold-ins and uniforms of ``jax.random`` are recomputed
here bit for bit: every draw-exact test of ``tests/test_torch_clifford.py``,
``test_torch_qec.py`` and ``test_torch_qec_circuit.py`` feeds these values
to the port and JAX's keys to the JAX function, so a wrong bit fails it.
Keys are ``(2,)`` uint32 arrays, or ``(..., 2)`` batches.
"""

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds), elementwise over uint32."""
    with np.errstate(over="ignore"):
        ks = (np.asarray(k1, np.uint32), np.asarray(k2, np.uint32),
              np.asarray(k1, np.uint32) ^ np.asarray(k2, np.uint32)
              ^ np.uint32(0x1BD11BDA))
        x = [np.asarray(x1, np.uint32) + ks[0],
             np.asarray(x2, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off (JAX's default):
    the seed is cut to its low 32 bits, the high word is 0."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def key_from_seed(seed: int) -> np.ndarray:
    """The JAX package's ``utils.seeding.key_from_seed``: the low word
    as the key, the high word folded in."""
    k = key(seed)
    return fold_in(k, int(seed) >> 32) if int(seed) >> 32 else k


def _iota(n: int):
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(np.uint32), \
        (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(k: np.ndarray, n: int = 2) -> np.ndarray:
    """``jax.random.split(k, n)`` -> (n, 2); batched over ``k[..., 2]``."""
    hi, lo = _iota(n)
    b1, b2 = _threefry(k[..., :1], k[..., 1:], hi, lo)
    return np.stack([b1, b2], axis=-1)


def fold_in(k: np.ndarray, data) -> np.ndarray:
    """``jax.random.fold_in(k, data)``; batched over ``k[..., 2]``."""
    b1, b2 = _threefry(k[..., 0], k[..., 1], np.uint32(0),
                       np.uint32(int(data)))
    return np.stack([b1, b2], axis=-1)


def bits(k: np.ndarray, n: int) -> np.ndarray:
    """32-bit random words ``(..., n)`` of ``jax.random.bits``."""
    hi, lo = _iota(n)
    b1, b2 = _threefry(k[..., :1], k[..., 1:], hi, lo)
    return b1 ^ b2


def uniform(k: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.uniform(k, (n,))`` float32; batched over keys."""
    w = (bits(k, n) >> np.uint32(9)) | np.uint32(0x3F800000)
    return np.maximum(w.view(np.float32) - np.float32(1), np.float32(0))


def bernoulli(k: np.ndarray, n: int, p: float = 0.5) -> np.ndarray:
    """``jax.random.bernoulli(k, p, (n,))``."""
    return uniform(k, n) < np.float32(p)
