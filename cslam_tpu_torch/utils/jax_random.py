"""The reference package's fixed-seed start vectors, reproduced in numpy.

The JAX solvers start their eigenvector iterations from
`jax.random.normal(jax.random.PRNGKey(seed), shape, float32)` with fixed
seeds (MAC's Frank-Wolfe carry, the inverse-iteration default start).
Iteration counts and near-tie decisions depend on the start vector, so
the port starts from the same numbers. This module re-implements that
draw without importing JAX: Threefry-2x32 over a flat counter (the
"partitionable" bit layout), the mantissa trick of `jax.random.uniform`
on (nextafter(-1, 0), 1), and XLA's single-precision `erf_inv` (Giles'
polynomial). The values agree with JAX's to within one or two units in
the last place of float32.
"""

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def _threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 hash of the counter pair (x0, x1) under key (k1, k2),
    20 rounds, as the reference's PRNG computes it."""
    with np.errstate(over="ignore"):
        ks = [np.uint32(k1), np.uint32(k2),
              np.uint32(k1) ^ np.uint32(k2) ^ np.uint32(0x1BD11BDA)]
        x = [x0 + ks[0], x1 + ks[1]]
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r)
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def random_bits(seed: int, shape) -> np.ndarray:
    """32-bit random words of `jax.random.PRNGKey(seed)` for `shape`."""
    n = int(np.prod(shape))
    k1 = np.uint32((seed >> 32) & 0xFFFFFFFF)
    k2 = np.uint32(seed & 0xFFFFFFFF)
    lo = np.arange(n, dtype=np.uint64)
    c_hi = (lo >> np.uint64(32)).astype(np.uint32)
    c_lo = (lo & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b1, b2 = _threefry2x32(k1, k2, c_hi, c_lo)
    return (b1 ^ b2).reshape(shape)


_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erf_inv_f32(x: np.ndarray) -> np.ndarray:
    """Single-precision inverse error function (Giles' polynomial, the
    form XLA lowers `erf_inv` to)."""
    f = np.float32
    x = x.astype(f)
    w = -np.log1p(-x * x).astype(f)
    small = w < f(5.0)
    w = np.where(small, w - f(2.5), np.sqrt(w) - f(3.0)).astype(f)
    p = np.where(small, f(_ERFINV_SMALL[0]), f(_ERFINV_LARGE[0])).astype(f)
    w64 = w.astype(np.float64)
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        # one rounding per Horner step, as the fused multiply-add XLA
        # emits on the CPU
        c = np.where(small, f(cs), f(cl)).astype(np.float64)
        p = (c + p.astype(np.float64) * w64).astype(f)
    out = (p * x).astype(f)
    return np.where(np.abs(x) == f(1.0), x * f(np.inf), out).astype(f)


def normal(seed: int, shape) -> np.ndarray:
    """`jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32)`."""
    f = np.float32
    shape = tuple(int(s) for s in shape)
    bits = random_bits(seed, shape)
    fbits = (bits >> np.uint32(32 - 23)) | np.uint32(0x3F800000)
    floats = fbits.view(np.float32) - f(1.0)
    lo = np.nextafter(f(-1.0), f(0.0), dtype=f)
    hi = f(1.0)
    u = np.maximum(lo, (floats * (hi - lo) + lo).astype(f)).astype(f)
    return (f(np.sqrt(2)) * erf_inv_f32(u)).astype(f)


def uniform(seed: int, shape) -> np.ndarray:
    """`jax.random.uniform(jax.random.PRNGKey(seed), shape, float32)` on
    [0, 1): the 23 mantissa bits of each word under exponent 0, minus 1."""
    shape = tuple(int(s) for s in shape)
    bits = random_bits(seed, shape)
    fbits = (bits >> np.uint32(32 - 23)) | np.uint32(0x3F800000)
    return (fbits.view(np.float32) - np.float32(1.0)).astype(np.float32)


# XLA's CPU pipeline rewrites a cumulative sum longer than this into
# blocks of this length (its reduce-window rewriter): a sequential sum
# inside each block, plus the sequential sum of the earlier blocks' totals
_CUMSUM_BLOCK = 16


def xla_cumsum_f32(x: np.ndarray) -> np.ndarray:
    """`jnp.cumsum` of a float32 vector as the reference's CPU backend
    rounds it (see _CUMSUM_BLOCK); a prefix sum in another order can
    differ in the last place."""
    x = np.asarray(x, np.float32).reshape(-1)
    n = x.shape[0]
    if n <= _CUMSUM_BLOCK:
        return np.cumsum(x, dtype=np.float32)
    nb = -(-n // _CUMSUM_BLOCK)
    blocks = np.zeros(nb * _CUMSUM_BLOCK, np.float32)
    blocks[:n] = x
    within = np.cumsum(blocks.reshape(nb, _CUMSUM_BLOCK), axis=1,
                       dtype=np.float32)
    # exclusive prefix of the block totals: 0, b0, b0 + b1, ...
    before = np.concatenate([np.zeros(1, np.float32),
                             xla_cumsum_f32(within[:-1, -1])])
    return (within + before[:, None]).reshape(-1)[:n].astype(np.float32)


def choice_p(seed: int, n: int, shape, p: np.ndarray) -> np.ndarray:
    """`jax.random.choice(PRNGKey(seed), n, shape, replace=True, p=p)`:
    r = cumsum(p)[-1] * (1 - uniform), then the first index whose
    cumulative probability reaches r. int32 indices of `shape`."""
    p_cuml = xla_cumsum_f32(np.asarray(p, np.float32))
    if p_cuml.shape[0] != n:
        raise ValueError(f"p has {p_cuml.shape[0]} entries, expected {n}")
    r = (p_cuml[-1] * (np.float32(1.0) - uniform(seed, shape))).astype(
        np.float32)
    return np.searchsorted(p_cuml, r, side="left").astype(np.int32)
