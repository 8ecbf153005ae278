"""Counter-based threefry2x32 (Salmon et al. 2011, 20 rounds), the bits
``jax.random`` draws with partitionable keys, in int64 tensor arithmetic.

- ``key(seed)`` is (0, seed); ``fold_in(k, d)`` hashes counters (0, d);
- ``bits(k, i)`` is y0 ^ y1 of the hash of counters (0, i);
- ``uniform(bits)`` takes the top 23 bits as an f32 mantissa in [1, 2),
  less 1, then ``max(lo, f * (hi - lo) + lo)`` in f32.
"""

import torch

MASK32 = 0xFFFFFFFF
PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def key(seed: int):
    return (0, int(seed) & MASK32)


def fold_in(k, data):
    return threefry2x32(k[0], k[1], 0, data)


def bits(k, counters):
    y0, y1 = threefry2x32(k[0], k[1], 0, counters)
    return y0 ^ y1


def uniform(b: torch.Tensor, lo: float = 0.0, hi: float = 1.0):
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo_t = torch.tensor(lo, dtype=torch.float32, device=b.device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=b.device)
    return torch.maximum(lo_t, f * (hi_t - lo_t) + lo_t)
