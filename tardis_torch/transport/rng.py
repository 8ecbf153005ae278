"""Counter-based threefry2x32 random numbers, bit-exact with ``jax.random``.

The transport loop and the packet source draw every random number from a
key derived only from (seed, iteration, packet id, event index), as the JAX
package does with ``jax_threefry_partitionable=True``.  Reproducing those
bits makes per-packet trajectories of the two packages comparable.

- ``key(seed)``: the raw key of ``jax.random.key(np.uint32(seed))``, (0, seed).
- ``fold_in(k, d)``: threefry2x32(k, (0, d)).
- ``random_bits(k, n)``: element i is y0 ^ y1 of threefry2x32(k, (0, i)).
  A draw of shape ``()`` takes counter 0, the first element of any
  ``(n,)`` draw under the same key (``scalar_bits``).
- ``uniform``: (bits >> 9) | 0x3F800000 bit-cast to f32, minus 1, then
  ``max(minval, f * (maxval - minval) + minval)`` in f32.

Every function works on Python ints and on int64 tensors alike: uint32
arithmetic is emulated in int64 and masked with 0xFFFFFFFF.  The CUDA
kernels use the same hash from ``csrc/threefry.cuh``.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 hash of counters (x0, x1) under key (k0, k1).

    Arguments are uint32 values held as Python ints or int64 tensors
    (broadcasting as usual); returns the pair (y0, y1) in the same form.
    """
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def key(seed: int):
    """Raw threefry key of ``jax.random.key(np.uint32(seed))``."""
    return (0, int(seed) & MASK32)


def fold_in(k, data):
    """``jax.random.fold_in``: data is a uint32 int or int64 tensor."""
    return threefry2x32(k[0], k[1], 0, data)


def random_bits(k, counters):
    """32-bit draws at the given counters (partitionable layout)."""
    y0, y1 = threefry2x32(k[0], k[1], 0, counters)
    return y0 ^ y1


def scalar_bits(k):
    """The 32 bits of ``jax.random.uniform(k, ())``: counter 0."""
    return random_bits(k, 0)


def bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (int64 tensor) -> f32 in [0, 1), as ``jax.random``."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(bits: torch.Tensor, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform`` in f32 from its 32-bit draws."""
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, bits_to_unit_float(bits) * (hi - lo) + lo)
