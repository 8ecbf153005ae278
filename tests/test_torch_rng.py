"""Port RNG: threefry2x32 key / fold_in / uniform bit-equal to jax.random."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tardis_torch.transport import rng

torch.set_num_threads(2)

SEEDS = [0, 7, 23111963, 2**32 - 1]


def _jax_key_words(k):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_bits(seed):
    base = jax.random.key(np.uint32(seed))
    assert _jax_key_words(base) == rng.key(seed)
    pids = np.array([0, 1, 2, 255, 65535, 2**31 + 5], np.uint32)
    folded = jax.vmap(lambda p: jax.random.key_data(
        jax.random.fold_in(base, p)))(jnp.asarray(pids))
    k0, k1 = rng.fold_in(rng.key(seed), torch.as_tensor(pids.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(folded)[:, 0], k0.numpy())
    np.testing.assert_array_equal(np.asarray(folded)[:, 1], k1.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_step_uniforms_bit_equal(seed):
    """The transport loop's (10,) draws at (seed, packet id, event index)."""
    base = jax.random.key(np.uint32(seed))
    pids = np.repeat(np.array([0, 3, 1000, 2**20 + 1], np.uint32), 5)
    eidx = np.tile(np.array([0, 1, 17, 999, 65537], np.uint32), 4)

    def one(p, e):
        k = jax.random.fold_in(jax.random.fold_in(base, p), e)
        return jax.random.uniform(k, (10,), jnp.float32, minval=1e-9,
                                  maxval=1.0)

    ref = np.asarray(jax.vmap(one)(jnp.asarray(pids), jnp.asarray(eidx)))
    kp = rng.fold_in(rng.key(seed), torch.as_tensor(pids.astype(np.int64)))
    ke = rng.fold_in(kp, torch.as_tensor(eidx.astype(np.int64)))
    bits = rng.random_bits((ke[0][:, None], ke[1][:, None]),
                           torch.arange(10)[None, :])
    got = rng.uniform(bits, 1e-9, 1.0).numpy()
    np.testing.assert_array_equal(ref.view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_source_uniforms_bit_equal(seed):
    """The packet source's (6,) draws under fold_in(source key, pid)."""
    src = jax.random.fold_in(jax.random.key(np.uint32(seed)), 4)
    pids = np.arange(0, 4096, 37, dtype=np.uint32)
    ref = np.asarray(jax.vmap(lambda p: jax.random.uniform(
        jax.random.fold_in(src, p), (6,), jnp.float32))(jnp.asarray(pids)))
    k = rng.fold_in(rng.fold_in(rng.key(seed), 4),
                    torch.as_tensor(pids.astype(np.int64)))
    got = rng.uniform(rng.random_bits((k[0][:, None], k[1][:, None]),
                                      torch.arange(6)[None, :])).numpy()
    np.testing.assert_array_equal(ref.view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_scalar_draw_bit_equal(seed):
    """``jax.random.uniform(k, ())``, the relativistic pool's mu draw under
    fold_in(fold_in(source key, pid), 7), takes counter 0: the first
    column of any (n,) draw under the same key."""
    src = jax.random.fold_in(jax.random.key(np.uint32(seed)), 4)
    pids = np.arange(0, 4096, 37, dtype=np.uint32)
    ref = np.asarray(jax.vmap(lambda p: jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(src, p), 7), (),
        jnp.float32))(jnp.asarray(pids)))
    k = rng.fold_in(rng.fold_in(rng.fold_in(rng.key(seed), 4),
                                torch.as_tensor(pids.astype(np.int64))), 7)
    got = rng.uniform(rng.scalar_bits(k)).numpy()
    np.testing.assert_array_equal(ref.view(np.uint32), got.view(np.uint32))
    col0 = rng.uniform(rng.random_bits((k[0][:, None], k[1][:, None]),
                                       torch.arange(3)[None, :]))[:, 0]
    assert torch.equal(torch.as_tensor(got), col0)
