"""Port packet source (K2's plain version) against the JAX blackbody pool."""

import jax
import numpy as np
import pytest
import torch

from tardis_torch.transport import rng
from tardis_torch.transport.source import blackbody_source
from tardis_tpu.transport.source import sample_blackbody_packets

torch.set_num_threads(2)

N = 4096


@pytest.mark.parametrize("seed,iteration,t_inner", [
    (23, 0, 10102.0), (23111963, 3, 9000.0), (2**32 - 1, 1, 14500.0),
])
def test_pool_matches_jax(seed, iteration, t_inner):
    """Same threefry bits; mu and nu differ at most by libm ulps."""
    jkey = jax.random.fold_in(jax.random.key(np.uint32(seed)), 2 * iteration)
    mu_j, nu_j = (np.asarray(a) for a in
                  sample_blackbody_packets(jkey, N, t_inner))
    key = rng.fold_in(rng.key(seed), 2 * iteration)
    mu, nu, w = blackbody_source(key, N, t_inner, "cpu")
    assert mu.dtype == nu.dtype == torch.float32 and w is None
    np.testing.assert_allclose(mu.numpy(), mu_j, rtol=1e-6)
    np.testing.assert_allclose(nu.numpy(), nu_j, rtol=1e-6)
    assert not blackbody_source.launches_by_variant  # CPU tensors never launch


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        blackbody_source(rng.key(1), 8, 1e4, "meta")
