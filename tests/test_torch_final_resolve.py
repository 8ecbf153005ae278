"""The final iteration re-solves the plasma where the JAX package does.

The JAX package re-solves the plasma at the start of ``run_final`` only
where its convergence loop solved it in device-line mode
(``tardis_tpu/simulation/base.py:252-285,433-441``): the classic solver
with the chain tables engaged, no detailed rates, no NLTE species.  A
re-solve takes one more step of the n_e fixpoint, so a port that
re-solved elsewhere (the walk, ``detailed``, NLTE) would part from the
JAX package's final n_e by ~4e-3, and under ``detailed`` rates would
drop the estimator j_blues.  Both packages run test_torch_slice's
configuration (2,048 / 4,096 packets, one convergence iteration: the
re-solve does not depend on how many ran) and must both change the
convergence loop's electron densities in ``run_final`` or both leave them
bit for bit.
"""

import copy

import numpy as np
import pytest
import torch

from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.config.reader import config_from_dict as torch_config
from tardis_torch.simulation.base import Simulation as TorchSimulation
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.simulation.base import Simulation

from tests.test_torch_slice import CONFIG

torch.set_num_threads(2)

# case -> (config changes, use_macro_chain, whether run_final re-solves)
CASES = {
    "chain": ({}, "auto", True),
    "walk": ({}, False, False),
    "detailed": ({"radiative_rates_type": "detailed"}, "auto", False),
    "nlte": ({"nlte": {"species": ["Si 2"]}}, "auto", False),
}


def final_electron_densities(package, cfg, atom, use_macro_chain):
    """(n_e after the convergence loop, n_e the final iteration ran on)."""
    if package == "jax":
        sim = Simulation.from_config(config_from_dict(cfg), atom_data=atom)
    else:
        sim = TorchSimulation.from_config(torch_config(cfg), atom_data=atom,
                                          device="cpu")
    sim.transport.use_macro_chain = use_macro_chain
    with torch.no_grad():
        sim.run_convergence()
        before = sim.plasma_state.electron_densities.copy()
        sim.run_final()
    return before, sim.plasma_state.electron_densities


@pytest.mark.parametrize("case", CASES)
def test_final_resolve_follows_the_jax_package(atom_data_prepared, case):
    plasma, use_macro_chain, resolves = CASES[case]
    cfg = copy.deepcopy(CONFIG)
    cfg["montecarlo"]["iterations"] = 2
    cfg["plasma"].update(copy.deepcopy(plasma))
    port_atom = atom_data_from_arrays(atom_data_to_arrays(atom_data_prepared))
    finals = []
    for package, atom in (("jax", atom_data_prepared), ("torch", port_atom)):
        before, after = final_electron_densities(
            package, copy.deepcopy(cfg), atom, use_macro_chain)
        assert (not np.array_equal(before, after)) == resolves, package
        finals.append(after)
    # the two packages' final n_e: same fixpoint steps, correlated runs
    np.testing.assert_allclose(finals[1], finals[0], rtol=2e-3)
