"""The large-ion configuration at a CPU size through both packages.

The bench run's configuration on synthetic atomic data whose ions have
400 levels (level jumps up to 20: 18 components of 400 levels, past the
384 that a thread-block cluster of K8 holds, so on the card every chain
build takes K8's large-system instantiation), cut to 3 shells and 2,048
packets over 2 iterations.  The chain tables of one plasma state agree
with the JAX package's (f32 solve there, f64 here) to atol 1e-5 with the
base column equal, as ``test_torch_macro_chain.py`` holds them; the runs
draw the same random bits, so their iteration histories and real spectra
agree to ``test_torch_slice.py``'s tolerances.
"""

import copy

import numpy as np
import pytest
import torch

from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.opacities.macro_atom_solver import (
    chain_context,
    k8_plan,
    solve_macro_chain as torch_chain,
)
from tardis_torch.simulation.base import run_tardis as torch_run_tardis
from tardis_tpu.atomic.synthetic import make_synthetic_atom_data
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.model.state import SimulationState
from tardis_tpu.opacities.macro_atom_solver import solve_macro_chain
from tardis_tpu.plasma.solver import PlasmaSolver
from tardis_tpu.simulation.base import run_tardis
from tardis_tpu.transport.device_state import NU_UNIT

from tests.test_torch_slice import CONFIG as SLICE_CONFIG

torch.set_num_threads(2)

LEVELS, JUMP, SHELLS = 400, 20, 3
CONFIG = copy.deepcopy(SLICE_CONFIG)
CONFIG["model"]["structure"]["velocity"]["num"] = SHELLS
CONFIG["montecarlo"].update(no_of_packets=2048, iterations=2,
                            last_no_of_packets=2048)


@pytest.fixture(scope="module")
def large_atom():
    return make_synthetic_atom_data(
        n_levels=LEVELS, max_level_jump=JUMP).prepare(
            selected_atoms=[8, 12, 14, 16, 18, 20],
            line_interaction_type="macroatom")


@pytest.fixture(scope="module")
def port_atom(large_atom):
    return atom_data_from_arrays(atom_data_to_arrays(large_atom))


def test_every_system_is_the_large_instantiations(port_atom):
    """18 components of 400 levels: one launch a build on the card, all
    of it the large-system instantiation's."""
    ctx = chain_context(port_atom.macro_atom, "macroatom",
                        port_atom.line_nu / NU_UNIT)
    assert ctx.k8_groups == 18 and ctx.k8_n_max == LEVELS
    plan, = k8_plan(ctx, SHELLS, 132)
    assert (plan.variant, plan.systems) == ("macroatom_large", 18 * SHELLS)


def test_chain_tables(large_atom, port_atom):
    state = SimulationState.from_config(config_from_dict(CONFIG))
    ps = PlasmaSolver(large_atom, state).update(
        state.t_radiative, state.dilution_factor, line_mode="host")
    nu = large_atom.line_nu / NU_UNIT
    ref = solve_macro_chain(
        large_atom.macro_atom, ps.beta_sobolev, ps.j_blues,
        ps.stimulated_emission_factor, mode="macroatom", line_nu_scaled=nu)
    got = torch_chain(
        port_atom.macro_atom, torch.as_tensor(ps.beta_sobolev),
        torch.as_tensor(ps.j_blues),
        torch.as_tensor(ps.stimulated_emission_factor), mode="macroatom",
        line_nu_scaled=nu)
    W, We = got.chain_width, got.emit_width
    assert (W, We) == (ref.chain_width, ref.emit_width) and W == LEVELS
    r, g = np.asarray(ref.chain_cdf), got.chain_cdf.numpy()
    assert g.shape == r.shape == (SHELLS * got.n_states, W + 1)
    np.testing.assert_allclose(g[:, :W], r[:, :W], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(g[:, W], r[:, W])
    assert (np.diff(g[:, :W], axis=1) >= 0).all()
    np.testing.assert_allclose(got.emit_cdf.numpy()[:, :We],
                               np.asarray(ref.emit_cdf)[:, :We], rtol=0,
                               atol=1e-5)


@pytest.fixture(scope="module")
def sims(large_atom, port_atom):
    ref = run_tardis(copy.deepcopy(CONFIG), atom_data=large_atom)
    port = torch_run_tardis(copy.deepcopy(CONFIG), atom_data=port_atom,
                            device="cpu")
    return ref, port


def test_iteration_history(sims):
    ref, port = sims
    assert len(port.history) == len(ref.history) == 1
    for h_p, h_r in zip(port.history, ref.history):
        assert abs(h_p.t_inner / h_r.t_inner - 1) < 0.01
        np.testing.assert_allclose(h_p.t_radiative, h_r.t_radiative,
                                   rtol=0.02)
        np.testing.assert_allclose(h_p.dilution_factor, h_r.dilution_factor,
                                   rtol=0.05)


def test_final_spectrum(sims):
    ref, port = sims
    lum_p = port.spectrum_real.luminosity
    lum_r = ref.spectrum_real.luminosity
    assert np.isfinite(port.spectrum_real.luminosity_nu).all()
    assert abs(lum_p / lum_r - 1) < 0.02
    np.testing.assert_array_equal(port.spectrum_real.nu_edges,
                                  ref.spectrum_real.nu_edges)
    res = port.last_transport_result
    assert res.n_packets == 2048 and res.n_immortal == 0
