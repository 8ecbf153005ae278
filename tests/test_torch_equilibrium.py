"""The port's kinetic-equilibrium and thermal-balance solvers against the
JAX package's.

``tardis_torch/plasma/equilibrium.py`` is a host numpy f64 copy of
``tardis_tpu/plasma/equilibrium.py`` over the port's ``ContinuumSolver``.
On tests/test_equilibrium.py's problem (H 0.9, Si 0.1, the H I continua,
8 levels a species) the coupled level and ion populations and the
converged n_e agree to rtol 1e-8 (the solve iterates n_e through the
continuum rates), with and without tabulated collision strengths, under
the dilute field and under given j_blues; the thermal-balance scan picks
the same T_e, and ``apply_to_state`` rebuilds the line tables with K3's
plain version as the JAX package's host formulas do.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.config.reader import config_from_dict as torch_config
from tardis_torch.model.state import SimulationState as TorchState
from tardis_torch.plasma import equilibrium as torch_eq
from tardis_torch.plasma.continuum import ContinuumSolver as TorchContinuum
from tardis_torch.plasma.solver import PlasmaSolver as TorchPlasmaSolver
from tardis_tpu.atomic.synthetic import make_synthetic_atom_data
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.model.state import SimulationState
from tardis_tpu.plasma import equilibrium as jax_eq
from tardis_tpu.plasma import lte
from tardis_tpu.plasma.continuum import ContinuumSolver
from tardis_tpu.plasma.solver import PlasmaSolver

from tests.test_plasma import BASE_CONFIG

torch.set_num_threads(2)


def _setup(collision):
    cfg = copy.deepcopy(BASE_CONFIG)
    cfg["model"]["abundances"] = {"type": "uniform", "H": 0.9, "Si": 0.1}
    state = SimulationState.from_config(config_from_dict(cfg))
    atom = make_synthetic_atom_data(
        atomic_numbers=(1, 14), max_ion_stage=2, n_levels=8,
        continuum_species=((1, 0),),
        collision_species=((1, 0),) if collision else (),
    ).prepare(line_interaction_type="scatter")
    port_atom = atom_data_from_arrays(atom_data_to_arrays(atom))
    pls = PlasmaSolver(atom, state, link_t_rad_t_electron=1.0)
    tpls = TorchPlasmaSolver(port_atom, TorchState.from_config(
        torch_config(cfg)), "cpu", link_t_rad_t_electron=1.0)
    t_rad, w = state.t_radiative, state.dilution_factor
    return (atom, pls, pls.update(t_rad, w, line_mode="host"),
            tpls, tpls.update(t_rad, w))


@pytest.fixture(scope="module", params=[False, True],
                ids=["van_regemorter", "tabulated"])
def setup(request):
    return _setup(request.param)


@pytest.mark.parametrize("field", ["dilute", "j_blues"])
def test_kinetic_equilibrium_matches_jax(setup, field):
    atom, pls, ps, tpls, tps = setup
    jb = None
    if field == "j_blues":
        jb = lte.intensity_black_body(atom.line_nu[:, None],
                                      ps.t_rad[None, :]) * 0.8
    ref = jax_eq.KineticEquilibriumSolver(atom, pls)
    port = torch_eq.KineticEquilibriumSolver(tpls.atom, tpls)
    assert port.elements == ref.elements == [1]
    lv_r, ion_r, ne_r = ref.solve(ps, j_blues=jb)
    lv_p, ion_p, ne_p = port.solve(tps, j_blues=jb)
    np.testing.assert_allclose(ne_p, ne_r, rtol=1e-8, atol=0)
    for z in ref.elements:
        np.testing.assert_array_equal(port._elem[z]["rows"],
                                      ref._elem[z]["rows"])
        np.testing.assert_allclose(lv_p[z], lv_r[z], rtol=1e-8, atol=1e-300)
        np.testing.assert_allclose(ion_p[z], ion_r[z], rtol=1e-8, atol=0)
    # the populations sum to the element's number density
    np.testing.assert_allclose(ion_p[1].sum(axis=0),
                               tpls.number_density[port._elem[1]["e_idx"]],
                               rtol=1e-8)

    new_r = ref.apply_to_state(ps, lv_r, ion_r, ne_r)
    new_p = port.apply_to_state(tps, lv_p, ion_p, ne_p)
    np.testing.assert_allclose(new_p.level_number_density,
                               new_r.level_number_density, rtol=1e-8,
                               atol=1e-300)
    np.testing.assert_allclose(new_p.ion_number_density,
                               new_r.ion_number_density, rtol=1e-8, atol=0)
    for name in ("stimulated_emission_factor", "tau_sobolev",
                 "beta_sobolev"):
        np.testing.assert_allclose(getattr(new_p, name).numpy(),
                                   getattr(new_r, name), rtol=1e-8,
                                   atol=1e-300, err_msg=name)
    # the j_blues stay the state's; the prefix is the new tau's
    assert new_p.j_blues is tps.j_blues
    np.testing.assert_allclose(new_p.tau_prefix[:, -1].numpy(),
                               new_r.tau_sobolev.sum(axis=0), rtol=1e-10)


def test_electron_distribution_drives_the_solve(setup):
    atom, pls, ps, tpls, tps = setup
    dist_r = jax_eq.ThermalElectronEnergyDistribution.from_plasma_state(ps)
    dist_p = torch_eq.ThermalElectronEnergyDistribution.from_plasma_state(
        tps)
    np.testing.assert_array_equal(dist_p.energy, dist_r.energy)
    np.testing.assert_array_equal(dist_p.number_density,
                                  dist_r.number_density)
    hot = dataclasses.replace(dist_p, temperature=1.1 * dist_p.temperature)
    hot_r = dataclasses.replace(dist_r, temperature=1.1 * dist_r.temperature)
    _, ion_p, ne_p = torch_eq.KineticEquilibriumSolver(
        tpls.atom, tpls).solve(tps, electron_distribution=hot)
    _, ion_r, ne_r = jax_eq.KineticEquilibriumSolver(atom, pls).solve(
        ps, electron_distribution=hot_r)
    np.testing.assert_allclose(ne_p, ne_r, rtol=1e-8, atol=0)
    np.testing.assert_allclose(ion_p[1], ion_r[1], rtol=1e-8, atol=0)


def test_thermal_balance_matches_jax(setup):
    """The scan over T_e = f T_rad with tests/test_equilibrium.py's
    stand-in estimators from the dilute-blackbody rates."""
    from tardis_torch.plasma.continuum import ContinuumEstimators as TEst
    from tardis_tpu.plasma.continuum import ContinuumEstimators

    atom, pls, ps, tpls, tps = setup
    cont, tcont = ContinuumSolver(atom, pls), TorchContinuum(tpls.atom, tpls)
    cs = cont.update(ps)
    C, S = cs.gamma.shape
    fields = dict(photo_ion=np.maximum(cs.gamma, 0.0),
                  stim_recomb=np.maximum(cs.alpha_stim, 0.0),
                  bf_heating=np.abs(cs.gamma) * 1e-12,
                  stim_recomb_cooling=np.zeros((C, S)),
                  photo_ion_statistics=np.ones((C, S)),
                  ff_heating=cs.ff_cool_rate * 0.8)
    t_ref = jax_eq.ThermalBalanceSolver(cont).solve(
        ps, ContinuumEstimators(**fields), t_e_bounds=(0.5, 1.5), n_grid=11)
    t_port = torch_eq.ThermalBalanceSolver(tcont).solve(
        tps, TEst(**fields), t_e_bounds=(0.5, 1.5), n_grid=11)
    np.testing.assert_allclose(t_port, t_ref, rtol=1e-12, atol=0)
    assert ((t_port >= 0.5 * tps.t_rad - 1)
            & (t_port <= 1.5 * tps.t_rad + 1)).all()


def test_elements_without_photoionization_are_refused(setup):
    atom, pls, ps, tpls, tps = setup
    with pytest.raises(ValueError, match="Z=14"):
        torch_eq.KineticEquilibriumSolver(tpls.atom, tpls, elements=[14])
    plain = make_synthetic_atom_data(atomic_numbers=(1, 14), max_ion_stage=2,
                                     n_levels=8).prepare(
        line_interaction_type="scatter")
    with pytest.raises(ValueError, match="photoionization"):
        torch_eq.KineticEquilibriumSolver(
            atom_data_from_arrays(atom_data_to_arrays(plain)), tpls)
