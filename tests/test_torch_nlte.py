"""The port's NLTE level populations against the JAX package's.

``tardis_torch/plasma/nlte.py`` is a host numpy f64 copy of
``tardis_tpu/plasma/nlte.py``: the same rate matrices and solves, so the
Boltzmann factors agree to rtol 1e-12 in all three modes, with and without
tabulated collision strengths.  Through ``PlasmaSolver.update`` with Si II
in NLTE the level populations and n_e agree to rtol 1e-10 with the JAX
solver's host mode, and the line tables from K3's plain version to rtol
1e-10 (prefix and populations pass through the n_e fixpoint).
"""

import copy

import numpy as np
import pytest
import torch

from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.config.reader import config_from_dict as torch_config
from tardis_torch.model.state import SimulationState as TorchState
from tardis_torch.plasma import lte as torch_lte
from tardis_torch.plasma import nlte as torch_nlte
from tardis_torch.plasma.solver import PlasmaSolver as TorchPlasmaSolver
from tardis_tpu.atomic.synthetic import make_synthetic_atom_data
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.model.state import SimulationState
from tardis_tpu.plasma import lte, nlte
from tardis_tpu.plasma.solver import PlasmaSolver

from tests.test_plasma import BASE_CONFIG

torch.set_num_threads(2)

SI_II = (14, 1)
MODES = {"default": {}, "coronal": {"coronal_approximation": True},
         "nebular": {"classical_nebular": True}}


def _atoms(collision):
    atom = make_synthetic_atom_data(
        atomic_numbers=(8, 14), n_levels=12,
        collision_species=((14, 1),) if collision else (),
    ).prepare(selected_atoms=[8, 14], line_interaction_type="macroatom")
    return atom, atom_data_from_arrays(atom_data_to_arrays(atom))


@pytest.fixture(scope="module")
def state():
    cfg = copy.deepcopy(BASE_CONFIG)
    cfg["model"]["abundances"] = {"type": "uniform", "O": 0.4, "Si": 0.6}
    return SimulationState.from_config(config_from_dict(cfg)), cfg


@pytest.mark.parametrize("collision", [False, True],
                         ids=["van_regemorter", "tabulated"])
@pytest.mark.parametrize("mode", MODES)
def test_boltzmann_factor_matches_jax(state, mode, collision):
    sim_state, _ = state
    atom, port_atom = _atoms(collision)
    if collision:
        assert len(atom.collision) > 0
    t_rad = sim_state.t_radiative
    w = sim_state.dilution_factor
    # a field that is not the dilute-Planck one, so the default mode reads
    # j_blues
    jb = lte.dilute_planck_j_blues(atom.line_nu, t_rad, w) * (
        1.0 + 0.3 * np.sin(np.arange(atom.n_lines))[:, None])
    n_e = np.geomspace(1e9, 3e8, len(t_rad))
    for kw in ({}, dict(electron_densities=n_e, t_electrons=0.9 * t_rad)):
        idx, bf = nlte.nlte_level_boltzmann_factor(
            atom, SI_II, t_rad, w, jb, **kw, **MODES[mode])
        pidx, pbf = torch_nlte.nlte_level_boltzmann_factor(
            port_atom, SI_II, t_rad, w, jb, **kw, **MODES[mode])
        np.testing.assert_array_equal(pidx, idx)
        assert len(idx) == 12 and np.isfinite(bf).all()
        np.testing.assert_allclose(pbf, bf, rtol=1e-12, atol=0)


def _solvers(state, collision, **kw):
    sim_state, cfg = state
    atom, port_atom = _atoms(collision)
    ref = PlasmaSolver(atom, sim_state, ionization="nebular",
                       excitation="dilute-lte", nlte_species=[SI_II], **kw)
    tstate = TorchState.from_config(torch_config(cfg))
    port = TorchPlasmaSolver(port_atom, tstate, "cpu", ionization="nebular",
                             excitation="dilute-lte", nlte_species=[SI_II],
                             **kw)
    return ref, port, atom


def assert_states_agree(p, r, rtol=1e-10):
    np.testing.assert_allclose(p.level_number_density,
                               r.level_number_density, rtol=rtol, atol=0)
    np.testing.assert_allclose(p.electron_densities, r.electron_densities,
                               rtol=rtol, atol=0)
    for name in ("stimulated_emission_factor", "tau_sobolev",
                 "beta_sobolev", "j_blues"):
        np.testing.assert_allclose(getattr(p, name).numpy(),
                                   getattr(r, name), rtol=rtol, atol=0,
                                   err_msg=name)


@pytest.mark.parametrize("collision", [False, True],
                         ids=["van_regemorter", "tabulated"])
def test_plasma_update_with_nlte_species_matches_jax(state, collision):
    """Two solves: the first without collisions (no n_e yet), the second
    with the first one's n_e; then one with given j_blues."""
    sim_state, _ = state
    ref, port, atom = _solvers(state, collision)
    t_rad, w = sim_state.t_radiative, sim_state.dilution_factor
    lte_port = TorchPlasmaSolver(port.atom, TorchState.from_config(
        torch_config(state[1])), "cpu", ionization="nebular",
        excitation="dilute-lte").update(t_rad, w)
    for scale in (1.0, 1.05):
        r = ref.update(scale * t_rad, w, line_mode="host")
        p = port.update(scale * t_rad, w)
        assert_states_agree(p, r)
    # the NLTE rows moved Si II's populations off LTE
    rows = np.nonzero((atom.level_z == 14) & (atom.level_ion == 1))[0]
    assert not np.allclose(p.level_number_density[rows],
                           lte_port.level_number_density[rows], rtol=1e-3)
    jb = lte.dilute_planck_j_blues(atom.line_nu, t_rad, w) * 0.7
    assert_states_agree(port.update(t_rad, w, j_blues=torch.as_tensor(jb)),
                        ref.update(t_rad, w, j_blues=jb, line_mode="host"))


def test_detailed_plasma_update_matches_jax(state):
    """``detailed`` rates with NLTE: the estimator j_blues, zero in some
    entries, through K3's plain estimators mode."""
    sim_state, _ = state
    ref, port, atom = _solvers(state, False,
                               radiative_rates_type="detailed")
    t_rad, w = sim_state.t_radiative, sim_state.dilution_factor
    jb = lte.dilute_planck_j_blues(atom.line_nu, t_rad, w) * 1.3
    jb[::3] = 0.0
    r = ref.update(t_rad, w, j_blues=jb, line_mode="host")
    p = port.update(t_rad, w, j_blues=jb)
    assert_states_agree(p, r)
    np.testing.assert_array_equal(p.j_blues.numpy()[1::3], jb[1::3])


def test_parse_species():
    for spec, want in (("Si 2", (14, 1)), ("Si II", (14, 1)),
                       ("si_2", (14, 1)), ("He I", (2, 0)),
                       ("Ca 3", (20, 2)), ("Fe VI", (26, 5))):
        assert torch_nlte.parse_species(spec) == want
        assert nlte.parse_species(spec) == want


def test_nlte_constants_are_the_jax_package_s():
    assert torch_nlte.BETA_COLL == nlte.BETA_COLL
    assert torch_nlte.A_COEF == nlte._A_COEF
    assert torch_nlte.B_COEF == nlte._B_COEF
    np.testing.assert_array_equal(
        torch_lte.dilute_planck_j_blues(np.array([1e15]), np.array([1e4]),
                                        np.array([0.5])),
        lte.dilute_planck_j_blues(np.array([1e15]), np.array([1e4]),
                                  np.array([0.5])))
