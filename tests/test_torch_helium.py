"""The port's helium treatments against the JAX package's.

``tardis_torch/plasma/helium.py`` is a host numpy f64 copy of
``tardis_tpu/plasma/helium.py``.  On tests/test_helium.py's problem (He
0.6, Si 0.4, 8 levels a species) ``PlasmaSolver.update`` with
``recomb-nlte`` (the helium-aware n_e fixpoint, LTE and nebular
ionization) and with ``numerical-nlte`` (the rate matrix over He I, He II
and He III, with a heating-rate file the test writes) gives the JAX
package's level and ion populations and n_e to rtol 1e-10.
"""

import copy

import numpy as np
import pytest
import torch

from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.config.reader import config_from_dict as torch_config
from tardis_torch.model.state import SimulationState as TorchState
from tardis_torch.plasma import helium as torch_helium
from tardis_torch.plasma.solver import PlasmaSolver as TorchPlasmaSolver
from tardis_tpu.atomic.synthetic import make_synthetic_atom_data
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.model.state import SimulationState
from tardis_tpu.plasma import helium, lte
from tardis_tpu.plasma.solver import PlasmaSolver

from tests.test_plasma import BASE_CONFIG

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def he_setup(tmp_path_factory):
    cfg_d = copy.deepcopy(BASE_CONFIG)
    cfg_d["model"]["abundances"] = {"type": "uniform", "He": 0.6, "Si": 0.4}
    state = SimulationState.from_config(config_from_dict(cfg_d))
    atom = make_synthetic_atom_data(atomic_numbers=(2, 14), n_levels=8) \
        .prepare(selected_atoms=[2, 14], line_interaction_type="scatter")
    heating = tmp_path_factory.mktemp("helium") / "heating_rates.dat"
    np.savetxt(heating, np.column_stack([np.arange(20.0),
                                         np.geomspace(1e-8, 1e-6, 20)]))
    return cfg_d, state, atom, atom_data_from_arrays(
        atom_data_to_arrays(atom)), str(heating)


def _pair(he_setup, **kw):
    cfg_d, state, atom, port_atom, _ = he_setup
    ref = PlasmaSolver(atom, state, **kw)
    port = TorchPlasmaSolver(port_atom, TorchState.from_config(
        torch_config(cfg_d)), "cpu", **kw)
    return ref, port


def assert_populations_agree(p, r):
    for name in ("level_number_density", "ion_number_density",
                 "electron_densities"):
        np.testing.assert_allclose(getattr(p, name), getattr(r, name),
                                   rtol=1e-10, atol=0, err_msg=name)
    np.testing.assert_allclose(p.tau_sobolev.numpy(), r.tau_sobolev,
                               rtol=1e-10, atol=0)


@pytest.mark.parametrize("ionization,excitation", [
    ("lte", "lte"), ("nebular", "dilute-lte")])
def test_recomb_nlte_matches_jax(he_setup, ionization, excitation):
    _, state, atom, *_ = he_setup
    ref, port = _pair(he_setup, ionization=ionization, excitation=excitation,
                      helium_treatment="recomb-nlte")
    t_rad, w = state.t_radiative, state.dilution_factor
    for scale in (1.0, 0.97):  # the second solve seeds the fixpoint
        r = ref.update(scale * t_rad, w, line_mode="host")
        p = port.update(scale * t_rad, w)
        assert_populations_agree(p, r)
    # He I's ground state is empty in the approximation
    rows1 = torch_helium.species_rows(port.atom, 0)
    assert (p.level_number_density[rows1[0]] == 0.0).all()


@pytest.mark.parametrize("ionization", ["lte", "nebular"])
def test_numerical_nlte_matches_jax(he_setup, ionization):
    _, state, atom, _, heating = he_setup
    ref, port = _pair(he_setup, ionization=ionization,
                      helium_treatment="numerical-nlte",
                      heating_rate_data_file=heating)
    np.testing.assert_array_equal(port.heating_rate_data,
                                  ref.heating_rate_data)
    assert port.heating_rate_data.shape == (2, 20)
    t_rad, w = state.t_radiative, state.dilution_factor
    r = ref.update(t_rad, w, line_mode="host")
    p = port.update(t_rad, w)
    assert_populations_agree(p, r)
    # with the lines' own field in place of the dilute-Planck one
    jb = lte.dilute_planck_j_blues(atom.line_nu, t_rad, w) * 1.2
    assert_populations_agree(port.update(t_rad, w, j_blues=jb),
                             ref.update(t_rad, w, j_blues=jb,
                                        line_mode="host"))


@pytest.mark.parametrize("collision", [False, True],
                         ids=["van_regemorter", "tabulated"])
def test_numerical_nlte_function_matches_jax(he_setup, collision):
    """``helium_numerical_nlte`` alone, rows and (He I, He II, He III)
    populations, which sum to the helium number density; with tabulated
    collision strengths for He I and He II, which replace van Regemorter
    on the lines they cover."""
    _, state, atom, port_atom, _ = he_setup
    if collision:
        atom = make_synthetic_atom_data(
            atomic_numbers=(2, 14), n_levels=8,
            collision_species=((2, 0), (2, 1))).prepare(
            selected_atoms=[2, 14], line_interaction_type="scatter")
        assert len(atom.collision) > 0
        port_atom = atom_data_from_arrays(atom_data_to_arrays(atom))
    t_rad, w = state.t_radiative, state.dilution_factor
    t_e = 0.9 * t_rad
    n_e = np.geomspace(3e9, 1e8, len(t_rad))
    jb = lte.dilute_planck_j_blues(atom.line_nu, t_rad, w)
    n_he = np.geomspace(1e9, 1e7, len(t_rad))
    ref = helium.helium_numerical_nlte(atom, t_rad, w, t_e, n_e, jb, n_he)
    port = torch_helium.helium_numerical_nlte(port_atom, t_rad, w, t_e, n_e,
                                              jb, n_he)
    np.testing.assert_array_equal(port[0], ref[0])
    for a, b in zip(port[1:], ref[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=0)
    np.testing.assert_allclose(port[3].sum(axis=0), n_he, rtol=1e-12)


def test_helium_and_he_nlte_species_are_exclusive(he_setup):
    cfg_d, state, atom, port_atom, _ = he_setup
    kw = dict(helium_treatment="recomb-nlte", nlte_species=[(2, 0)])
    with pytest.raises(ValueError, match="exclusive"):
        PlasmaSolver(atom, state, **kw)
    with pytest.raises(ValueError, match="exclusive"):
        TorchPlasmaSolver(port_atom, TorchState.from_config(
            torch_config(cfg_d)), "cpu", **kw)
    with pytest.raises(ValueError, match="helium_treatment"):
        TorchPlasmaSolver(port_atom, TorchState.from_config(
            torch_config(cfg_d)), "cpu", helium_treatment="nlte")
