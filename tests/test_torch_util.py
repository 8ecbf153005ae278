"""The port's ``utils/base.py`` against the JAX package's.

The cases of ``tests/test_util.py`` for ``utils.base``, each asked of both
packages: the Roman numerals, species parsing and its errors,
``quantity_linspace`` and ``calculate_luminosity`` must agree exactly, and
``create_synpp_yaml`` on the JAX plasma state's tau table (as numpy) must
write the JAX package's YAML byte for byte.  On the port's own plasma
state (K3's tau table as a tensor, taken as given) the ions are the same
and each log tau within 1e-10.
"""

import copy

import numpy as np
import pytest
import torch

from tardis_torch.utils import base as ported
from tardis_tpu.utils import base as reference

from tests.test_plasma import BASE_CONFIG

torch.set_num_threads(2)


@pytest.mark.parametrize("i", (1, 4, 9, 14, 40, 90, 400, 1994, 3999))
def test_roman_numerals_roundtrip(i):
    assert ported.int_to_roman(i) == reference.int_to_roman(i)
    assert ported.roman_to_int(ported.int_to_roman(i)) == i


@pytest.mark.parametrize("bad", ("IIII", "", "ABC", "VX"))
def test_roman_numerals_refused(bad):
    with pytest.raises(ValueError):
        reference.roman_to_int(bad)
    with pytest.raises(ValueError):
        ported.roman_to_int(bad)
    with pytest.raises(ValueError):
        ported.int_to_roman(0)


@pytest.mark.parametrize("species", ("Si II", "si_ii", "Fe2", "Ca 2",
                                     "o 1", "Ni XXVIII"))
def test_species_parsing(species):
    t = ported.species_string_to_tuple(species)
    assert t == reference.species_string_to_tuple(species)
    assert ported.species_tuple_to_string(t) == \
        reference.species_tuple_to_string(t)
    assert ported.species_tuple_to_string(t, roman_numerals=False) == \
        reference.species_tuple_to_string(t, roman_numerals=False)


def test_species_errors_and_symbols():
    assert ported.species_tuple_to_string((14, 1)) == "Si II"
    assert ported.species_tuple_to_string((26, 3)) == "Fe IV"
    assert ported.element_symbol2atomic_number("sI") == 14
    assert ported.atomic_number2element_symbol(20) == "Ca"
    with pytest.raises(ported.MalformedElementSymbolError) as err:
        ported.species_string_to_tuple("Xx 2")
    with pytest.raises(reference.MalformedElementSymbolError) as err_ref:
        reference.species_string_to_tuple("Xx 2")
    assert str(err.value) == str(err_ref.value)
    with pytest.raises(ported.MalformedSpeciesError) as err:
        ported.species_string_to_tuple("Si")
    assert str(err.value) == str(
        reference.MalformedSpeciesError("Si"))
    assert issubclass(ported.MalformedSpeciesError, ported.MalformedError)
    with pytest.raises(ValueError, match="ion number > atomic number"):
        ported.species_string_to_tuple("H 5")


def test_quantity_linspace_and_luminosity(tmp_path):
    v = ported.quantity_linspace("1.1e4 km/s", "2e4 km/s", 3)
    np.testing.assert_array_equal(
        v, reference.quantity_linspace("1.1e4 km/s", "2e4 km/s", 3))
    np.testing.assert_allclose(v, [1.1e9, 1.55e9, 2.0e9])
    f = tmp_path / "spec.dat"
    wl = np.linspace(4000, 5000, 101)
    np.savetxt(f, np.column_stack([wl, 1.0 + 0.1 * np.sin(wl / 50.0)]))
    pc = 3.0857e18
    for distance in (f"{10 * pc} cm", "3.0857e24 cm", 10 * pc):
        assert ported.calculate_luminosity(str(f), distance) == \
            reference.calculate_luminosity(str(f), distance)
    lum, wmin, wmax = ported.calculate_luminosity(str(tmp_path / "spec.dat"),
                                                  f"{10 * pc} cm")
    assert (wmin, wmax) == (4000.0, 5000.0) and lum > 0


def test_convert_abundances_format(tmp_path):
    f = tmp_path / "abund.dat"
    table = np.zeros((3, 30))
    table[:, 7] = [0.2, 0.3, 0.4]  # O
    table[:, 13] = [0.8, 0.7, 0.6]  # Si
    np.savetxt(f, table)
    ours = ported.convert_abundances_format(str(f))
    theirs = reference.convert_abundances_format(str(f))
    assert list(ours) == list(theirs) == ["O", "Si"]
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


def _plasma(atom_data):
    """The JAX package's plasma state on BASE_CONFIG's model (Si and S
    only), with its state and atomic data, and the port's atomic data."""
    from tardis_torch.atomic.convert import (
        atom_data_from_arrays,
        atom_data_to_arrays,
    )
    from tardis_tpu.config.reader import config_from_dict
    from tardis_tpu.model.state import SimulationState
    from tardis_tpu.plasma.solver import PlasmaSolver

    cfg = config_from_dict(copy.deepcopy(BASE_CONFIG))
    state = SimulationState.from_config(cfg)
    atom = atom_data.prepare(selected_atoms=[14, 16],
                             line_interaction_type="scatter")
    ps = PlasmaSolver(atom, state).update(state.t_radiative,
                                          state.dilution_factor)
    return ps, state, atom, atom_data_from_arrays(atom_data_to_arrays(atom))


class _Sim:
    """A duck-typed simulation: what create_synpp_yaml reads."""

    def __init__(self, plasma_state, state, atom_data):
        self.plasma_state = plasma_state
        self.state = state
        self.atom_data = atom_data


@pytest.mark.parametrize("shell_no", (0, 7))
def test_synpp_yaml_matches_jax(tmp_path, shell_no):
    import yaml

    from tardis_tpu.atomic.synthetic import make_synthetic_atom_data

    ps, state, atom, port_atom = _plasma(make_synthetic_atom_data(n_levels=6))
    ref_path, port_path = tmp_path / "jax.yaml", tmp_path / "port.yaml"
    reference.create_synpp_yaml(_Sim(ps, state, atom), str(ref_path),
                                shell_no=shell_no)
    doc = ported.create_synpp_yaml(_Sim(ps, state, port_atom),
                                   str(port_path), shell_no=shell_no)
    assert port_path.read_bytes() == ref_path.read_bytes()
    setup = yaml.safe_load(port_path.read_text())["setups"][0]
    assert setup == doc["setups"][0]
    assert len(setup["ions"]) == len(setup["log_tau"]) > 0
    assert all(i // 100 in (14, 16) for i in setup["ions"])


def test_synpp_yaml_reads_the_device_tau_table(tmp_path):
    """On the port's own plasma state (the tau table a tensor) the same
    ions, each log tau within 1e-10 of the JAX package's."""
    from tardis_torch.config.reader import config_from_dict
    from tardis_torch.model.state import SimulationState
    from tardis_torch.plasma.solver import PlasmaSolver
    from tardis_tpu.atomic.synthetic import make_synthetic_atom_data

    ps, state, atom, port_atom = _plasma(make_synthetic_atom_data(n_levels=6))
    port_state = SimulationState.from_config(
        config_from_dict(copy.deepcopy(BASE_CONFIG)))
    port_ps = PlasmaSolver(port_atom, port_state, "cpu").update(
        port_state.t_radiative, port_state.dilution_factor)
    assert isinstance(port_ps.tau_sobolev, torch.Tensor)
    ours = ported.create_synpp_yaml(_Sim(port_ps, port_state, port_atom),
                                    str(tmp_path / "port.yaml"))
    theirs = reference.create_synpp_yaml(_Sim(ps, state, atom),
                                         str(tmp_path / "jax.yaml"))
    a, b = ours["setups"][0], theirs["setups"][0]
    assert a["ions"] == b["ions"]
    np.testing.assert_allclose(a["log_tau"], b["log_tau"], rtol=1e-10)
