"""Port line tables (K3's plain version) against the JAX plasma line pass.

Host mode is the f64 reference (rtol 1e-12 elementwise, 1e-10 for the
prefix, whose summation order differs); device mode is the JAX f32
program (rtol 1e-5 on lines whose values f32 carries).
"""

import copy

import numpy as np
import pytest
import torch

from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.config.reader import config_from_dict as torch_config
from tardis_torch.model.state import SimulationState as TorchState
from tardis_torch.plasma.line_tables import line_tables
from tardis_torch.plasma.solver import PlasmaSolver as TorchPlasmaSolver
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.model.state import SimulationState
from tardis_tpu.plasma.solver import PlasmaSolver

from tests.test_plasma import BASE_CONFIG

torch.set_num_threads(2)

CASES = {
    "lte": {"ionization": "lte", "excitation": "lte"},
    "nebular": {"ionization": "nebular", "excitation": "dilute-lte"},
    "blackbody": {"ionization": "lte", "excitation": "lte",
                  "radiative_rates_type": "blackbody"},
}


def _solve_both(atom, plasma_cfg, line_mode="host"):
    cfg = copy.deepcopy(BASE_CONFIG)
    cfg["plasma"] = dict(plasma_cfg)
    jc = config_from_dict(cfg)
    state = SimulationState.from_config(jc)
    rates = jc.plasma.radiative_rates_type
    ref = PlasmaSolver(
        atom, state, ionization=jc.plasma.ionization,
        excitation=jc.plasma.excitation, radiative_rates_type=rates,
    ).update(state.t_radiative, state.dilution_factor, line_mode=line_mode)
    tstate = TorchState.from_config(torch_config(cfg))
    port = TorchPlasmaSolver(
        atom_data_from_arrays(atom_data_to_arrays(atom)), tstate, "cpu",
        ionization=jc.plasma.ionization, excitation=jc.plasma.excitation,
        radiative_rates_type=rates,
    ).update(tstate.t_radiative, tstate.dilution_factor)
    return ref, port


@pytest.mark.parametrize("case", sorted(CASES))
def test_line_tables_match_host_f64(atom_data_prepared, case):
    ref, port = _solve_both(atom_data_prepared, CASES[case])
    np.testing.assert_array_equal(port.level_number_density,
                                  ref.level_number_density)
    for name in ("stimulated_emission_factor", "tau_sobolev",
                 "beta_sobolev", "j_blues"):
        got = getattr(port, name)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), getattr(ref, name),
                                   rtol=1e-12, atol=0, err_msg=name)
    cum = np.zeros((ref.tau_sobolev.shape[1], ref.tau_sobolev.shape[0] + 1))
    np.cumsum(ref.tau_sobolev.T, axis=1, out=cum[:, 1:])
    np.testing.assert_allclose(port.tau_prefix.numpy(), cum, rtol=1e-10,
                               atol=0)
    assert not line_tables.launches_by_variant  # CPU tensors never launch


def test_line_tables_match_device_f32(atom_data_prepared):
    """The JAX f32 device program agrees to f32 precision: beta, j_blues
    (where f32 holds a normal value; expm1(700) underflows it) and the
    prefix at rtol 1e-5.  Its stim = 1 - exp(f32 log ratio) carries an
    absolute error of ~|ln n| * 2^-24, so stim is held to atol 3e-5."""
    ref, port = _solve_both(atom_data_prepared, CASES["lte"],
                            line_mode="device")
    np.testing.assert_allclose(port.stimulated_emission_factor.numpy(),
                               np.asarray(ref.stim32), rtol=0, atol=3e-5)
    np.testing.assert_allclose(port.beta_sobolev.numpy(),
                               np.asarray(ref.beta32), rtol=1e-5, atol=0)
    jb = port.j_blues.numpy()
    normal = jb > 1e-30
    np.testing.assert_allclose(jb[normal],
                               np.asarray(ref.j_blues32)[normal],
                               rtol=1e-5, atol=0)
    prefix32 = (np.asarray(ref.tau_prefix_hi, np.float64)
                + np.asarray(ref.tau_prefix_lo, np.float64))
    np.testing.assert_allclose(port.tau_prefix.numpy()[:, 1:],
                               prefix32[:, 1:], rtol=1e-5, atol=0)
