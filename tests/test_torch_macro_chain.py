"""Port macro-atom chain tables against the JAX chain build.

Both get the same f64 plasma tables; the JAX package builds in f32 and the
port in f64 (rounded to f32 at the end), so the rows agree to atol 1e-5.
"""

import numpy as np
import pytest
import torch

from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.opacities.macro_atom_solver import (
    solve_macro_chain as torch_chain,
)
from tardis_tpu.atomic.synthetic import make_synthetic_atom_data
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.model.state import SimulationState
from tardis_tpu.opacities.macro_atom_solver import solve_macro_chain
from tardis_tpu.plasma.solver import PlasmaSolver
from tardis_tpu.transport.device_state import NU_UNIT

from tests.test_plasma import BASE_CONFIG

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=["macroatom", "downbranch"])
def chains(request):
    mode = request.param
    atom = make_synthetic_atom_data().prepare(
        selected_atoms=[8, 12, 14, 16, 18, 20], line_interaction_type=mode,
    )
    state = SimulationState.from_config(config_from_dict(BASE_CONFIG))
    ps = PlasmaSolver(atom, state).update(
        state.t_radiative, state.dilution_factor, line_mode="host"
    )
    macro = atom.downbranch if mode == "downbranch" else atom.macro_atom
    nu_scaled = atom.line_nu / NU_UNIT
    ref = solve_macro_chain(
        macro, ps.beta_sobolev, ps.j_blues, ps.stimulated_emission_factor,
        mode=mode, line_nu_scaled=nu_scaled,
    )
    port_atom = atom_data_from_arrays(atom_data_to_arrays(atom))
    port_macro = (port_atom.downbranch if mode == "downbranch"
                  else port_atom.macro_atom)
    got = torch_chain(
        port_macro, torch.as_tensor(ps.beta_sobolev),
        torch.as_tensor(ps.j_blues),
        torch.as_tensor(ps.stimulated_emission_factor),
        mode=mode, line_nu_scaled=nu_scaled,
    )
    return mode, ref, got


def test_chain_shapes(chains):
    mode, ref, got = chains
    assert (got.n_states, got.chain_width, got.emit_width) == (
        ref.n_states, ref.chain_width, ref.emit_width)
    np.testing.assert_array_equal(got.line2macro, ref.line2macro)


def test_emit_cdf(chains):
    _, ref, got = chains
    We = got.emit_width
    r = np.asarray(ref.emit_cdf)
    g = got.emit_cdf.numpy()
    assert g.dtype == np.float32 and g.shape == r.shape
    np.testing.assert_allclose(g[:, :We], r[:, :We], rtol=0, atol=1e-5)
    # line ids and frequencies are copied, not computed
    np.testing.assert_array_equal(g[:, We:], r[:, We:])


def test_chain_cdf(chains):
    mode, ref, got = chains
    if mode == "downbranch":  # deactivates at the activated level
        assert got.chain_cdf is None and ref.chain_cdf is None
        return
    r = np.asarray(ref.chain_cdf)
    g = got.chain_cdf.numpy()
    assert g.shape == r.shape
    W = got.chain_width
    np.testing.assert_allclose(g[:, :W], r[:, :W], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(g[:, W], r[:, W])
    # rows are non-decreasing: the kernel's lower-bound search relies on it
    assert (np.diff(g[:, :W], axis=1) >= 0).all()
