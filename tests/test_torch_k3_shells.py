"""K3 (line tables) beyond the bench problem's 20 shells, on its plain
version, and the per-shell inputs its launch carries.

On the card K3 takes all shells of a tile in one block while they fit its
shared memory (87 shells) and carries h / (k T_rad) and W by value in the
launch's parameters up to 128 shells; wider models split the shells into
chunks and pass the inputs through a device buffer.  ``chip_smoke.py``
holds the card's kernel at 100 and 200 shells against the plain version;
these tests hold that plain version against the JAX package's f64 host
line pass at the same widths (rtol 1e-12 elementwise, 1e-10 for the
prefix, whose summation order differs, as ``test_torch_line_tables.py``).
"""

import copy

import numpy as np
import pytest
import torch

from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.config.reader import config_from_dict as torch_config
from tardis_torch.model.state import SimulationState as TorchState
from tardis_torch.plasma.line_tables import (
    _shell_inputs,
    line_tables_plain,
    shell_inputs_packed,
)
from tardis_torch.plasma.solver import PlasmaSolver as TorchPlasmaSolver
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.model.state import SimulationState
from tardis_tpu.plasma.solver import PlasmaSolver

from tests.test_plasma import BASE_CONFIG

torch.set_num_threads(2)

# past one block's chunk of shells, and past the inputs by value
WIDE_SHELLS = (100, 200)


@pytest.mark.parametrize("n_shells", (20,) + WIDE_SHELLS)
def test_k3_shell_inputs_packed(n_shells):
    """The per-shell inputs K3's launch carries (by value or through its
    pinned buffer) are ``_shell_inputs``' h / (k T_rad) and W, bit for
    bit."""
    gen = np.random.default_rng(4)
    t_rad = gen.uniform(3e3, 2e4, n_shells)
    w = gen.uniform(0.05, 0.5, n_shells)
    packed = shell_inputs_packed(t_rad, w)
    h_over_kt, jb_w = _shell_inputs(t_rad, w, "cpu")
    assert packed.dtype == np.float64 and packed.shape == (2 * n_shells,)
    np.testing.assert_array_equal(packed[:n_shells], h_over_kt.numpy())
    np.testing.assert_array_equal(packed[n_shells:], jb_w.numpy())
    np.testing.assert_array_equal(shell_inputs_packed(list(t_rad), list(w)),
                                  packed)


@pytest.fixture(scope="module", params=WIDE_SHELLS)
def wide(request, atom_data_prepared):
    """The plasma test model cut into ``n_shells`` shells: the JAX
    package's f64 host plasma state, the port's plasma solver on the CPU
    and its state."""
    cfg = copy.deepcopy(BASE_CONFIG)
    cfg["model"]["structure"]["velocity"]["num"] = request.param
    jc = config_from_dict(cfg)
    state = SimulationState.from_config(jc)
    ref = PlasmaSolver(atom_data_prepared, state).update(
        state.t_radiative, state.dilution_factor, line_mode="host")
    tstate = TorchState.from_config(torch_config(cfg))
    solver = TorchPlasmaSolver(
        atom_data_from_arrays(atom_data_to_arrays(atom_data_prepared)),
        tstate, "cpu")
    port = solver.update(tstate.t_radiative, tstate.dilution_factor)
    return request.param, ref, solver, tstate, port


def test_wide_line_tables_match_host_f64(wide):
    """At 100 and 200 shells the four tables agree with the JAX package's
    f64 host pass within 1e-12 and the prefix within 1e-10, relative."""
    n_shells, ref, _, _, port = wide
    assert port.tau_sobolev.shape[1] == n_shells
    for name in ("stimulated_emission_factor", "tau_sobolev",
                 "beta_sobolev", "j_blues"):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   getattr(ref, name), rtol=1e-12, atol=0,
                                   err_msg=name)
    cum = np.zeros((n_shells, ref.tau_sobolev.shape[0] + 1))
    np.cumsum(ref.tau_sobolev.T, axis=1, out=cum[:, 1:])
    np.testing.assert_allclose(port.tau_prefix.numpy(), cum, rtol=1e-10,
                               atol=0)


def test_wide_line_tables_repeat_shells(wide):
    """Shells whose inputs repeat get the same tables and prefix rows, bit
    for bit: each shell is computed and scanned on its own (the property
    ``chip_smoke.py`` checks of the card's chunked kernel, whose wide runs
    repeat the bench problem's shells)."""
    n_shells, _, solver, tstate, port = wide
    pop = torch.as_tensor(port.level_number_density)
    idx = torch.arange(2 * n_shells) % n_shells
    t_rad = np.asarray(tstate.t_radiative)
    w = np.asarray(tstate.dilution_factor)
    texp = tstate.time_explosion
    one = line_tables_plain(solver.line_static, pop, t_rad, w, texp)
    two = line_tables_plain(solver.line_static, pop[:, idx].contiguous(),
                            t_rad[idx.numpy()], w[idx.numpy()], texp)
    for name in ("stim", "tau", "beta", "j_blues"):
        assert torch.equal(getattr(two, name), getattr(one, name)[:, idx])
    assert torch.equal(two.prefix, one.prefix[idx])
    assert torch.equal(one.tau, port.tau_sobolev)
