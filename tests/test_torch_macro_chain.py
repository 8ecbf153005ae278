"""Port macro-atom chain tables against the JAX chain build.

Both get the same f64 plasma tables; the JAX package builds in f32 and the
port in f64 (rounded to f32 at the end), so the rows agree to atol 1e-5.
These run the port's plain version (CPU tensors); K8, its kernel on the
card, is held to the same arithmetic by ``test_torch_k8_mirror.py`` and
against the plain version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from tardis_torch.atomic.atom_data import MacroAtomData as TorchMacroAtomData
from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.opacities.macro_atom_solver import (
    solve_macro_chain as torch_chain,
)
from tardis_tpu.atomic.atom_data import MacroAtomData
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


# a macro table with a closed two-level internal cycle and no emission
# (levels 0 <-> 1), beside a two-level component with emission (2, 3) and
# a lone emitting level (4); one line a transition
CYCLE_LEVELS = (0, 1)
CYCLE_TABLE = dict(
    # level:          0    1    2         3              4
    transition_type=[0, 1, -1, 1, 0, -1, -1, -1],
    destination_level_id=[1, 0, -1, 3, 2, -1, -1, -1],
    coef=[1.0, 0.7, 0.8, 0.3, 0.5, 0.9, 0.4, 1.1],
    block_references=[0, 1, 2, 4, 7, 8],
    line2macro_level_upper=[1, 0, 2, 3, 2, 3, 3, 4],
)


def cycle_macro(cls):
    """CYCLE_TABLE as a MacroAtomData of ``cls`` (either package's)."""
    t = CYCLE_TABLE
    n = len(t["coef"])
    return cls(
        coef=np.asarray(t["coef"], np.float64),
        transition_type=np.asarray(t["transition_type"], np.int8),
        destination_level_id=np.asarray(t["destination_level_id"], np.int32),
        transition_line_id=np.arange(n, dtype=np.int32),
        block_references=np.asarray(t["block_references"], np.int32),
        line2macro_level_upper=np.asarray(t["line2macro_level_upper"],
                                          np.int32),
    )


def cycle_rates(n_shells=3, seed=7):
    """Seeded (beta, j_blues, stim) (L, S) f64 tables for CYCLE_TABLE, and
    the line frequencies in NU_UNIT."""
    gen = np.random.default_rng(seed)
    n_lines = len(CYCLE_TABLE["coef"])
    beta = gen.uniform(0.1, 1.0, (n_lines, n_shells))
    jb = gen.uniform(1e-6, 1e-4, (n_lines, n_shells))
    stim = gen.uniform(0.5, 1.0, (n_lines, n_shells))
    return beta, jb, stim, np.linspace(0.5, 1.2, n_lines)


def test_singular_component_takes_the_fallback():
    """A closed internal cycle without emission makes its system singular:
    the JAX package's f32 solve gives NaN rows there, which its rtot > 0
    test sends to the self-deactivation fallback.  The port's plain
    version (solve_ex, non-finite rows to the same fallback) gives every
    row the JAX package gives, the cycle's bit for bit."""
    beta, jb, stim, nu = cycle_rates()
    ref = solve_macro_chain(cycle_macro(MacroAtomData), beta, jb, stim,
                            mode="macroatom", line_nu_scaled=nu)
    got = torch_chain(cycle_macro(TorchMacroAtomData),
                      *(torch.as_tensor(a) for a in (beta, jb, stim)),
                      mode="macroatom", line_nu_scaled=nu)
    W, M = got.chain_width, got.n_states
    r = np.asarray(ref.chain_cdf).reshape(-1, M, W + 1)
    g = got.chain_cdf.numpy().reshape(-1, M, W + 1)
    assert g.shape == r.shape and W == 2
    step = (np.arange(W)[None, :]
            >= np.arange(len(CYCLE_LEVELS))[:, None]).astype(np.float32)
    for rows in (r, g):
        np.testing.assert_array_equal(rows[:, list(CYCLE_LEVELS), :W],
                                      np.broadcast_to(step, (3, 2, W)))
    np.testing.assert_array_equal(g[:, list(CYCLE_LEVELS)],
                                  r[:, list(CYCLE_LEVELS)])
    np.testing.assert_allclose(g, r, rtol=0, atol=1e-5)
    assert np.isfinite(g).all()
    np.testing.assert_allclose(got.emit_cdf.numpy(), np.asarray(ref.emit_cdf),
                               rtol=0, atol=1e-5)
