"""Port transport loop (K1's plain version) against the JAX event loop.

Both packages get the same tables (the port's are built from the JAX
host-mode plasma state through the atomic-data converter), the same packet
pool and the same run key, so they draw the same random bits and take the
same per-packet f32 steps; only the line search's arithmetic (f64 prefix
here, two-float f32 there) and libm ulps differ, so a few chaotic
trajectories part ways.
"""

import jax
import numpy as np
import pytest
import torch

from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.config.reader import config_from_dict as torch_config
from tardis_torch.model.state import SimulationState as TorchState
from tardis_torch.opacities.macro_atom_solver import (
    solve_macro_chain as torch_chain,
)
from tardis_torch.transport import rng
from tardis_torch.transport.kernel import transport_loop, transport_loop_plain
from tardis_torch.transport.tables import build_transport_tables as torch_tables
from tardis_tpu.atomic.synthetic import make_synthetic_atom_data
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.model.state import SimulationState
from tardis_tpu.opacities.macro_atom_solver import solve_macro_chain
from tardis_tpu.plasma.solver import PlasmaSolver
from tardis_tpu.transport.device_state import NU_UNIT, build_transport_tables
from tardis_tpu.transport.kernel import run_transport
from tardis_tpu.transport.source import sample_blackbody_packets

from tests.test_plasma import BASE_CONFIG

torch.set_num_threads(2)

N = 1024
SEED = 7
HOT = 5.0


@pytest.fixture(scope="module", params=["scatter", "macroatom"])
def runs(request):
    mode = request.param
    atom = make_synthetic_atom_data().prepare(
        selected_atoms=[8, 12, 14, 16, 18, 20], line_interaction_type=mode,
    )
    state = SimulationState.from_config(config_from_dict(BASE_CONFIG))
    ps = PlasmaSolver(atom, state).update(
        state.t_radiative, state.dilution_factor, line_mode="host"
    )
    chain = None
    port_chain = None
    port_atom = atom_data_from_arrays(atom_data_to_arrays(atom))
    if mode == "macroatom":
        args = (ps.beta_sobolev, ps.j_blues, ps.stimulated_emission_factor)
        chain = solve_macro_chain(atom.macro_atom, *args, mode=mode,
                                  line_nu_scaled=atom.line_nu / NU_UNIT)
        port_chain = torch_chain(port_atom.macro_atom,
                                 *(torch.as_tensor(a) for a in args),
                                 mode=mode,
                                 line_nu_scaled=atom.line_nu / NU_UNIT)
    tables, static = build_transport_tables(
        state.geometry, ps, atom, mode, macro_chain=chain
    )
    base = jax.random.key(np.uint32(SEED))
    # a hot pool: the synthetic set's optically thick lines lie in the far
    # UV, and at t_inner only ~1% of packets ever meet one
    pool_mu, pool_nu = sample_blackbody_packets(
        jax.random.fold_in(base, 0), N, HOT * state.t_inner
    )
    carry = run_transport(tables, static, pool_mu, pool_nu,
                          jax.random.fold_in(base, 1), n_packets=N,
                          batch_size=256)

    S, L = ps.tau_sobolev.shape[1], ps.tau_sobolev.shape[0]
    prefix = np.zeros((S, L + 1))
    np.cumsum(ps.tau_sobolev.T, axis=1, out=prefix[:, 1:])
    pstate = TorchState.from_config(torch_config(BASE_CONFIG))
    pt = torch_tables(pstate.geometry, ps.electron_densities,
                      torch.as_tensor(prefix), port_atom, mode,
                      macro_chain=port_chain)
    mu_t = torch.as_tensor(np.array(pool_mu))
    nu_t = torch.as_tensor(np.array(pool_nu))
    run_key = rng.fold_in(rng.key(SEED), 1)
    # 256 lanes, and the wrapper, whose plain loop runs one lane per packet
    port = {256: transport_loop_plain(pt, mu_t, nu_t, run_key,
                                      batch_size=256),
            1024: transport_loop(pt, mu_t, nu_t, run_key)}
    return carry, port, atom


def _port_status(out):
    nu = out[:, 0].numpy()
    return np.where(nu > 0, 1, np.where(nu < 0, 2, 0))


def test_per_packet_agreement(runs):
    carry, port, _ = runs
    res = port[256]
    status_j = np.asarray(carry.out_status)
    status_p = _port_status(res.out)
    match = status_p == status_j
    assert match.mean() >= 0.95, match.mean()
    assert (status_p != 0).all()  # every packet ends
    nu_j = np.asarray(carry.out_nu, np.float64)
    nu_p = np.abs(res.out[:, 0].numpy().astype(np.float64))
    close = np.abs(nu_p - nu_j) <= 1e-3 * nu_j
    assert (match & close).mean() >= 0.95, (match & close).mean()


def test_estimators_agree(runs):
    carry, port, atom = runs
    res = port[256]
    np.testing.assert_allclose(res.est_j.numpy(), carry.est_j_f64(),
                               rtol=0.05)
    np.testing.assert_allclose(res.est_nubar.numpy(), carry.est_nubar_f64(),
                               rtol=0.05)
    S = res.est_j.shape[0]
    L = atom.n_lines
    nu_scaled = (atom.line_nu / NU_UNIT)[:, None]
    jb_p = np.cumsum(res.line_diff.numpy().reshape(L + 1, S, 2),
                     axis=0)[:L] * nu_scaled[..., None]
    jb_j = np.cumsum(carry.line_diff_f64().reshape(L + 1, S, 2),
                     axis=0)[:L] * nu_scaled[..., None]
    for k in (0, 1):  # j_blue, e_dot totals
        assert abs(jb_p[..., k].sum() - jb_j[..., k].sum()) <= (
            0.05 * abs(jb_j[..., k].sum()))


def test_lane_count_independent(runs):
    """Per-packet outputs are bitwise independent of the lane count; the
    estimator sums only change summation order."""
    _, port, _ = runs
    a, b = port[256], port[1024]
    np.testing.assert_array_equal(a.out.numpy(), b.out.numpy())
    for name in ("est_j", "est_nubar", "line_diff"):
        np.testing.assert_allclose(getattr(a, name).numpy(),
                                   getattr(b, name).numpy(), rtol=1e-12,
                                   atol=1e-12)
    np.testing.assert_allclose(a.summary.numpy(), b.summary.numpy(),
                               rtol=1e-12)
    assert not transport_loop.launches_by_variant  # CPU tensors never launch
