"""K1's RNG-walk macro atom (the plain version) against the JAX package's.

Where the absorbing-chain tables do not fit the device budget, both
packages walk the macro atom inside the classic event loop
(``tardis_tpu/transport/kernel.py:281`` ``_macro_walk``; the port's
``transport/macro_walk.py``).  Both get the same walk tables (each
package's ``solve_macro_state`` on one host-mode plasma solve), the same
pool and the same run key, so they draw the same bits: the bars are
``test_torch_transport.py``'s (>= 0.95 of packets with equal status and
nu within 1e-3, estimators within 5%), in macroatom and downbranch modes,
with spawn records and under full relativity, and over two CPU devices
bitwise against one.  The choice of sampler (``chain_tables_fit``,
``solve_macro_chain`` returning None) is held to the JAX package's.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.config.reader import config_from_dict as torch_config
from tardis_torch.model.state import SimulationState as TorchState
from tardis_torch.opacities import macro_atom_solver as torch_mas
from tardis_torch.parallel.transport import run_transport_sharded
from tardis_torch.transport import rng
from tardis_torch.transport import solver as torch_solver
from tardis_torch.transport.kernel import (
    transport_loop,
    transport_loop_plain,
    variant,
    variant_name,
)
from tardis_torch.transport.tables import build_transport_tables as torch_tables
from tardis_tpu.atomic.synthetic import make_synthetic_atom_data
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.model.state import SimulationState
from tardis_tpu.opacities import macro_atom_solver as jax_mas
from tardis_tpu.plasma.solver import PlasmaSolver
from tardis_tpu.transport.device_state import NU_UNIT, build_transport_tables
from tardis_tpu.transport.kernel import run_transport
from tardis_tpu.transport.source import sample_blackbody_packets

from tests.test_plasma import BASE_CONFIG

torch.set_num_threads(2)

N = 1024
SEED = 7
HOT = 5.0
PER_PACKET = 8
# (mode, full relativity, spawn-record capacity a packet)
CASES = {"macroatom": ("macroatom", False, 0),
         "downbranch": ("downbranch", False, 0),
         "records": ("macroatom", False, PER_PACKET),
         "full_relativity": ("macroatom", True, 0)}


@functools.lru_cache(maxsize=None)
def problem(mode):
    atom = make_synthetic_atom_data().prepare(
        selected_atoms=[8, 12, 14, 16, 18, 20], line_interaction_type=mode)
    state = SimulationState.from_config(config_from_dict(BASE_CONFIG))
    ps = PlasmaSolver(atom, state).update(
        state.t_radiative, state.dilution_factor, line_mode="host")
    return atom, state, ps


def walk_tables(mode, full_relativity):
    """(JAX tables, static, port tables, state) with the walk tables of
    each package's ``solve_macro_state``."""
    atom, state, ps = problem(mode)
    macro = atom.downbranch if mode == "downbranch" else atom.macro_atom
    args = (ps.beta_sobolev, ps.j_blues, ps.stimulated_emission_factor)
    tables, static = build_transport_tables(
        state.geometry, ps, atom, mode,
        macro_state=jax_mas.solve_macro_state(macro, *args),
        enable_full_relativity=full_relativity)
    port_atom = atom_data_from_arrays(atom_data_to_arrays(atom))
    port_macro = (port_atom.downbranch if mode == "downbranch"
                  else port_atom.macro_atom)
    walk = torch_mas.solve_macro_state(
        port_macro, *(torch.as_tensor(a) for a in args))
    S, L = ps.tau_sobolev.shape[1], ps.tau_sobolev.shape[0]
    prefix = np.zeros((S, L + 1))
    np.cumsum(ps.tau_sobolev.T, axis=1, out=prefix[:, 1:])
    pstate = TorchState.from_config(torch_config(BASE_CONFIG))
    pt = torch_tables(pstate.geometry, ps.electron_densities,
                      torch.as_tensor(prefix), port_atom, mode,
                      macro_walk=walk, full_relativity=full_relativity)
    return tables, static, pt, state


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    mode, full_relativity, per_packet = CASES[request.param]
    tables, static, pt, state = walk_tables(mode, full_relativity)
    assert not static.use_macro_chain
    base = jax.random.key(np.uint32(SEED))
    # a hot pool: at t_inner only ~1% of packets meet an optically thick line
    pool_mu, pool_nu = sample_blackbody_packets(
        jax.random.fold_in(base, 0), N, HOT * state.t_inner)
    cap = per_packet * N
    carry = run_transport(tables, static._replace(vpacket_capacity=cap),
                          pool_mu, pool_nu, jax.random.fold_in(base, 1),
                          n_packets=N, batch_size=256)
    mu_t = torch.as_tensor(np.array(pool_mu))
    nu_t = torch.as_tensor(np.array(pool_nu))
    run_key = rng.fold_in(rng.key(SEED), 1)
    port = transport_loop_plain(pt, mu_t, nu_t, run_key, batch_size=256,
                                vpacket_capacity=cap)
    return request.param, carry, port, pt, (mu_t, nu_t, run_key), cap


def _status(out):
    nu = out[:, 0].numpy()
    return np.where(nu > 0, 1, np.where(nu < 0, 2, 0))


def test_walk_per_packet_agreement(runs):
    _, carry, port, pt, _, _ = runs
    assert pt.walk is not None and variant(pt)[-2]
    status_j = np.asarray(carry.out_status)
    status_p = _status(port.out)
    match = status_p == status_j
    assert (status_p != 0).all()  # every packet ends
    nu_j = np.asarray(carry.out_nu, np.float64)
    nu_p = np.abs(port.out[:, 0].numpy().astype(np.float64))
    close = np.abs(nu_p - nu_j) <= 1e-3 * nu_j
    assert (match & close).mean() >= 0.95, (match & close).mean()


def test_walk_estimators_agree(runs):
    _, carry, port, pt, _, _ = runs
    np.testing.assert_allclose(port.est_j.numpy(), carry.est_j_f64(),
                               rtol=0.05)
    np.testing.assert_allclose(port.est_nubar.numpy(),
                               carry.est_nubar_f64(), rtol=0.05)
    S, L = pt.n_shells, pt.n_lines
    nu_scaled = (1.0 if pt.full_relativity else
                 pt.line_nu.double().numpy()[:, None, None])
    jb_p = np.cumsum(port.line_diff.numpy().reshape(L + 1, S, 2),
                     axis=0)[:L] * nu_scaled
    jb_j = np.cumsum(carry.line_diff_f64().reshape(L + 1, S, 2),
                     axis=0)[:L] * nu_scaled
    for k in (0, 1):  # j_blue, e_dot totals
        assert abs(jb_p[..., k].sum() - jb_j[..., k].sum()) <= (
            0.05 * abs(jb_j[..., k].sum()))


def test_walk_records(runs):
    """With records, both packages write as many spawn records (within
    1%), and a line row's out_line is next_line - 1, the walk's emitted
    line."""
    name, carry, port, _, _, cap = runs
    if not cap:
        assert port.n_vp_records == 0
        return
    n_j, n_p = int(carry.vp_count), int(port.vp_count[0])
    assert N < n_p <= cap
    assert abs(n_p / n_j - 1) < 0.01, (n_p, n_j)
    rec = port.vp_records[:port.n_vp_records].numpy()
    line = rec[rec[:, 6] == 2]
    assert len(line) > 0
    assert (line[:, 7] == line[:, 5] - 1).all()


def test_walk_wrapper_and_variant_name(runs):
    """The wrapper takes the plain version on CPU tensors (bitwise, any
    lane count) and names the walk instantiation."""
    name, _, port, pt, (mu, nu, key), cap = runs
    full = transport_loop(pt, mu, nu, key, vpacket_capacity=cap)
    np.testing.assert_array_equal(full.out.numpy(), port.out.numpy())
    assert "walk" in variant_name(variant(pt)).split("+")
    assert not transport_loop.launches_by_variant


def test_walk_over_two_cpu_devices():
    """Two CPU shards against one device: every packet bitwise, the
    estimators within summation order."""
    _, _, pt, state = walk_tables("macroatom", False)
    mu, nu = (torch.as_tensor(np.array(a)) for a in sample_blackbody_packets(
        jax.random.fold_in(jax.random.key(np.uint32(SEED)), 0), N,
        HOT * state.t_inner))
    key = rng.fold_in(rng.key(SEED), 1)
    one = transport_loop_plain(pt, mu, nu, key, batch_size=256)
    two = run_transport_sharded(pt, mu, nu, key, ["cpu", "cpu"])
    np.testing.assert_array_equal(two.out.numpy(), one.out.numpy())
    for field in ("est_j", "est_nubar", "line_diff", "summary"):
        np.testing.assert_allclose(getattr(two, field).numpy(),
                                   getattr(one, field).numpy(), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("mode", ["macroatom", "downbranch"])
def test_chain_budget_decides_as_the_jax_package(mode):
    """``chain_tables_fit`` and ``solve_macro_chain`` decide as the JAX
    package's (``tests/test_macro_chain.py:186-199``) at budgets around
    the tables' size: None exactly where the JAX package's is None."""
    atom, _, ps = problem(mode)
    port_atom = atom_data_from_arrays(atom_data_to_arrays(atom))
    macro = atom.downbranch if mode == "downbranch" else atom.macro_atom
    port_macro = (port_atom.downbranch if mode == "downbranch"
                  else port_atom.macro_atom)
    S = ps.beta_sobolev.shape[1]
    nu_scaled = atom.line_nu / NU_UNIT
    need = torch_mas.chain_context(port_macro, mode,
                                   nu_scaled).table_bytes(S)
    args = (ps.beta_sobolev, ps.j_blues, ps.stimulated_emission_factor)
    for budget in (1024, need - 1, need, 6e9):
        fit_j = jax_mas.chain_tables_fit(macro, S, mode, budget, nu_scaled)
        fit_p = torch_mas.chain_tables_fit(port_macro, S, mode, budget,
                                           nu_scaled)
        assert fit_p == fit_j, (budget, fit_p, fit_j)
        chain_j = jax_mas.solve_macro_chain(
            macro, *args, mode=mode, max_chain_bytes=budget,
            line_nu_scaled=nu_scaled)
        chain_p = torch_mas.solve_macro_chain(
            port_macro, *(torch.as_tensor(a) for a in args), mode=mode,
            line_nu_scaled=nu_scaled, max_chain_bytes=budget)
        assert (chain_p is None) == (chain_j is None) == (not fit_j)
    assert mode == "downbranch" or not torch_mas.chain_tables_fit(
        port_macro, S, mode, 1024, nu_scaled)


def test_solver_takes_the_walk_where_the_chain_does_not_fit(monkeypatch):
    """``TransportSolver(use_macro_chain=...)``: "auto" walks where
    ``solve_macro_chain`` returns None, False always walks, True raises
    there; with a budget the tables fit, "auto" and True take the chain."""
    from tardis_torch.atomic.synthetic import (
        make_synthetic_atom_data as torch_synthetic,
    )
    from tardis_torch.plasma.solver import PlasmaSolver as TorchPlasma

    atom = torch_synthetic(n_levels=10).prepare(
        selected_atoms=[8, 12, 14, 16, 18, 20],
        line_interaction_type="macroatom")
    state = TorchState.from_config(torch_config(BASE_CONFIG))
    ps = TorchPlasma(atom, state, "cpu").update(state.t_radiative,
                                                state.dilution_factor)
    built = []
    real_tables = torch_solver.build_transport_tables

    def spy(*a, **kw):
        t = real_tables(*a, **kw)
        built.append(t)
        return t

    monkeypatch.setattr(torch_solver, "build_transport_tables", spy)

    def run(use, budget):
        monkeypatch.setattr(
            torch_solver, "solve_macro_chain",
            functools.partial(torch_mas.solve_macro_chain,
                              max_chain_bytes=budget))
        solver = torch_solver.TransportSolver("macroatom",
                                              use_macro_chain=use,
                                              mesh=None)
        solver.run_iteration(state, ps, atom, 256, 3, 0,
                             need_line_estimators=False)
        return built[-1]

    for use, budget, walks in (("auto", 1024, True), (False, 6e9, True),
                               ("auto", 6e9, False), (True, 6e9, False)):
        t = run(use, budget)
        assert (t.walk is not None) == walks, (use, budget)
    with pytest.raises(ValueError, match="do not fit"):
        run(True, 1024)
    with pytest.raises(ValueError, match="use_macro_chain"):
        torch_solver.TransportSolver("macroatom", use_macro_chain="chain")
