"""The port's packet-parallel transport (``tardis_torch/parallel/
transport.py``) against the port on one device and against the JAX
package's sharded run.

A pool of N packets split into D shards draws, packet by packet, the bits
of its global id, so every per-packet output (status, nu, energy,
last-interaction and tracker rows, continuum event counts) is bitwise that
of the one-device run, and the spawn records are the same rows (in
another order: compared as a multiset).  The estimators are sums in
another order, hence 1e-12 relative.  Against the JAX package's
``run_transport_sharded`` on the 8-device CPU mesh (``tests/conftest.py``)
the bars are K1's parity bars of ``tests/test_torch_transport.py``.
"""

import copy
import logging

import jax
import numpy as np
import pytest
import torch

from tardis_torch.atomic.convert import (
    atom_data_from_arrays,
    atom_data_to_arrays,
)
from tardis_torch.atomic.synthetic import (
    make_synthetic_atom_data as torch_synthetic,
)
from tardis_torch.config.reader import config_from_dict as torch_config
from tardis_torch.model.state import SimulationState as TorchState
from tardis_torch.opacities.continuum_macro import (
    solve_continuum_macro_state as torch_macro,
)
from tardis_torch.opacities.macro_atom_solver import (
    solve_macro_chain as torch_chain,
)
from tardis_torch.parallel.transport import (
    packet_devices,
    run_transport_sharded,
)
from tardis_torch.plasma.continuum import ContinuumSolver as TorchContinuum
from tardis_torch.plasma.solver import PlasmaSolver as TorchPlasma
from tardis_torch.simulation.base import run_tardis as torch_run_tardis
from tardis_torch.transport import rng
from tardis_torch.transport import solver as solver_module
from tardis_torch.transport.kernel import transport_loop
from tardis_torch.transport.tables import (
    build_continuum_tables,
    build_transport_tables as torch_tables,
)
from tardis_tpu.atomic.synthetic import make_synthetic_atom_data
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.model.state import SimulationState
from tardis_tpu.parallel.transport import packet_mesh
from tardis_tpu.parallel.transport import (
    run_transport_sharded as jax_sharded,
)
from tardis_tpu.plasma.solver import PlasmaSolver
from tardis_tpu.transport.device_state import NU_UNIT, build_transport_tables
from tardis_tpu.transport.source import sample_blackbody_packets

from tests.test_plasma import BASE_CONFIG
from tests.test_torch_slice import CONFIG

torch.set_num_threads(2)

N = 1024
SEED = 7
HOT = 5.0
RECORDS = 8  # spawn-record rows a packet, as the final iteration keeps
TRACKED = dict(last_interaction=True, tracker_length=4)


@pytest.fixture(scope="module", params=["scatter", "macroatom"])
def problem(request):
    """``tests/test_torch_transport.py``'s set-up: one host-mode plasma
    solve in the JAX package, the same tables in both packages and a hot
    pool of N packets."""
    mode = request.param
    atom = make_synthetic_atom_data().prepare(
        selected_atoms=[8, 12, 14, 16, 18, 20], line_interaction_type=mode,
    )
    state = SimulationState.from_config(config_from_dict(BASE_CONFIG))
    ps = PlasmaSolver(atom, state).update(
        state.t_radiative, state.dilution_factor, line_mode="host"
    )
    port_atom = atom_data_from_arrays(atom_data_to_arrays(atom))
    chain = port_chain = None
    if mode == "macroatom":
        from tardis_tpu.opacities.macro_atom_solver import solve_macro_chain

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
    pool = sample_blackbody_packets(jax.random.fold_in(base, 0), N,
                                    HOT * state.t_inner)
    S, L = ps.tau_sobolev.shape[1], ps.tau_sobolev.shape[0]
    prefix = np.zeros((S, L + 1))
    np.cumsum(ps.tau_sobolev.T, axis=1, out=prefix[:, 1:])
    pstate = TorchState.from_config(torch_config(BASE_CONFIG))
    pt = torch_tables(pstate.geometry, ps.electron_densities,
                      torch.as_tensor(prefix), port_atom, mode,
                      macro_chain=port_chain)
    return dict(tables=tables, static=static, pool=pool,
                jax_key=jax.random.fold_in(base, 1), pt=pt,
                mu=torch.as_tensor(np.array(pool[0])),
                nu=torch.as_tensor(np.array(pool[1])),
                key=rng.fold_in(rng.key(SEED), 1))


@pytest.fixture(scope="module")
def port_runs(problem):
    """The port on one device and on 2, 4 and 8 CPU shards, with spawn
    records, last-interaction rows and the r-packet tracker."""
    p = problem
    kw = dict(vpacket_capacity=RECORDS * N, **TRACKED)
    runs = {1: transport_loop(p["pt"], p["mu"], p["nu"], p["key"], **kw)}
    for n_dev in (2, 4, 8):
        runs[n_dev] = run_transport_sharded(
            p["pt"], p["mu"], p["nu"], p["key"], ["cpu"] * n_dev, **kw)
    return runs


def _sorted_records(res):
    rows = res.vp_records[:res.n_vp_records].numpy()
    return rows[np.lexsort(rows.T[::-1])]


def _assert_same_run(a, b, fields=("est_j", "est_nubar", "line_diff",
                                   "summary")):
    """Per-packet rows bitwise, the sums within 1e-12 relative."""
    for name in ("out", "last_interaction", "tracker", "events"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for name in fields:
        np.testing.assert_allclose(getattr(b, name).numpy(),
                                   getattr(a, name).numpy(), rtol=1e-12,
                                   atol=0.0, err_msg=name)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_matches_one_device(port_runs, n_dev):
    one, sharded = port_runs[1], port_runs[n_dev]
    _assert_same_run(one, sharded)
    assert int(sharded.vp_count[0]) == int(one.vp_count[0]) > N
    assert sharded.n_vp_records == one.n_vp_records
    np.testing.assert_array_equal(_sorted_records(sharded),
                                  _sorted_records(one))
    assert (one.last_interaction[:, 0] > 0).any()


def test_sharded_weighted_pool(problem):
    """Per-packet weights follow their packets into the shards."""
    p = problem
    w = torch.as_tensor(np.random.default_rng(3).uniform(0.5, 1.5, N)
                        .astype(np.float32))
    one = transport_loop(p["pt"], p["mu"], p["nu"], p["key"], pool_w=w)
    two = run_transport_sharded(p["pt"], p["mu"], p["nu"], p["key"],
                                ["cpu", "cpu"], pool_w=w)
    _assert_same_run(one, two)
    assert not torch.equal(one.out, transport_loop(
        p["pt"], p["mu"], p["nu"], p["key"]).out)


def test_sharded_continuum():
    """K1's continuum instantiation on the port's IIP problem (H / He, the
    H I continua, full relativity), 64 packets capped at 300 events:
    per-packet event counts and rows bitwise, the grid moments and the
    free-free heating within 1e-12."""
    cfg = copy.deepcopy(BASE_CONFIG)
    cfg["model"]["abundances"] = {"H": 0.8, "He": 0.2}
    state = TorchState.from_config(torch_config(cfg))
    atom = torch_synthetic(
        atomic_numbers=(1, 2), max_ion_stage=2, n_levels=10,
        continuum_species=((1, 0),),
    ).prepare(line_interaction_type="macroatom")
    plasma = TorchPlasma(atom, state, "cpu")
    ps = plasma.update(state.t_radiative, state.dilution_factor)
    cont = TorchContinuum(atom, plasma).update(ps)
    macro = torch_macro(atom, ps, cont, ps.j_blues)
    ct = build_continuum_tables(state.geometry, atom, cont, macro, "cpu")
    pt = torch_tables(state.geometry, ps.electron_densities, ps.tau_prefix,
                      atom, "macroatom", full_relativity=True, continuum=ct)
    gen = np.random.default_rng(5)
    mu = torch.as_tensor(gen.uniform(0.0, 1.0, 64).astype(np.float32))
    nu = torch.as_tensor(gen.uniform(0.5, 5.0, 64).astype(np.float32))
    key = rng.fold_in(rng.key(SEED), 3)
    kw = dict(max_events=300, last_interaction=True)
    one = transport_loop(pt, mu, nu, key, **kw)
    two = run_transport_sharded(pt, mu, nu, key, ["cpu", "cpu"], **kw)
    _assert_same_run(one, two, ("est_j", "est_nubar", "summary",
                                "cont_moments", "est_ff_heat"))
    assert one.events.shape == (64,) and one.cont_moments.abs().sum() > 0


def test_sharded_matches_jax_sharded(problem, port_runs):
    """The port over 8 CPU shards against the JAX package's sharded run on
    its 8-device mesh: statuses agree on >= 0.95 of the packets, nu within
    1e-3 on >= 0.95, the bulk estimators within 5%."""
    p = problem
    mesh = packet_mesh()
    assert mesh.devices.size == 8
    carry = jax_sharded(p["tables"], p["static"], *p["pool"], p["jax_key"],
                        n_packets=N, batch_size=256, mesh=mesh)
    res = port_runs[8]
    nu_p = res.out[:, 0].numpy()
    status_p = np.where(nu_p > 0, 1, np.where(nu_p < 0, 2, 0))
    status_j = np.asarray(carry.out_status)
    match = status_p == status_j
    assert match.mean() >= 0.95, match.mean()
    nu_j = np.asarray(carry.out_nu, np.float64)
    close = np.abs(np.abs(nu_p.astype(np.float64)) - nu_j) <= 1e-3 * nu_j
    assert (match & close).mean() >= 0.95
    np.testing.assert_allclose(res.est_j.numpy(), carry.est_j_f64(),
                               rtol=0.05)
    np.testing.assert_allclose(res.est_nubar.numpy(), carry.est_nubar_f64(),
                               rtol=0.05)


def test_run_tardis_on_two_devices(monkeypatch):
    """run_tardis(device=["cpu", "cpu"]) takes the sharded path in every
    iteration (the old refusal of more than one device is gone) and gives
    the one-device run's t_inner and its real, virtual and integrated
    spectra within 1e-9."""
    shards = []

    def counted(*args, **kw):
        shards.append(len(args[4]))
        return run_transport_sharded(*args, **kw)

    atom = torch_synthetic().prepare(selected_atoms=[8, 12, 14, 16, 18, 20],
                                     line_interaction_type="macroatom")
    cfg = copy.deepcopy(CONFIG)
    cfg["montecarlo"]["no_of_virtual_packets"] = 2
    cfg["spectrum"]["method"] = "integrated"
    one = torch_run_tardis(copy.deepcopy(cfg), atom_data=atom, device="cpu")
    assert shards == []
    monkeypatch.setattr(solver_module, "run_transport_sharded", counted)
    two = torch_run_tardis(copy.deepcopy(cfg), atom_data=atom,
                           device=["cpu", "cpu"])
    assert shards == [2] * cfg["montecarlo"]["iterations"]
    assert two.transport.mesh == [torch.device("cpu")] * 2
    assert abs(two.state.t_inner / one.state.t_inner - 1) <= 1e-9
    for name in ("spectrum_real", "spectrum_virtual", "spectrum_integrated"):
        a = getattr(one, name).luminosity_nu
        np.testing.assert_allclose(getattr(two, name).luminosity_nu, a,
                                   rtol=1e-9, atol=1e-9 * np.abs(a).max())
        assert np.abs(a).sum() > 0


def test_indivisible_pool_takes_one_device(problem, caplog, monkeypatch):
    """A packet count that is not a multiple of the device count runs on
    one device, as in the JAX package, and the solver says so once;
    run_transport_sharded itself refuses it."""
    p = problem
    with pytest.raises(ValueError, match="not divisible"):
        run_transport_sharded(p["pt"], p["mu"][:1023], p["nu"][:1023],
                              p["key"], ["cpu"] * 2)
    monkeypatch.setattr(solver_module, "run_transport_sharded", None)
    atom = torch_synthetic().prepare(selected_atoms=[8, 12, 14, 16, 18, 20],
                                     line_interaction_type="macroatom")
    cfg = copy.deepcopy(CONFIG)
    cfg["montecarlo"].update(no_of_packets=1001, last_no_of_packets=1001)
    with caplog.at_level(logging.INFO, logger=solver_module.__name__):
        sim = torch_run_tardis(cfg, atom_data=atom, device=["cpu"] * 2)
    said = [r for r in caplog.records if "do not split" in r.getMessage()]
    assert len(said) == 1 and sim.last_transport_result.n_packets == 1001


def test_mesh_choice():
    """"auto" and None keep a CPU pool on its device; a list is taken as
    given (devices may repeat) and must start at the pool's device."""
    cpu = torch.device("cpu")
    assert solver_module.TransportSolver().devices_for(cpu) == [cpu]
    assert solver_module.TransportSolver(mesh=None).devices_for(cpu) \
        == [cpu]
    three = solver_module.TransportSolver(mesh=["cpu"] * 3)
    assert three.devices_for(cpu) == [cpu] * 3
    assert packet_devices(["cpu", "cpu"]) == [cpu, cpu]
    with pytest.raises(ValueError, match="first device"):
        solver_module.TransportSolver(mesh=["meta", "cpu"]) \
            .devices_for(cpu)
    with pytest.raises(ValueError, match="no device"):
        packet_devices([])
