"""Continuum transport with virtual packets: K1's continuum spawn records
(plain version) and the solver's volley against the JAX package.

The problem is the IIP test problem of ``test_torch_iip.py`` (H / He, H I
continua, macroatom, 20 shells, the first iteration's plasma with link
W^0.25) moved to 1.6e4-2.6e4 km/s at 14 days, at 1,000 packets.  Every
continuum process in this problem sits in a random walk: a packet that a
bound-free or free-free absorption activates re-emits near the Lyman
edge and is absorbed again, so no position of the problem gives type-3
records without a walk (the same problem at 16 days gives none at 3,000
packets; at 12 days the longest packet walks 3,358 events at 300).  Here
one packet walks 1,177 events and makes nearly all of the run's 1,155
continuum-process records; the mean is 20 events a packet and the 3,028
attempts fit the 8,000 rows of the capacity, so no record is dropped.
Both packages' lockstep loops run as many steps as that packet, a few
seconds each on the CPU.

Both packages take the same atom data (``atomic/convert.py``), the same
pools and run keys, so they draw the same threefry bits; the records are
compared as multisets (the two lane schedules append them in other
orders; ``_canonical``): the integer columns (shell, next line, type, out
line) equal, the f32 columns within RTOL / ATOL.
"""

import copy
import logging

import jax
import numpy as np
import pytest
import torch

from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.config.reader import config_from_dict as torch_config
from tardis_torch.model.state import SimulationState as TorchState
from tardis_torch.opacities.continuum_macro import (
    solve_continuum_macro_state as torch_macro,
)
from tardis_torch.parallel.transport import run_transport_sharded
from tardis_torch.plasma.continuum import ContinuumSolver as TorchContinuum
from tardis_torch.plasma.solver import PlasmaSolver as TorchPlasma
from tardis_torch.transport import rng
from tardis_torch.transport import solver as torch_solver_module
from tardis_torch.transport.kernel import transport_loop_plain
from tardis_torch.transport.solver import TransportSolver as TorchSolver
from tardis_torch.transport.tables import (
    build_continuum_tables,
    build_transport_tables as torch_tables,
)
from tardis_tpu.atomic.synthetic import make_synthetic_atom_data
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.model.state import SimulationState
from tardis_tpu.opacities.continuum_macro import solve_continuum_macro_state
from tardis_tpu.plasma.continuum import ContinuumSolver
from tardis_tpu.plasma.solver import PlasmaSolver
from tardis_tpu.transport.device_state import build_transport_tables
from tardis_tpu.transport.kernel import run_transport
from tardis_tpu.transport.solver import TransportSolver
from tardis_tpu.transport.source import sample_blackbody_packets_relativistic

from tests.test_torch_iip import CONFIG as IIP_CONFIG

torch.set_num_threads(2)

N = 1000
PER_PACKET = 8
SEED = 23111963
N_VPACKETS = 2
CAP_N, CAP = 256, 300  # test_adiabatic_rows_capped
# f32 columns of a record, against the drift along a walk (XLA's and
# PyTorch's sqrt / exp / log part in the last bit and every event
# compounds it; no trajectory parts).  Measured: 9.3e-6 relative on the
# energy, 1.4e-6 on r, 1.2e-7 absolute on mu near 0 (walk of 1,177
# events); 2.3e-5 on the energy in test_adiabatic_rows_capped
RTOL, ATOL = 5e-5, 1e-6
SPECTRUM_RTOL = 1e-4  # the virtual spectrum's total and its larger bins
CONFIG = copy.deepcopy(IIP_CONFIG)
CONFIG["model"]["structure"]["velocity"].update(start="1.6e4 km/s",
                                                stop="2.6e4 km/s")
CONFIG["supernova"]["time_explosion"] = "14 day"
CONFIG["montecarlo"].update(no_of_packets=N, last_no_of_packets=N)
# the two-photon and adiabatic channels, boosted as tests/test_continuum.py
# boosts them (A_2ph 1e12 / s, the adiabatic rate at t_exp / 1e8)
CHANNELS = dict(enable_two_photon=True, enable_adiabatic_cooling=True)
# the configuration's 500-20,000 Angstrom in 100 bins, in Hz
EDGES = 2.99792458e18 / np.linspace(20000.0, 500.0, 101)
INT_COLS = [4, 5, 6, 7]  # shell, next_line, li_type, out_line
FLOAT_COLS = [0, 1, 2, 3]  # r, mu, nu, energy


def _atom():
    return make_synthetic_atom_data(
        atomic_numbers=(1, 2), max_ion_stage=2, n_levels=10,
        continuum_species=((1, 0),),
    ).prepare(line_interaction_type="macroatom")


@pytest.fixture(scope="module")
def problem():
    return _problem(CONFIG)


def _problem(config):
    """The first iteration's plasma (link W^0.25, as the IIP workflow
    starts) and continuum state in each package."""
    state = SimulationState.from_config(config_from_dict(config))
    atom = _atom()
    pls = PlasmaSolver(atom, state)
    pls.link_t_rad_t_electron = state.dilution_factor**0.25
    ps = pls.update(state.t_radiative, state.dilution_factor)
    tatom = atom_data_from_arrays(atom_data_to_arrays(atom))
    tstate = TorchState.from_config(torch_config(config))
    tpl = TorchPlasma(tatom, tstate, "cpu")
    tpl.link_t_rad_t_electron = tstate.dilution_factor**0.25
    tps = tpl.update(tstate.t_radiative, tstate.dilution_factor)
    return dict(state=state, atom=atom, ps=ps,
                cont=ContinuumSolver(atom, pls).update(ps), tstate=tstate,
                tatom=tatom, tps=tps, tcont=TorchContinuum(tatom, tpl)
                .update(tps))


def _macros(p, channels):
    atom, tatom = p["atom"], p["tatom"]
    kw = tkw = {}
    if channels:
        atom, tatom = copy.deepcopy(atom), copy.deepcopy(tatom)
        atom.two_photon.A_ul[:] = 1e12
        tatom.two_photon.A_ul[:] = 1e12
        kw = dict(CHANNELS, time_explosion=p["state"].time_explosion / 1e8)
        tkw = dict(CHANNELS, time_explosion=p["tstate"].time_explosion / 1e8)
    macro = solve_continuum_macro_state(atom, p["ps"], p["cont"],
                                        p["ps"].j_blues, **kw)
    tmacro = torch_macro(tatom, p["tps"], p["tcont"], p["tps"].j_blues,
                         **tkw)
    return atom, tatom, macro, tmacro


def _tables(p, channels):
    atom, tatom, macro, tmacro = _macros(p, channels)
    tables, static = build_transport_tables(
        p["state"].geometry, p["ps"], atom, "macroatom",
        enable_full_relativity=True, continuum_state=p["cont"],
        continuum_macro=macro)
    ct = build_continuum_tables(p["tstate"].geometry, tatom, p["tcont"],
                                tmacro, "cpu")
    pt = torch_tables(p["tstate"].geometry, p["tps"].electron_densities,
                      p["tps"].tau_prefix, tatom, "macroatom",
                      full_relativity=True, continuum=ct)
    return tables, static, pt


def _pool(p, tables):
    base = jax.random.key(np.uint32(SEED))
    pool = sample_blackbody_packets_relativistic(
        jax.random.fold_in(base, 0), N, p["state"].t_inner,
        float(tables.r_inner[0]))
    return pool, tuple(torch.as_tensor(np.array(a)) for a in pool)


def _run_jax(tables, static, pool, capacity):
    return run_transport(
        tables, static._replace(vpacket_capacity=capacity,
                                track_last_interaction=True),
        *pool[:2], jax.random.fold_in(jax.random.key(np.uint32(SEED)), 1),
        n_packets=N, batch_size=N, pool_w=pool[2])


def _run_port(pt, tpool, capacity, batch_size=N):
    mu, nu, w = tpool
    return transport_loop_plain(pt, mu, nu, rng.fold_in(rng.key(SEED), 1),
                                batch_size=batch_size,
                                vpacket_capacity=capacity, pool_w=w,
                                last_interaction=True)


@pytest.fixture(scope="module", params=["iip", "channels"])
def runs(request, problem):
    """Both event loops on the pool with a capacity of PER_PACKET records
    a packet, and (port) with half a record a packet."""
    channels = request.param == "channels"
    tables, static, pt = _tables(problem, channels)
    pool, tpool = _pool(problem, tables)
    cap = PER_PACKET * N
    return dict(channels=channels, pt=pt, tpool=tpool, tables=tables,
                static=static, pool=pool,
                jax=_run_jax(tables, static, pool, cap),
                port=_run_port(pt, tpool, cap))


def _canonical(rows, exact=(4, 5, 6, 7)):
    """Rows as a multiset that tolerates float drift: sorted by the
    ``exact`` columns, and within each group of equal ``exact`` columns
    every other column sorted on its own.  Two multisets whose matched
    rows differ by at most e in a column give, column by column, sorted
    values that differ by at most e, whichever rows the drift reorders."""
    rows = np.asarray(rows, np.float64)
    exact = list(exact)
    rest = [c for c in range(rows.shape[1]) if c not in exact]
    rows = rows[np.lexsort([rows[:, c] for c in exact][::-1])]
    out = rows.copy()
    keys = rows[:, exact]
    cut = np.nonzero((np.diff(keys, axis=0) != 0).any(axis=1))[0] + 1
    for lo, hi in zip(np.r_[0, cut], np.r_[cut, len(rows)]):
        out[lo:hi, rest] = np.sort(rows[lo:hi, rest], axis=0)
    return out


def _kept(carry):
    n = min(int(carry.vp_count), carry.vp_packed.shape[0])
    return np.asarray(carry.vp_packed)[:n]


def test_record_counts(runs):
    """Equal attempts, all kept, equal counts by type; births one a packet,
    type-3 rows present (the continuum processes) in the plain run."""
    j, p = runs["jax"], runs["port"]
    assert int(j.vp_count) == int(p.vp_count[0]) <= PER_PACKET * N
    kinds_p = p.vp_records[:p.n_vp_records, 6].numpy()
    kinds_j = _kept(j)[:, 6]
    for kind in (-1.0, 1.0, 2.0, 3.0):
        assert (kinds_p == kind).sum() == (kinds_j == kind).sum(), kind
    assert (kinds_p == -1).sum() == N
    assert (kinds_p == 2).sum() >= 1
    # the channels change the emission before the walk's first continuum
    # process, so only the plain run walks and has type-3 rows
    assert ((kinds_p == 3).sum() >= 1) != runs["channels"]
    # births + interactions: one row a birth and one an interaction
    assert int(p.vp_count[0]) == N + int((kinds_p > 0).sum())


def test_records_multiset(runs):
    """The records as multisets: integer columns equal, f32 columns within
    RTOL / ATOL (the channels' run, with no walk: 6.3e-7 relative at most);
    a continuum-process row carries out_line = next_line - 1, an e-scatter
    -1."""
    rows_p = _canonical(runs["port"].vp_records[:runs["port"].n_vp_records])
    rows_j = _canonical(_kept(runs["jax"]))
    assert rows_p.shape == rows_j.shape
    np.testing.assert_array_equal(rows_p[:, INT_COLS], rows_j[:, INT_COLS])
    np.testing.assert_allclose(rows_p[:, FLOAT_COLS], rows_j[:, FLOAT_COLS],
                               rtol=RTOL, atol=ATOL)
    cont = rows_p[rows_p[:, 6] == 3]
    np.testing.assert_array_equal(cont[:, 7], cont[:, 5] - 1)
    assert (rows_p[rows_p[:, 6] == 1, 7] == -1).all()


def test_overflow_counted_and_dropped(runs):
    """Past the capacity the attempts are still counted and the rows are
    dropped: the kept rows are the first ``capacity`` of the full run, in
    both packages (each with its own lane schedule)."""
    small = N // 2
    full = runs["port"]
    port_small = _run_port(runs["pt"], runs["tpool"], small)
    assert int(port_small.vp_count[0]) == int(full.vp_count[0]) > small
    assert port_small.n_vp_records == small
    assert torch.equal(port_small.vp_records, full.vp_records[:small])
    j_small = _run_jax(runs["tables"], runs["static"], runs["pool"], small)
    assert int(j_small.vp_count) == int(runs["jax"].vp_count) > small
    np.testing.assert_array_equal(np.asarray(j_small.vp_packed),
                                  _kept(runs["jax"])[:small])


def test_lane_count_independent(runs):
    """Where nothing is dropped the kept set does not depend on the lane
    count: 1,000 lanes and 64 refilled lanes write the same rows, bit for
    bit as a multiset."""
    a = runs["port"]
    b = _run_port(runs["pt"], runs["tpool"], PER_PACKET * N, batch_size=64)
    assert int(a.vp_count[0]) == int(b.vp_count[0])
    np.testing.assert_array_equal(_canonical(a.vp_records[:a.n_vp_records]),
                                  _canonical(b.vp_records[:b.n_vp_records]))
    assert torch.equal(a.out, b.out)


def test_sharded_records(runs):
    """Two CPU shards keep every record of one device's run (each shard
    its half of the capacity), bit for bit as a multiset."""
    mu, nu, w = runs["tpool"]
    one = runs["port"]
    two = run_transport_sharded(runs["pt"], mu, nu,
                                rng.fold_in(rng.key(SEED), 1), ["cpu", "cpu"],
                                vpacket_capacity=PER_PACKET * N, pool_w=w,
                                last_interaction=True)
    assert int(two.vp_count[0]) == int(one.vp_count[0])
    np.testing.assert_array_equal(
        _canonical(two.vp_records[:two.n_vp_records]),
        _canonical(one.vp_records[:one.n_vp_records]))


@pytest.fixture(scope="module")
def solvers(problem):
    """Both packages' ``TransportSolver.run_iteration`` with the continuum
    state and N_VPACKETS virtual packets a record, packet logging on."""
    atom, tatom, macro, tmacro = _macros(problem, False)
    kw = dict(n_packets=N, seed=SEED, iteration=0, n_vpackets=N_VPACKETS,
              spectrum_nu_edges=EDGES, need_line_estimators=False)
    ref = TransportSolver("macroatom", vpacket_tracking=True,
                          track_last_interaction=True, mesh=None
                          ).run_iteration(
        problem["state"], problem["ps"], atom, continuum_state=problem["cont"],
        continuum_macro=macro, **kw)
    port = TorchSolver("macroatom", vpacket_tracking=True,
                       track_last_interaction=True, mesh=None).run_iteration(
        problem["tstate"], problem["tps"], tatom,
        continuum_state=problem["tcont"], continuum_macro=tmacro, **kw)
    return ref, port


def test_virtual_spectrum(solvers):
    """Equal attempts; the virtual spectrum's total within SPECTRUM_RTOL
    and every bin above 1e-3 of the largest within SPECTRUM_RTOL (K4 sums
    each ray's f32 attenuation in the same order in both packages; the
    histograms differ in the order of their f32 / f64 adds)."""
    ref, port = solvers
    assert port.vp_records == ref.vp_records <= PER_PACKET * N
    a, b = port.virt_energy_hist, ref.virt_energy_hist
    assert a.shape == b.shape and np.isfinite(a).all() and b.sum() > 0
    assert abs(a.sum() - b.sum()) <= SPECTRUM_RTOL * b.sum()
    big = b > 1e-3 * b.max()
    np.testing.assert_allclose(a[big], b[big], rtol=SPECTRUM_RTOL)


def _normal(rows):
    """The rows whose virtual packet's energy (column 3, in packet units
    N x erg) is a normal f32: XLA on the CPU flushes subnormal results to
    zero, so a ray attenuated below 1.2e-38 ends at 0 in the JAX package
    and subnormal in the port (34 type-3 rows of this run, each at most
    4e-44 of a packet)."""
    return rows[rows[:, 3] * N >= np.finfo(np.float32).tiny]


def test_vpacket_tracking_rows(solvers):
    """The ``virt_packet_*`` rows as multisets (``_normal`` ones): the same
    number, types and out ids equal, the floats within RTOL; continuum-
    process rows (type 3) among them."""
    ref, port = solvers
    names = ("virt_packet_last_interaction_type",
             "virt_packet_last_line_interaction_out_id", "virt_packet_nus",
             "virt_packet_energies", "virt_packet_initial_rs",
             "virt_packet_initial_mus",
             "virt_packet_last_interaction_in_nu")
    rows_p, rows_j = (_canonical(_normal(np.stack(
        [r.vpackets[n] for n in names], axis=1)), exact=(0, 1))
        for r in (port, ref))
    assert rows_p.shape == rows_j.shape and rows_p.shape[0] > 0
    np.testing.assert_array_equal(rows_p[:, :2], rows_j[:, :2])
    rel = [2, 3, 4, 6]  # nu, energy, r, in_nu; mu (5) near 0 by ATOL
    np.testing.assert_allclose(rows_p[:, rel], rows_j[:, rel], rtol=RTOL)
    np.testing.assert_allclose(rows_p[:, 5], rows_j[:, 5], rtol=0.0,
                               atol=ATOL)
    assert (rows_p[:, 0] == 3).sum() >= 1
    assert port.vpackets["virt_packet_last_interaction_type"].dtype == np.int8


def test_solver_overflow_warns(problem, monkeypatch, caplog):
    """With one record a packet the attempts overflow: the solver counts
    them all, keeps exactly ``capacity`` rows and warns."""
    atom, tatom, macro, tmacro = _macros(problem, False)
    monkeypatch.setattr(torch_solver_module, "VPACKET_RECORDS_PER_PACKET", 1)
    seen = {}
    volley = torch_solver_module.trace_vpacket_records

    def spy(tables, records, *args, **kw):
        seen["rows"] = records.shape[0]
        return volley(tables, records, *args, **kw)

    monkeypatch.setattr(torch_solver_module, "trace_vpacket_records", spy)
    with caplog.at_level(logging.WARNING, logger=torch_solver_module.__name__):
        res = TorchSolver("macroatom", mesh=None).run_iteration(
            problem["tstate"], problem["tps"], tatom, n_packets=N, seed=SEED,
            iteration=0, n_vpackets=N_VPACKETS,
            spectrum_nu_edges=EDGES,
            need_line_estimators=False, continuum_state=problem["tcont"],
            continuum_macro=tmacro)
    assert res.vp_records > N and seen["rows"] == N
    assert any("past the capacity" in r.getMessage() for r in caplog.records)


def test_adiabatic_rows_capped():
    """The channels on the JAX package's own IIP problem (1.1e4-2e4 km/s
    at 13 days), where continuum processes and adiabatic deaths are common
    but walks are long: CAP_N packets, both loops stopped at CAP events a
    packet (the JAX loop runs lockstep with batch_size = CAP_N, so its
    max_steps is a per-packet cap), every attempt kept.  A packet the
    adiabatic channel ends writes its type-3 row with the state after the
    emission; the records agree as multisets within RTOL / ATOL."""
    cfg = copy.deepcopy(CONFIG)
    cfg["model"]["structure"]["velocity"].update(start="1.1e4 km/s",
                                                 stop="2e4 km/s")
    cfg["supernova"]["time_explosion"] = "13 day"
    p = _problem(cfg)
    tables, static, pt = _tables(p, True)
    base = jax.random.key(np.uint32(SEED))
    pool = sample_blackbody_packets_relativistic(
        jax.random.fold_in(base, 0), CAP_N, p["state"].t_inner,
        float(tables.r_inner[0]))
    cap = CAP * CAP_N
    carry = run_transport(
        tables, static._replace(vpacket_capacity=cap,
                                track_last_interaction=True),
        *pool[:2], jax.random.fold_in(base, 1), n_packets=CAP_N,
        batch_size=CAP_N, max_steps=CAP, pool_w=pool[2])
    mu, nu, w = (torch.as_tensor(np.array(a)) for a in pool)
    res = transport_loop_plain(pt, mu, nu, rng.fold_in(rng.key(SEED), 1),
                               batch_size=CAP_N, max_events=CAP,
                               vpacket_capacity=cap, pool_w=w,
                               last_interaction=True)
    adiabatic = (res.out[:, 0] < 0) & (res.out[:, 1] == 0)
    assert int(adiabatic.sum()) >= 1
    assert int(res.vp_count[0]) == int(carry.vp_count) <= cap
    rows_p = _canonical(res.vp_records[:res.n_vp_records])
    rows_j = _canonical(_kept(carry))
    assert (rows_p[:, 6] == 3).sum() >= 1
    np.testing.assert_array_equal(rows_p[:, INT_COLS], rows_j[:, INT_COLS])
    np.testing.assert_allclose(rows_p[:, FLOAT_COLS], rows_j[:, FLOAT_COLS],
                               rtol=RTOL, atol=ATOL)
