"""What the trace recorder holds of a sharded iteration
(``tardis_torch/parallel/transport.py``): a ``tardis.shard_tables`` span
for each shard's sends, a ``tardis.shard_reduce`` span, the counter
``shard.shards`` and the bytes queued between devices,
``shard.peer_bytes``, against a count from the shapes; and that the
records leave every packet's outputs bitwise those of one device."""

import copy

import pytest
import torch

from tardis_torch import tracing
from tardis_torch.atomic.synthetic import make_synthetic_atom_data
from tardis_torch.config.reader import config_from_dict
from tardis_torch.model.state import SimulationState
from tardis_torch.opacities.macro_atom_solver import solve_macro_chain
from tardis_torch.parallel.transport import run_transport_sharded
from tardis_torch.plasma.solver import PlasmaSolver
from tardis_torch.transport.kernel import transport_loop
from tardis_torch.transport.solver import iteration_keys
from tardis_torch.transport.source import blackbody_source
from tardis_torch.transport.tables import NU_UNIT, build_transport_tables

torch.set_num_threads(2)

N = 1024
S = 5
CONFIG = {
    "supernova": {"luminosity_requested": "9.44 log_lsun",
                  "time_explosion": "13 day"},
    "model": {"structure": {"type": "specific",
                            "velocity": {"start": "1.1e4 km/s",
                                         "stop": "20000 km/s", "num": S},
                            "density": {"type": "branch85_w7"}},
              "abundances": {"type": "uniform", "O": 0.19, "Mg": 0.03,
                             "Si": 0.52, "S": 0.19, "Ar": 0.04,
                             "Ca": 0.03}},
    "plasma": {"line_interaction_type": "macroatom"},
    "montecarlo": {"seed": 23, "no_of_packets": N, "iterations": 1},
    "spectrum": {"start": "500 angstrom", "stop": "20000 angstrom",
                 "num": 100},
}
OPTIONS = dict(last_interaction=True, line_estimators=False)


@pytest.fixture(scope="module")
def problem():
    """The port's tables of a 5-shell W7 model in macro-atom mode and a
    pool of N packets, all on the CPU."""
    state = SimulationState.from_config(config_from_dict(
        copy.deepcopy(CONFIG)))
    atom = make_synthetic_atom_data(n_levels=10).prepare(
        selected_atoms=[8, 12, 14, 16, 18, 20],
        line_interaction_type="macroatom")
    ps = PlasmaSolver(atom, state, "cpu").update(state.t_radiative,
                                                 state.dilution_factor)
    chain = solve_macro_chain(
        atom.macro_atom, ps.beta_sobolev, ps.j_blues,
        ps.stimulated_emission_factor, mode="macroatom",
        line_nu_scaled=atom.line_nu / NU_UNIT)
    tables = build_transport_tables(
        state.geometry, ps.electron_densities, ps.tau_prefix, atom,
        line_interaction_type="macroatom", macro_chain=chain)
    src, run = iteration_keys(23, 0)
    mu, nu, _ = blackbody_source(src, N, state.t_inner, "cpu", "simple")
    one = transport_loop(tables, mu, nu, run, **OPTIONS)
    return dict(tables=tables, mu=mu, nu=nu, key=run, one=one)


def table_bytes(t) -> int:
    """The classic macro-atom tables' bytes from their shapes: r_inner,
    r_outer, chi_e (S f32 each), line_nu (L f32), the tau prefix (S x
    (L + 1) f64), line2macro (L i32), the chain and emission CDFs (f32)."""
    L = t.line_nu.shape[0]
    rows, chain = t.chain_cdf.shape
    emit = t.emit_cdf.shape[1]
    return 3 * S * 4 + L * 4 + S * (L + 1) * 8 + L * 4 + rows * chain * 4 \
        + t.emit_cdf.shape[0] * emit * 4


@pytest.mark.parametrize("devices", [
    ["cpu"] * 4, ["cpu:0", "cpu:1", "cpu:2", "cpu:3"]],
    ids=["one_device_repeated", "four_devices"])
def test_sharded_iteration_records(problem, devices):
    p = problem
    tracing.start()
    it = tracing.next_iteration()
    res = run_transport_sharded(p["tables"], p["mu"], p["nu"], p["key"],
                                devices, **OPTIONS)
    tracing.stop()
    recs = tracing.records()
    names = [s.name for s in recs["spans"]]
    assert names == ["tardis.shard_tables"] * 4 + ["tardis.shard_reduce"]
    counters = recs["by_iteration"][it]
    assert counters["shard.shards"] == 4
    moved = 0
    if devices[1] != devices[0]:
        # three devices receive the tables and a quarter of the pool (mu,
        # nu: 8 B a packet) each, and send back their rows: out (8 B),
        # last interaction (24 B), the plain version's event counts (4 B)
        # a packet, and the sums: j, nu-bar (S f64), the summary (4 f64),
        # the record count and the search fallbacks (1 i64 each)
        quarter = N // 4
        moved = 3 * (table_bytes(p["tables"]) + quarter * 8
                     + quarter * (8 + 24 + 4) + 2 * S * 8 + 4 * 8 + 8 + 8)
    assert counters["shard.peer_bytes"] == moved
    one = p["one"]
    for name in ("out", "last_interaction", "events"):
        assert torch.equal(getattr(res, name), getattr(one, name)), name
    torch.testing.assert_close(res.est_j, one.est_j, rtol=1e-12, atol=0)


def test_no_records_when_off(problem):
    """Off the profiler and outside start()/stop() the sharded run records
    nothing and counts only the reduce's launch."""
    from tardis_torch.parallel.transport import _final_reduce

    p = problem
    tracing.stop()
    before = dict(_final_reduce.launches_by_variant)
    tracing.start()
    tracing.stop()
    res = run_transport_sharded(p["tables"], p["mu"], p["nu"], p["key"],
                                ["cpu"] * 2, **OPTIONS)
    assert tracing.records()["spans"] == []
    assert tracing.records()["counters"] == {}
    assert _final_reduce.launches_by_variant.get("shard_reduce", 0) == \
        before.get("shard_reduce", 0) + 1
    assert torch.equal(res.out, p["one"].out)
