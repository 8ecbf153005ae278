"""K1's vpacket spawn records (plain version) against the JAX event loop.

Both packages run the 5x-hot 1,024-packet macroatom pool of
``test_torch_transport.py`` with the same tables and run key, so they write
the same records up to the few trajectories that part ways there; counts
must agree within 1%, and the virtual spectra each package's volley makes
from its own records within 2% in total.  The order of the records differs
(lane schedules differ), so rows are compared as multisets.
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
from tardis_torch.transport.kernel import transport_loop_plain
from tardis_torch.transport.tables import build_transport_tables as torch_tables
from tardis_torch.transport.vpacket import trace_vpacket_records_plain
from tardis_tpu.atomic.synthetic import make_synthetic_atom_data
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.model.state import SimulationState
from tardis_tpu.opacities.macro_atom_solver import solve_macro_chain
from tardis_tpu.plasma.solver import PlasmaSolver
from tardis_tpu.transport.device_state import NU_UNIT, build_transport_tables
from tardis_tpu.transport.kernel import run_transport
from tardis_tpu.transport.source import sample_blackbody_packets
from tardis_tpu.transport.vpacket import trace_vpacket_records

from tests.test_plasma import BASE_CONFIG

torch.set_num_threads(2)

N = 1024
SEED = 7
HOT = 5.0
PER_PACKET = 8
SMALL = N // 2  # a capacity the records overflow
MODE = "macroatom"


def both_tables(mode=MODE, full_relativity=False):
    """(JAX tables, static, port tables, geometry state, plasma) built from
    one host-mode plasma solve of ``BASE_CONFIG``, for the classic or the
    full-relativity event loop."""
    atom = make_synthetic_atom_data().prepare(
        selected_atoms=[8, 12, 14, 16, 18, 20], line_interaction_type=mode,
    )
    state = SimulationState.from_config(config_from_dict(BASE_CONFIG))
    ps = PlasmaSolver(atom, state).update(
        state.t_radiative, state.dilution_factor, line_mode="host"
    )
    port_atom = atom_data_from_arrays(atom_data_to_arrays(atom))
    chain = port_chain = None
    if mode != "scatter":
        args = (ps.beta_sobolev, ps.j_blues, ps.stimulated_emission_factor)
        chain = solve_macro_chain(atom.macro_atom, *args, mode=mode,
                                  line_nu_scaled=atom.line_nu / NU_UNIT)
        port_chain = torch_chain(port_atom.macro_atom,
                                 *(torch.as_tensor(a) for a in args),
                                 mode=mode,
                                 line_nu_scaled=atom.line_nu / NU_UNIT)
    tables, static = build_transport_tables(
        state.geometry, ps, atom, mode, macro_chain=chain,
        enable_full_relativity=full_relativity,
    )
    S, L = ps.tau_sobolev.shape[1], ps.tau_sobolev.shape[0]
    prefix = np.zeros((S, L + 1))
    np.cumsum(ps.tau_sobolev.T, axis=1, out=prefix[:, 1:])
    pstate = TorchState.from_config(torch_config(BASE_CONFIG))
    pt = torch_tables(pstate.geometry, ps.electron_densities,
                      torch.as_tensor(prefix), port_atom, mode,
                      macro_chain=port_chain, full_relativity=full_relativity)
    return tables, static, pt, state, ps


@pytest.fixture(scope="module")
def runs():
    tables, static, pt, state, _ = both_tables()
    base = jax.random.key(np.uint32(SEED))
    # a hot pool: at t_inner only ~1% of packets meet an optically thick line
    pool_mu, pool_nu = sample_blackbody_packets(
        jax.random.fold_in(base, 0), N, HOT * state.t_inner
    )
    jax_runs = {
        cap: run_transport(tables, static._replace(vpacket_capacity=cap),
                           pool_mu, pool_nu, jax.random.fold_in(base, 1),
                           n_packets=N, batch_size=256)
        for cap in (PER_PACKET * N, SMALL)
    }
    mu_t = torch.as_tensor(np.array(pool_mu))
    nu_t = torch.as_tensor(np.array(pool_nu))
    run_key = rng.fold_in(rng.key(SEED), 1)
    port_runs = {
        cap: transport_loop_plain(pt, mu_t, nu_t, run_key, batch_size=256,
                                  vpacket_capacity=cap)
        for cap in (PER_PACKET * N, SMALL, 0)
    }
    return tables, static, pt, jax_runs, port_runs


def _sorted_rows(a):
    """Rows ordered lexicographically (a multiset in canonical order)."""
    a = np.asarray(a, np.float64)
    return a[np.lexsort(a.T[::-1])]


def test_record_counts_agree(runs):
    _, _, _, jax_runs, port_runs = runs
    n_jax = int(jax_runs[PER_PACKET * N].vp_count)
    port = port_runs[PER_PACKET * N]
    n_port = int(port.vp_count[0])
    assert N < n_port <= PER_PACKET * N  # births + interactions, no overflow
    assert abs(n_port / n_jax - 1) < 0.01, (n_port, n_jax)
    assert port.n_vp_records == n_port


def test_record_layout(runs):
    """Birth rows are [beta_inner, mu, nu, energy, 0, birth_line, -1, -1],
    one per packet and equal to the JAX package's to f32 rounding; an
    interaction row carries li_type 1 (e-scatter) or 2 (line) and, for a
    line, out_line = next_line - 1."""
    tables, _, pt, jax_runs, port_runs = runs
    port = port_runs[PER_PACKET * N]
    rec = port.vp_records[:port.n_vp_records].numpy()
    birth = rec[rec[:, 6] == -1]
    assert len(birth) == N
    assert (birth[:, 0] == pt.r_inner[0].item()).all()
    assert (birth[:, 4] == 0).all() and (birth[:, 7] == -1).all()
    jax_rec = np.asarray(jax_runs[PER_PACKET * N].vp_packed)
    jax_birth = jax_rec[jax_rec[:, 6] == -1]
    np.testing.assert_allclose(_sorted_rows(birth), _sorted_rows(jax_birth),
                               rtol=1e-6)
    inter = rec[rec[:, 6] != -1]
    assert set(np.unique(inter[:, 6])) <= {1.0, 2.0}
    line = inter[:, 6] == 2
    assert line.any() and (~line).any()
    np.testing.assert_array_equal(inter[line, 7], inter[line, 5] - 1)
    assert (inter[~line, 7] == -1).all()
    assert (inter[:, 4] >= 0).all() and (inter[:, 4] < pt.n_shells).all()


def test_interaction_rows_match_jax(runs):
    """Every interaction row, the state after the scatter, has a twin among
    the JAX package's rows: shell, next_line, li_type and out_line equal;
    mu, nu and energy within rtol 1e-6 (a few f32 ulps of the Doppler
    factors); r within rtol 1e-5 (the distance to a resonance is a
    difference of nearly equal f32 numbers, so XLA's operation order moves
    r by up to ~3e-6 relative).  A row written before the scatter, or in
    the comoving frame, misses by percents.  At least 99.9% of the rows
    must match (a trajectory that parts ways loses its later rows)."""
    from scipy.spatial import cKDTree

    _, _, _, jax_runs, port_runs = runs
    port = port_runs[PER_PACKET * N]
    rec = port.vp_records[:port.n_vp_records].numpy().astype(np.float64)
    carry = jax_runs[PER_PACKET * N]
    jax_rec = np.asarray(carry.vp_packed, np.float64)[:int(carry.vp_count)]
    ours, theirs = rec[rec[:, 6] != -1], jax_rec[jax_rec[:, 6] != -1]
    assert len(ours) > 100 and abs(len(ours) / len(theirs) - 1) < 0.01

    def features(x):
        # log differences are relative differences; each column is scaled
        # so that its tolerance becomes 1e-6, and the integer columns, which
        # differ by at least 1, must be equal
        return np.column_stack([0.1 * np.log(x[:, 0]), x[:, 1],
                                np.log(x[:, 2]), np.log(x[:, 3]), x[:, 4:]])

    dist, _ = cKDTree(features(theirs)).query(features(ours), p=np.inf)
    matched = float((dist <= 1e-6).mean())
    assert matched >= 0.999, matched


def test_virtual_spectra_agree(runs):
    """Each package's volley on its own records: totals within 2%."""
    tables, static, pt, jax_runs, port_runs = runs
    edges = np.linspace(0.05, 4.0, 61).astype(np.float32)
    carry = jax_runs[PER_PACKET * N]
    vp = carry.vp_packed
    h_jax = np.asarray(trace_vpacket_records(
        tables, static, vp[:, 0], vp[:, 1], vp[:, 2], vp[:, 3],
        vp[:, 4].astype(np.int32), vp[:, 5].astype(np.int32),
        n_vpackets=2, nu_bin_edges=jax.numpy.asarray(edges), n_bins=60,
    ), np.float64)
    port = port_runs[PER_PACKET * N]
    h_port = trace_vpacket_records_plain(
        pt, port.vp_records[:port.n_vp_records], 2, torch.as_tensor(edges),
    ).hist.numpy()
    assert h_jax.sum() > 0
    assert abs(h_port.sum() / h_jax.sum() - 1) < 0.02


def test_capacity_zero_unchanged(runs):
    """Writing records changes no other output, bit for bit; without a
    capacity nothing is written."""
    _, _, _, _, port_runs = runs
    a, b = port_runs[0], port_runs[PER_PACKET * N]
    for name in ("out", "est_j", "est_nubar", "line_diff", "summary"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.vp_records.shape == (0, 8) and int(a.vp_count[0]) == 0
    assert a.n_vp_records == 0


def test_overflow_counted_and_dropped(runs):
    """Past the capacity the attempts are still counted and the rows are
    dropped: the kept rows are the first ``capacity`` of the full run, in
    both packages (each with its own lane schedule)."""
    _, _, _, jax_runs, port_runs = runs
    full, small = port_runs[PER_PACKET * N], port_runs[SMALL]
    assert int(small.vp_count[0]) == int(full.vp_count[0]) > SMALL
    assert small.n_vp_records == SMALL
    assert torch.equal(small.vp_records, full.vp_records[:SMALL])
    j_full, j_small = jax_runs[PER_PACKET * N], jax_runs[SMALL]
    assert int(j_small.vp_count) == int(j_full.vp_count) > SMALL
    np.testing.assert_array_equal(np.asarray(j_small.vp_packed),
                                  np.asarray(j_full.vp_packed)[:SMALL])
