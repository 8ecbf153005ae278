"""K1's trackers and reflective inner boundary (plain version) against the
JAX event loop, and the default configuration end to end.

The JAX package tracks each packet's last interaction unless a
configuration turns it off (``montecarlo.tracking.track_last_interaction``
defaults to true), so a configuration without a ``tracking`` section must
run through the port and return the same table.  Both event loops get the
5x-hot 1,024-packet macroatom pool of ``test_torch_transport.py``, the same
tables and run key; rows are compared on the packets whose trajectories
agree (status equal, final nu within 1e-3).
"""

import copy

import jax
import numpy as np
import pytest
import torch

from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.simulation.base import run_tardis as torch_run_tardis
from tardis_torch.transport import rng
from tardis_torch.transport.kernel import transport_loop_plain
from tardis_tpu.atomic.synthetic import make_synthetic_atom_data
from tardis_tpu.transport.kernel import run_transport
from tardis_tpu.transport.solver import TransportSolver
from tardis_tpu.transport.source import (
    sample_blackbody_packets,
    sample_blackbody_packets_weighted,
)

from tests.test_torch_slice import CONFIG
from tests.test_torch_spawn_records import both_tables

torch.set_num_threads(2)

N = 1024
SEED = 7
HOT = 5.0
K = 16


def make_atom():
    return make_synthetic_atom_data().prepare(
        selected_atoms=[8, 12, 14, 16, 18, 20],
        line_interaction_type="macroatom")


@pytest.fixture(scope="module")
def runs():
    """Both loops with last-interaction rows and a K-event tracker (simple
    pool), and with a reflective boundary at albedo 0.5 on the weighted
    pool; the JAX package's result dicts come from its own solver."""
    tables, static, pt, state, _ = both_tables()
    atom = make_atom()
    base = jax.random.key(np.uint32(SEED))
    pool = sample_blackbody_packets(jax.random.fold_in(base, 0), N,
                                    HOT * state.t_inner)
    st = static._replace(track_last_interaction=True, track_rpacket_length=K)
    carry = run_transport(tables, st, *pool, jax.random.fold_in(base, 1),
                          n_packets=N, batch_size=256)
    solver = TransportSolver(track_last_interaction=True,
                             track_rpacket_length=K)
    jax_result = solver._finalize(carry, state, atom, N,
                                  need_line_estimators=False)
    wpool = sample_blackbody_packets_weighted(jax.random.fold_in(base, 2), N,
                                              HOT * state.t_inner)
    refl = run_transport(
        tables, static._replace(inner_boundary_albedo=0.5,
                                track_rpacket_length=K),
        *wpool[:2], jax.random.fold_in(base, 1), n_packets=N,
        batch_size=256, pool_w=wpool[2])
    run_key = rng.fold_in(rng.key(SEED), 1)
    mu, nu = (torch.as_tensor(np.array(a)) for a in pool)
    port = transport_loop_plain(pt, mu, nu, run_key, batch_size=256,
                                last_interaction=True, tracker_length=K)
    wmu, wnu, ww = (torch.as_tensor(np.array(a)) for a in wpool)
    pt.inner_boundary_albedo = 0.5
    port_refl = transport_loop_plain(pt, wmu, wnu, run_key, batch_size=256,
                                     pool_w=ww, tracker_length=K)
    pt.inner_boundary_albedo = 1.0
    port_wall = transport_loop_plain(pt, wmu, wnu, run_key, batch_size=256)
    pt.inner_boundary_albedo = 0.0
    port_absorb = transport_loop_plain(pt, wmu, wnu, run_key, batch_size=256,
                                       pool_w=ww)
    return dict(carry=carry, jax_result=jax_result, refl=refl, port=port,
                port_refl=port_refl, port_wall=port_wall,
                port_absorb=port_absorb)


def _agreeing(carry, out):
    nu_p = out[:, 0].numpy().astype(np.float64)
    st_p = np.where(nu_p > 0, 1, np.where(nu_p < 0, 2, 0))
    nu_j = np.asarray(carry.out_nu)
    match = st_p == np.asarray(carry.out_status)
    return match, match & (np.abs(np.abs(nu_p) - nu_j) <= 1e-3 * nu_j)


def test_last_interaction_rows_match_jax(runs):
    """On agreeing packets (>= 95%): type, in_line, out_line and shell
    equal, in_nu rtol 1e-6, r rtol 1e-5, and the zero row of a packet that
    never interacted in the same places."""
    carry, port = runs["carry"], runs["port"]
    _, agree = _agreeing(carry, port.out)
    assert agree.mean() >= 0.95, agree.mean()
    li_p = port.last_interaction.numpy()[agree]
    li_j = np.asarray(carry.li_packed)[agree]
    np.testing.assert_array_equal(li_p[:, :4], li_j[:, :4])
    np.testing.assert_allclose(li_p[:, 4], li_j[:, 4], rtol=1e-6)
    np.testing.assert_allclose(li_p[:, 5], li_j[:, 5], rtol=1e-5)
    none = li_p[:, 0] == 0
    assert none.any() and (li_p[none] == 0).all() and (li_j[none] == 0).all()
    line = li_p[:, 0] == 2
    assert line.any() and (li_p[:, 0] == 1).any()
    assert (li_p[line, 1] >= 0).all() and (li_p[line, 2] >= 0).all()
    assert (li_p[li_p[:, 0] == 1, 1:3] == -1).all()


def test_tracker_rows_match_jax(runs):
    """The first K = 16 events of each packet: every packet logged its first
    event, every logged row has r > 0 (as ``test_transport_kernel.py``
    checks for the JAX package), and on agreeing packets the rows match
    the JAX package's: shell and code equal, r / nu / energy rtol 1e-5,
    mu (a direction cosine, which after a move is a difference of nearly
    equal f32 numbers) atol 1e-5."""
    carry, port = runs["carry"], runs["port"]
    tr = port.tracker.numpy()
    assert tr.shape == (N, K, 6)
    code = tr[:, :, 4]
    assert (code[:, 0] != 0).all()
    assert (tr[:, :, 0][code != 0] > 0).all()
    assert set(np.unique(code)) <= {0.0, 1.0, 2.0, 3.0}
    _, agree = _agreeing(carry, port.out)
    tr_p = tr[agree]
    tr_j = np.asarray(carry.tr_packed).reshape(N, K, 6)[agree]
    np.testing.assert_array_equal(tr_p[:, :, [3, 4]], tr_j[:, :, [3, 4]])
    np.testing.assert_allclose(tr_p[:, :, :3], tr_j[:, :, :3], rtol=1e-5)
    np.testing.assert_allclose(tr_p[:, :, 5], tr_j[:, :, 5], rtol=0.0,
                               atol=1e-5)


def test_reflective_boundary(runs):
    """Albedo 1 reabsorbs no packet (``test_transport_kernel.py:253-259``);
    albedo 0.5 reabsorbs fewer than none does and agrees with the JAX
    package per packet (>= 95%, on the weighted pool, with the tracker)."""
    wall, absorb, refl = (runs[k].out[:, 0].numpy()
                          for k in ("port_wall", "port_absorb", "port_refl"))
    assert (wall > 0).all()
    assert 0 < (refl < 0).sum() < (absorb < 0).sum()
    match, agree = _agreeing(runs["refl"], runs["port_refl"].out)
    assert match.mean() >= 0.95 and agree.mean() >= 0.95, (
        match.mean(), agree.mean())
    e_p = runs["port_refl"].out[:, 1].numpy()
    e_j = np.asarray(runs["refl"].out_energy)
    np.testing.assert_allclose(e_p[agree], e_j[agree], rtol=1e-3)
    # a reflected packet's tracker row: code 3 in shell 0, moving outward
    tr = runs["port_refl"].tracker.numpy()
    bounced = (tr[:, :, 4] == 3) & (tr[:, :, 3] == 0) & (tr[:, :, 5] > 0)
    assert bounced.any()


def test_default_config_tracks_last_interaction(runs):
    """The slice configuration without a ``tracking`` section runs through
    ``run_tardis`` and returns a last-interaction row per packet of the
    final iteration, with the JAX package's keys and dtypes (the port
    refused this configuration before it tracked)."""
    cfg = copy.deepcopy(CONFIG)
    del cfg["montecarlo"]["tracking"]
    atom = atom_data_from_arrays(atom_data_to_arrays(make_atom()))
    sim = torch_run_tardis(cfg, atom_data=atom, device="cpu")
    res = sim.last_transport_result
    li = res.last_interaction
    ref = runs["jax_result"].last_interaction
    assert li is not None and li.keys() == ref.keys()
    for k in ref:
        assert li[k].dtype == ref[k].dtype, k
        assert li[k].shape == (cfg["montecarlo"]["last_no_of_packets"],)
    assert (li["type"] > 0).any() and set(np.unique(li["type"])) <= {0, 1, 2}
    assert res.rpacket_tracker is None


def test_rpacket_tracker_from_config(runs):
    """``tracking.track_rpacket`` keeps ``initial_array_length`` events a
    packet, returned with the JAX package's keys and dtypes."""
    cfg = copy.deepcopy(CONFIG)
    cfg["montecarlo"].update(iterations=1, last_no_of_packets=1024)
    cfg["montecarlo"]["tracking"] = {"track_rpacket": True,
                                     "initial_array_length": K}
    atom = atom_data_from_arrays(atom_data_to_arrays(make_atom()))
    tr = torch_run_tardis(cfg, atom_data=atom,
                          device="cpu").last_transport_result.rpacket_tracker
    ref = runs["jax_result"].rpacket_tracker
    assert tr.keys() == ref.keys()
    for k in ref:
        assert tr[k].dtype == ref[k].dtype and tr[k].shape == (1024, K), k
    assert (tr["type"][:, 0] > 0).all() and (tr["r"][tr["type"] > 0] > 0).all()
