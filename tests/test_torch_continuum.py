"""The port's continuum path against the JAX package on its IIP test problem
(``tests/test_continuum.py``'s ``iip_setup``: H / He, 10 levels, the H I
continua, 20 shells, full relativity; L = 135 lines, C = 10 continua, a
184-point merged grid, 32 Markov states): the merged bound-free grid, the
continuum plasma state, the Markov / deactivation / free-bound tables and
K1's continuum branch on its plain version.

Both packages take the same atom data (``atomic/convert.py``), the same
pools and run keys, so they draw the same threefry bits.  The JAX event
loop runs lockstep with ``batch_size=N``, so its ``max_steps`` is a
per-packet event cap, as the port's ``max_events`` is.
"""

import copy
from types import SimpleNamespace

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
from tardis_torch.plasma.continuum import ContinuumEstimators as TorchEstimators
from tardis_torch.plasma.continuum import ContinuumSolver as TorchContinuum
from tardis_torch.plasma.solver import PlasmaSolver as TorchPlasma
from tardis_torch.transport import rng
from tardis_torch.transport.kernel import transport_loop_plain
from tardis_torch.transport.solver import (
    reconstruct_continuum_estimators as torch_reconstruct,
)
from tardis_torch.transport.tables import build_continuum_grid as torch_grid
from tardis_torch.transport.tables import (
    build_continuum_tables,
    build_transport_tables as torch_tables,
)
from tardis_tpu.atomic.synthetic import make_synthetic_atom_data
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.model.state import SimulationState
from tardis_tpu.opacities.continuum_macro import solve_continuum_macro_state
from tardis_tpu.plasma.continuum import ContinuumEstimators, ContinuumSolver
from tardis_tpu.plasma.solver import PlasmaSolver
from tardis_tpu.transport.device_state import (
    build_continuum_grid,
    build_transport_tables,
)
from tardis_tpu.transport.kernel import run_transport
from tardis_tpu.transport.solver import reconstruct_continuum_estimators
from tardis_tpu.transport.source import sample_blackbody_packets_relativistic

from tests.test_plasma import BASE_CONFIG

torch.set_num_threads(2)

N = 256
CAP = 2000  # events a packet: ~5% of this problem's packets walk longer
SEED = 11
CONFIG = copy.deepcopy(BASE_CONFIG)
CONFIG["model"]["abundances"] = {"H": 0.8, "He": 0.2}
# the channels' boost of tests/test_continuum.py:238,327: A_2ph 1e12 / s
# makes two-photon decay dominate its state, the adiabatic rate at
# t_exp / 1e8 the k-packet's deactivation, so both fire in a short run
CHANNELS = dict(enable_two_photon=True, enable_adiabatic_cooling=True)


def _channel_kw(channels, state):
    if not channels:
        return {}
    return dict(CHANNELS, time_explosion=state.time_explosion / 1e8)


@pytest.fixture(scope="module")
def both():
    """One plasma solve of the IIP problem in each package."""
    state = SimulationState.from_config(config_from_dict(CONFIG))
    atom = make_synthetic_atom_data(
        atomic_numbers=(1, 2), max_ion_stage=2, n_levels=10,
        continuum_species=((1, 0),),
    ).prepare(line_interaction_type="macroatom")
    pls = PlasmaSolver(atom, state)
    ps = pls.update(state.t_radiative, state.dilution_factor)
    cs = ContinuumSolver(atom, pls)
    tatom = atom_data_from_arrays(atom_data_to_arrays(atom))
    tstate = TorchState.from_config(torch_config(CONFIG))
    tpl = TorchPlasma(tatom, tstate, "cpu")
    tps = tpl.update(tstate.t_radiative, tstate.dilution_factor)
    tcs = TorchContinuum(tatom, tpl)
    return dict(state=state, atom=atom, ps=ps, cs=cs, cont=cs.update(ps),
                tstate=tstate, tatom=tatom, tps=tps, tcs=tcs,
                tcont=tcs.update(tps))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300),
                        initial=0.0))


def test_atom_data_carries_continua(both):
    """The photoionization and two-photon tables cross ``convert``, and
    the port's generator builds the same ones."""
    from tardis_torch.atomic.synthetic import (
        make_synthetic_atom_data as torch_synthetic,
    )

    ref = make_synthetic_atom_data(atomic_numbers=(1, 2), max_ion_stage=2,
                                   n_levels=10, continuum_species=((1, 0),))
    own = torch_synthetic(atomic_numbers=(1, 2), max_ion_stage=2,
                          n_levels=10, continuum_species=((1, 0),))
    for a in (own, both["tatom"]):
        for table in ("photo_ion", "two_photon"):
            t_ref, t_port = getattr(ref, table), getattr(a, table)
            for field in vars(t_ref):
                np.testing.assert_array_equal(getattr(t_port, field),
                                              getattr(t_ref, field))
    sel = own.select_atoms([1])
    assert sel.photo_ion.n_continua == 10 and sel.two_photon.z.tolist() == [1]
    assert own.select_atoms([2]).photo_ion.n_continua == 0


def test_merged_grid_matches(both):
    grid, xs = build_continuum_grid(both["atom"].photo_ion)
    t_grid, t_xs = torch_grid(both["tatom"].photo_ion)
    np.testing.assert_array_equal(t_grid, grid)
    np.testing.assert_array_equal(t_xs, xs)
    assert grid.shape == (184,) and xs.shape == (184, 10)


@pytest.mark.parametrize("with_estimators", [False, True])
def test_continuum_state_matches(both, with_estimators):
    """Every ContinuumState field, the rate-equation n_e and the heating
    balance within 1e-10 relative (the same host f64 arithmetic), from the
    dilute-blackbody rates or from estimators."""
    S, C = both["state"].no_of_shells, both["atom"].photo_ion.n_continua
    est = test_est = None
    if with_estimators:
        gen = np.random.default_rng(3)
        arrays = {f: gen.uniform(0.5, 2.0, (C, S)) * scale for f, scale in (
            ("photo_ion", 1e-3), ("stim_recomb", 1e-5), ("bf_heating", 1e-14),
            ("stim_recomb_cooling", 1e-16), ("photo_ion_statistics", 1e3))}
        arrays["ff_heating"] = gen.uniform(0.5, 2.0, S) * 1e-8
        est, test_est = ContinuumEstimators(**arrays), TorchEstimators(**arrays)
    ref = both["cs"].update(both["ps"], est)
    port = both["tcs"].update(both["tps"], test_est)
    for field in vars(ref):
        assert _rel(getattr(port, field), getattr(ref, field)) <= 1e-10, field
    n_e = both["cs"].rate_equation_electron_density(both["ps"], ref)
    t_n_e = both["tcs"].rate_equation_electron_density(both["tps"], port)
    assert _rel(t_n_e, n_e) <= 1e-10
    if with_estimators:
        for adiabatic in (False, True):
            kw = dict(adiabatic_cooling=adiabatic,
                      time_explosion=both["state"].time_explosion)
            bal = both["cs"].heating_minus_cooling(both["ps"], ref, est, **kw)
            t_bal = both["tcs"].heating_minus_cooling(both["tps"], port,
                                                       test_est, **kw)
            for a, b in zip(t_bal, bal):
                assert _rel(a, b) <= 1e-10


def _tables(both, channels):
    """(JAX tables, static, port tables): the same plasma, continuum state
    and Markov macro atom, through each package's table functions."""
    atom, tatom = both["atom"], both["tatom"]
    if channels:
        atom, tatom = copy.deepcopy(atom), copy.deepcopy(tatom)
        atom.two_photon.A_ul[:] = 1e12
        tatom.two_photon.A_ul[:] = 1e12
    state, tstate = both["state"], both["tstate"]
    macro = solve_continuum_macro_state(atom, both["ps"], both["cont"],
                                        both["ps"].j_blues,
                                        **_channel_kw(channels, state))
    tmacro = torch_macro(tatom, both["tps"], both["tcont"],
                         both["tps"].j_blues, **_channel_kw(channels, tstate))
    tables, static = build_transport_tables(
        state.geometry, both["ps"], atom, "macroatom",
        enable_full_relativity=True, continuum_state=both["cont"],
        continuum_macro=macro)
    ct = build_continuum_tables(tstate.geometry, tatom, both["tcont"],
                                tmacro, "cpu")
    pt = torch_tables(tstate.geometry, both["tps"].electron_densities,
                      both["tps"].tau_prefix, tatom, "macroatom",
                      full_relativity=True, continuum=ct)
    return tables, static, pt


TABLE_PAIRS = (
    ("grid_nu", "cont_grid_nu"), ("xsect", "cont_xsect"),
    ("coef_a", "cont_A"), ("coef_b", "cont_B"),
    ("boltz_coef", "cont_boltz_coef"), ("ff_coef", "cont_ff_coef"),
    ("mk_cum_b", "mk_cum_B"), ("deact_block_start", "deact_block_start"),
    ("deact_cum_prob", "deact_cum_prob"), ("deact_kind", "deact_kind"),
    ("deact_id", "deact_id"), ("line2state", "line2state"),
    ("photo_ion_state", "photo_ion_state"), ("fb_cdf", "fb_cdf"),
    ("fb_nu", "fb_nu"), ("pion_block_start", "pion_block_start"),
)


@pytest.mark.parametrize("channels", [False, True])
def test_markov_tables_match(both, channels):
    """The continuum, Markov, deactivation and free-bound tables K1 reads
    are equal to the JAX package's after its f32 rounding, the two-photon
    inverse CDF too; the static sizes agree."""
    tables, static, pt = _tables(both, channels)
    ct = pt.continuum
    for ours, theirs in TABLE_PAIRS + (
            (("two_photon_nu", "two_photon_nu"),) if channels else ()):
        np.testing.assert_array_equal(
            getattr(ct, ours).numpy(), np.asarray(getattr(tables, theirs)),
            err_msg=ours)
    assert (ct.n_grid, ct.n_continua, ct.n_states, ct.k_state) == (
        static.n_cont_grid, static.n_continua, static.n_macro_states,
        static.k_state)
    assert (ct.two_photon, ct.adiabatic) == (
        static.enable_two_photon, static.enable_adiabatic_cooling) == (
        channels, channels)


@pytest.fixture(scope="module", params=["iip", "channels"])
def runs(request, both):
    """N packets of the relativistic pool through both event loops under a
    CAP-event cap, with last-interaction rows."""
    channels = request.param == "channels"
    tables, static, pt = _tables(both, channels)
    state = both["state"]
    base = jax.random.key(np.uint32(SEED))
    pool = sample_blackbody_packets_relativistic(
        jax.random.fold_in(base, 0), N, state.t_inner,
        float(tables.r_inner[0]))
    carry = run_transport(tables, static._replace(track_last_interaction=True),
                          *pool[:2], jax.random.fold_in(base, 1),
                          n_packets=N, batch_size=N, max_steps=CAP,
                          pool_w=pool[2])
    mu, nu, w = (torch.as_tensor(np.array(a)) for a in pool)
    res = transport_loop_plain(pt, mu, nu, rng.fold_in(rng.key(SEED), 1),
                               batch_size=N, max_events=CAP, pool_w=w,
                               last_interaction=True)
    return dict(carry=carry, res=res, channels=channels, pt=pt)


def _statuses(runs):
    out_j = np.asarray(runs["carry"].out_packed).reshape(-1, 2)
    out_p = runs["res"].out.numpy()
    return out_j, out_p, np.sign(out_j[:, 0]) == np.sign(out_p[:, 0])


def test_k1_continuum_per_packet(runs):
    """Status agreement >= 0.95; where the statuses agree, at least 0.95 of
    the packets end with nu and energy within 1e-5 relative (trajectories
    that part on an XLA ulp of sqrt / exp / log end elsewhere; none did on
    this problem); the packets still alive at the cap agree."""
    out_j, out_p, same = _statuses(runs)
    assert same.mean() >= 0.95, same.mean()
    close = same & np.all(np.abs(out_p - out_j)
                          <= 1e-5 * np.abs(out_j), axis=1)
    assert close.sum() >= 0.95 * same.sum(), (close.sum(), same.sum())
    stopped = out_p[:, 0] == 0
    assert stopped.sum() == runs["res"].summary[3].item() > 0
    assert (out_j[stopped, 0] == 0).mean() >= 0.95
    if runs["channels"]:
        # adiabatic deaths: reabsorbed status with zero energy, in both
        adiabatic = (out_p[:, 0] < 0) & (out_p[:, 1] == 0)
        assert adiabatic.sum() >= 1
        assert (out_j[adiabatic, 1] == 0).all()


def test_k1_continuum_estimators(runs, both):
    """Bulk j / nu-bar and free-free heating within 1e-3 relative (the JAX
    package accumulates two-float f32 pairs, the port f64).  The
    photoionization, stimulated-recombination and bound-free heating
    estimators rebuilt from each package's grid moments: per continuum
    (summed over shells) within 1e-3 relative, and every entry above 1e-3
    of the largest within 1e-2.  The packets the cap stops walk 2,000
    events each, ~85% of this run's events; an XLA ulp can move one such
    walk into a neighbouring shell or grid cell without changing any
    packet's output (such a walk moved 1% of a cell's events, 4e-3 of an
    entry, on this problem).  The reconstruction itself is exact: the
    port's, on the JAX package's moments, within 1e-12 of the JAX
    package's."""
    carry, res = runs["carry"], runs["res"]
    assert _rel(res.est_j.numpy(), carry.est_j_f64()) <= 1e-3
    assert _rel(res.est_nubar.numpy(), carry.est_nubar_f64()) <= 1e-3
    assert _rel(res.est_ff_heat.numpy(), carry.est_ff_heat_f64()) <= 1e-3
    dt = 1.0 / both["state"].luminosity_requested
    ref = reconstruct_continuum_estimators(carry, both["atom"], both["state"],
                                           N, dt)
    port = torch_reconstruct(res, both["tatom"], both["tstate"], N, dt)
    same_moments = torch_reconstruct(
        SimpleNamespace(cont_moments=torch.as_tensor(carry.cont_moments_f64()),
                        est_ff_heat=torch.as_tensor(carry.est_ff_heat_f64())),
        both["tatom"], both["tstate"], N, dt)
    for field in ("photo_ion", "stim_recomb", "bf_heating",
                  "stim_recomb_cooling", "photo_ion_statistics",
                  "ff_heating"):
        assert _rel(getattr(same_moments, field),
                    getattr(ref, field)) <= 1e-12, field
        a, b = getattr(port, field), getattr(ref, field)
        big = np.abs(b) > 1e-3 * np.abs(b).max()
        assert big.sum() >= 10 and _rel(a[big], b[big]) <= 1e-2, field
        if field != "ff_heating":
            assert _rel(a.sum(axis=-1), b.sum(axis=-1)) <= 1e-3, field


def test_k1_continuum_last_interaction(runs):
    """On packets that agree: type, lines and shell equal, in_nu and r
    within 3e-5 relative; continuum-process rows (type 3) in the same
    places, with line ids -1."""
    out_j, out_p, same = _statuses(runs)
    close = same & np.all(np.abs(out_p - out_j)
                          <= 1e-5 * np.abs(out_j), axis=1)
    li_p = runs["res"].last_interaction.numpy()
    li_j = np.asarray(runs["carry"].li_packed)
    np.testing.assert_array_equal(li_p[close, :4], li_j[close, :4])
    np.testing.assert_allclose(li_p[close, 4:], li_j[close, 4:], rtol=3e-5)
    cont = li_p[:, 0] == 3
    assert cont.sum() >= 5
    np.testing.assert_array_equal(cont[close], (li_j[:, 0] == 3)[close])
    assert (li_p[cont, 1:3] == -1).all()


def test_k1_continuum_lane_count_independent(both):
    """64 packets on 64 lanes and on 16 refilled lanes (with the tail
    packed) give the same packets, event counts and rows, bit for bit."""
    _, _, pt = _tables(both, True)
    gen = np.random.default_rng(5)
    mu = torch.as_tensor(gen.uniform(0.0, 1.0, 64).astype(np.float32))
    nu = torch.as_tensor(gen.uniform(0.5, 5.0, 64).astype(np.float32))
    key = rng.fold_in(rng.key(SEED), 3)
    kw = dict(max_events=300, last_interaction=True)
    a = transport_loop_plain(pt, mu, nu, key, batch_size=64, **kw)
    b = transport_loop_plain(pt, mu, nu, key, batch_size=16, **kw)
    assert torch.equal(a.out, b.out) and torch.equal(a.events, b.events)
    assert torch.equal(a.last_interaction, b.last_interaction)
    for name in ("est_j", "est_ff_heat", "cont_moments"):
        np.testing.assert_allclose(getattr(a, name).numpy(),
                                   getattr(b, name).numpy(), rtol=1e-12)
    assert a.summary[2] == b.summary[2] == a.events.sum()
