"""Full relativity in the port against the JAX package: the relativistic and
weighted packet pools (K2), the event loop (K1) and the vpacket volley (K4)
on their plain versions, and the whole slice through ``run_tardis``.

Both packages get the same tables, pools and run keys, so they draw the
same threefry bits.  XLA's f32 sqrt, exp and expm1 are not correctly
rounded; the port's are (its exponentials are f64 rounded to f32), so the
pools agree to an ulp and the event loop parts ways on a few trajectories,
as the classic loop does (``test_torch_transport.py``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.simulation.base import run_tardis as torch_run_tardis
from tardis_torch.transport import rng
from tardis_torch.transport.kernel import transport_loop, transport_loop_plain
from tardis_torch.transport.source import blackbody_source
from tardis_torch.transport.vpacket import trace_vpacket_records
from tardis_tpu.constants import H, K_B
from tardis_tpu.simulation.base import run_tardis
from tardis_tpu.transport.device_state import NU_UNIT
from tardis_tpu.transport.kernel import run_transport
from tardis_tpu.transport.source import (
    sample_blackbody_packets_relativistic,
    sample_blackbody_packets_weighted,
)
from tardis_tpu.transport.vpacket import trace_vpacket_records as jax_trace

from tests.test_torch_final import FINAL_CONFIG
from tests.test_torch_spawn_records import both_tables

torch.set_num_threads(2)

N = 1024
SEED = 7
HOT = 5.0
POOL_N = 4096
POOL_CASES = [(23, 0, 10102.0, 0.0328), (23111963, 3, 9000.0, 0.05)]


def _keys(seed, iteration):
    jkey = jax.random.fold_in(jax.random.key(np.uint32(seed)), 2 * iteration)
    return jkey, rng.fold_in(rng.key(seed), 2 * iteration)


def _ulps(a, b):
    """Largest distance in f32 ulps between two arrays of one sign."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("seed,iteration,t_inner,beta", POOL_CASES)
def test_relativistic_pool_matches_jax(seed, iteration, t_inner, beta):
    """Same bits: mu within 2.4e-7 absolute (two ulps of XLA's f32 square
    root near 1; -beta + sqrt keeps the absolute error and cancels the
    value, so small mu differ by more ulps), nu rtol 1e-6, the constant
    weight rtol 1e-6."""
    jkey, key = _keys(seed, iteration)
    ref = [np.asarray(a) for a in sample_blackbody_packets_relativistic(
        jkey, POOL_N, t_inner, beta)]
    mu, nu, w = (a.numpy() for a in blackbody_source(
        key, POOL_N, t_inner, "cpu", "relativistic", beta_inner=beta))
    np.testing.assert_allclose(mu, ref[0], rtol=0.0, atol=2.4e-7)
    np.testing.assert_allclose(nu, ref[1], rtol=1e-6)
    np.testing.assert_allclose(w, ref[2], rtol=1e-6)
    assert (w == w[0]).all() and w[0] > 1.0
    assert (mu > -beta).all() and (mu <= 1.0).all()


@pytest.mark.parametrize("seed,iteration,t_inner,beta", POOL_CASES)
def test_weighted_pool_matches_jax(seed, iteration, t_inner, beta):
    """mu within an ulp, nu rtol 1e-6, w rtol 1e-5.  In the Wien tail
    (h nu / k T > 30, weights below 1e-7 of the largest) an ulp of XLA's
    f32 exp and expm1 moves w by up to ~3e-5, hence the atol of 1e-6 of
    the largest weight; the mean is f64 here, f32 there."""
    jkey, key = _keys(seed, iteration)
    ref = [np.asarray(a) for a in sample_blackbody_packets_weighted(
        jkey, POOL_N, t_inner)]
    mu, nu, w = (a.numpy() for a in blackbody_source(
        key, POOL_N, t_inner, "cpu", "weighted"))
    assert _ulps(mu, ref[0]) <= 1
    np.testing.assert_allclose(nu, ref[1], rtol=1e-6)
    np.testing.assert_allclose(w, ref[2], rtol=1e-5, atol=1e-6 * w.max())
    x = H * nu.astype(np.float64) * NU_UNIT / (K_B * t_inner)
    cool = x < 30.0
    np.testing.assert_allclose(w[cool], ref[2][cool], rtol=1e-5)
    assert abs(w.astype(np.float64).mean() - 1.0) < 1e-6


@pytest.fixture(scope="module", params=["scatter", "macroatom"])
def fr_runs(request):
    """A hot relativistic pool through both event loops under full
    relativity, with last-interaction rows."""
    tables, static, pt, state, _ = both_tables(request.param,
                                               full_relativity=True)
    assert static.enable_full_relativity and pt.full_relativity
    beta = float(pt.r_inner[0])
    base = jax.random.key(np.uint32(SEED))
    pool = sample_blackbody_packets_relativistic(
        jax.random.fold_in(base, 0), N, HOT * state.t_inner, beta)
    carry = run_transport(tables, static._replace(track_last_interaction=True),
                          *pool[:2], jax.random.fold_in(base, 1),
                          n_packets=N, batch_size=256, pool_w=pool[2])
    mu, nu, w = (torch.as_tensor(np.array(a)) for a in pool)
    run_key = rng.fold_in(rng.key(SEED), 1)
    kw = dict(pool_w=w, last_interaction=True)
    port = {256: transport_loop_plain(pt, mu, nu, run_key, batch_size=256,
                                      **kw),
            1024: transport_loop(pt, mu, nu, run_key, **kw)}
    return carry, port, pt


def _agreeing(carry, out):
    """Packets with the same status and lab nu within 1e-3 in both."""
    nu_p = out[:, 0].numpy().astype(np.float64)
    st_p = np.where(nu_p > 0, 1, np.where(nu_p < 0, 2, 0))
    st_j = np.asarray(carry.out_status)
    close = np.abs(np.abs(nu_p) - np.asarray(carry.out_nu)) <= (
        1e-3 * np.asarray(carry.out_nu))
    return st_p == st_j, (st_p == st_j) & close, st_p


def test_fr_per_packet_agreement(fr_runs):
    carry, port, _ = fr_runs
    match, agree, st_p = _agreeing(carry, port[256].out)
    assert (st_p != 0).all()  # every packet ends
    assert match.mean() >= 0.95, match.mean()
    assert agree.mean() >= 0.95, agree.mean()
    # the pool's weight reaches the packets' energies
    e_p = port[256].out[:, 1].numpy()
    e_j = np.asarray(carry.out_energy)
    np.testing.assert_allclose(e_p[agree], e_j[agree], rtol=1e-3)


def test_fr_estimators_agree(fr_runs):
    """Bulk estimators rtol 0.05; j_blue / e_dot totals within 5% (under
    full relativity the increments carry no nu_i factor)."""
    carry, port, pt = fr_runs
    res = port[256]
    np.testing.assert_allclose(res.est_j.numpy(), carry.est_j_f64(),
                               rtol=0.05)
    np.testing.assert_allclose(res.est_nubar.numpy(), carry.est_nubar_f64(),
                               rtol=0.05)
    S, L = pt.n_shells, pt.n_lines
    cum_p = np.cumsum(res.line_diff.numpy().reshape(L + 1, S, 2), axis=0)[:L]
    cum_j = np.cumsum(carry.line_diff_f64().reshape(L + 1, S, 2), axis=0)[:L]
    for k in (0, 1):
        assert cum_j[..., k].sum() > 0
        assert abs(cum_p[..., k].sum() - cum_j[..., k].sum()) <= (
            0.05 * abs(cum_j[..., k].sum()))


def test_fr_lane_count_independent(fr_runs):
    """256 lanes and one lane per packet give the same packets and the same
    last-interaction rows, bit for bit."""
    _, port, _ = fr_runs
    a, b = port[256], port[1024]
    assert torch.equal(a.out, b.out)
    assert torch.equal(a.last_interaction, b.last_interaction)
    for name in ("est_j", "est_nubar", "line_diff"):
        np.testing.assert_allclose(getattr(a, name).numpy(),
                                   getattr(b, name).numpy(), rtol=1e-12,
                                   atol=1e-12)
    assert not transport_loop.launches_by_variant  # CPU tensors never launch


def test_fr_last_interaction_rows(fr_runs):
    """On agreeing packets: type, in_line, out_line and shell equal, in_nu
    rtol 2e-6, r rtol 3e-5, and zero rows (no interaction) in the same
    places.  XLA takes the f32 square roots of the Lorentz factors and of
    the resonance quadratic's discriminant without correct rounding.
    in_nu, the lab frequency before the last interaction, carries an ulp
    of each earlier Doppler factor (one of 1,023 agreeing packets in
    scatter mode differs by 1.07e-6); r ends a move to a resonance whose
    length is (b - sqrt(disc)) / (a + b), where the difference cancels
    (two packets differ by up to 1.9e-5; the classic loop's r agrees
    within 1e-5, ``test_torch_tracking.py``)."""
    carry, port, _ = fr_runs
    _, agree, _ = _agreeing(carry, port[256].out)
    li_p = port[256].last_interaction.numpy()[agree]
    li_j = np.asarray(carry.li_packed)[agree]
    np.testing.assert_array_equal(li_p[:, :4], li_j[:, :4])
    np.testing.assert_allclose(li_p[:, 4], li_j[:, 4], rtol=2e-6)
    np.testing.assert_allclose(li_p[:, 5], li_j[:, 5], rtol=3e-5)
    none = li_p[:, 0] == 0
    assert (li_p[none] == 0).all() and (li_j[none] == 0).all()
    assert set(np.unique(li_p[:, 0])) <= {0.0, 1.0, 2.0}
    assert (li_p[:, 0] == 2).any() and (li_p[:, 0] == 1).any()


def test_fr_volley_matches_jax():
    """K4's full-relativity branch on identical records (as in
    ``test_torch_vpacket.py``): per bin above 1e-3 of the largest rtol 1e-4,
    total rtol 1e-5."""
    tables, static, pt, _, _ = both_tables("scatter", full_relativity=True)
    R, V, BINS = 200, 8, 40
    gen = np.random.default_rng(42)
    line_nu = pt.line_nu.numpy()
    r_inner, r_outer = pt.r_inner.numpy(), pt.r_outer.numpy()
    r = gen.uniform(r_inner[0], r_outer[-1] * 0.98, R).astype(np.float32)
    r[:20] = r_inner[0]
    mu = gen.uniform(-1.0, 1.0, R).astype(np.float32)
    nu_mid = float(line_nu[len(line_nu) // 2])
    nu = (nu_mid * gen.uniform(0.9, 1.3, R)).astype(np.float32)
    energy = gen.uniform(0.5, 1.5, R).astype(np.float32)
    energy[::17] = 0.0
    shell = np.searchsorted(r_outer, r).astype(np.int32)
    nu_cmf = nu * (np.float32(1.0) - mu * r)
    next_line = np.searchsorted(-line_nu, -nu_cmf).astype(np.int32)
    edges = np.linspace(nu_mid * 0.3, nu_mid * 2.0, BINS + 1,
                        dtype=np.float32)
    records = torch.as_tensor(np.stack(
        [r, mu, nu, energy, shell.astype(np.float32),
         next_line.astype(np.float32), np.ones(R, np.float32),
         -np.ones(R, np.float32)], axis=1))
    out = trace_vpacket_records(pt, records, V, torch.as_tensor(edges))
    ref = np.asarray(jax_trace(
        tables, static, *(jnp.asarray(a) for a in
                          (r, mu, nu, energy, shell, next_line)),
        n_vpackets=V, nu_bin_edges=jnp.asarray(edges), n_bins=BINS),
        np.float64)
    port = out.hist.numpy()
    big = ref > 1e-3 * ref.max()
    assert big.sum() >= 10
    np.testing.assert_allclose(port[big], ref[big], rtol=1e-4)
    np.testing.assert_allclose(port.sum(), ref.sum(), rtol=1e-5)
    # the branch changes the result: the classic volley differs by more
    pt.full_relativity = False
    classic = trace_vpacket_records(pt, records, V, torch.as_tensor(edges))
    assert abs(classic.hist.sum().item() / port.sum() - 1) > 1e-4


FR_CONFIG = copy.deepcopy(FINAL_CONFIG)
FR_CONFIG["montecarlo"]["enable_full_relativity"] = True
del FR_CONFIG["montecarlo"]["tracking"]  # last-interaction tracking: default


@pytest.fixture(scope="module")
def fr_sims(atom_data_prepared):
    ref = run_tardis(copy.deepcopy(FR_CONFIG), atom_data=atom_data_prepared)
    port = torch_run_tardis(
        copy.deepcopy(FR_CONFIG),
        atom_data=atom_data_from_arrays(atom_data_to_arrays(
            atom_data_prepared)),
        device="cpu")
    return ref, port


def test_fr_slice_history(fr_sims):
    ref, port = fr_sims
    assert port.transport.pool == "relativistic"
    assert len(port.history) == len(ref.history) == 2
    for h_p, h_r in zip(port.history, ref.history):
        assert abs(h_p.t_inner / h_r.t_inner - 1) < 0.01
        np.testing.assert_allclose(h_p.t_radiative, h_r.t_radiative,
                                   rtol=0.02)
        np.testing.assert_allclose(h_p.dilution_factor, h_r.dilution_factor,
                                   rtol=0.05)


def test_fr_slice_spectra(fr_sims):
    """Virtual and integrated luminosities within 2% of the JAX package's;
    the integrated / real ratio is held to the JAX package's own within 2%
    (full relativity moves it: see PERF.md)."""
    ref, port = fr_sims
    for name in ("spectrum_virtual", "spectrum_integrated"):
        s_p, s_r = getattr(port, name), getattr(ref, name)
        assert np.isfinite(s_p.luminosity_nu).all()
        assert abs(s_p.luminosity / s_r.luminosity - 1) < 0.02, name
    real_p = port.spectrum_real.luminosity
    real_r = ref.spectrum_real.luminosity
    assert abs(real_p / real_r - 1) < 0.02
    assert 0.85 < port.spectrum_virtual.luminosity / real_p < 1.18
    ratio_p = port.spectrum_integrated.luminosity / real_p
    ratio_r = ref.spectrum_integrated.luminosity / real_r
    assert abs(ratio_p / ratio_r - 1) < 0.02, (ratio_p, ratio_r)


def test_fr_slice_last_interaction(fr_sims):
    """Tracking is on by default: both packages return one row per packet
    of the final iteration, with the same keys and dtypes, and the same
    share of packets that interacted (within 2%)."""
    ref, port = fr_sims
    li_p = port.last_transport_result.last_interaction
    li_r = ref.last_transport_result.last_interaction
    assert li_p.keys() == li_r.keys()
    for k in li_r:
        assert li_p[k].dtype == li_r[k].dtype, k
        assert li_p[k].shape == li_r[k].shape == (port.last_no_of_packets,)
    share_p = (li_p["type"] > 0).mean()
    share_r = (li_r["type"] > 0).mean()
    assert share_p > 0 and abs(share_p / share_r - 1) < 0.02
    r = li_p["r"][li_p["type"] > 0]
    assert (r >= port.state.geometry.r_inner[0] * (1 - 1e-6)).all()
    assert (r <= port.state.geometry.r_outer[-1] * (1 + 1e-6)).all()
