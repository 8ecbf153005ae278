"""The gamma-ray path (opacities, Klein-Nishina table, decay pools, K6's
plain version and TARDISHEWorkflow) against the JAX package on the CPU.

The port takes log, cos and the fractional powers in f64 rounded to f32
(K6 and its plain version agree bit for bit on the card that way); XLA's
f32 functions differ from those by an ulp or two, so single opacities
agree within 1e-6 and a packet's state within 1e-5 after a step of ~10
events.  The JAX package sums the deposition in f32 per lockstep
iteration, the port in f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tardis_torch.config.reader import config_from_dict as torch_config
from tardis_torch.energy_input import decay as tdecay
from tardis_torch.energy_input import gamma_kernel as tg
from tardis_torch.model.state import SimulationState as TorchState
from tardis_torch.transport import rng
from tardis_torch.workflows.high_energy import TARDISHEWorkflow as TorchHE
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.constants import DAY
from tardis_tpu.energy_input import decay as jdecay
from tardis_tpu.energy_input import gamma_kernel as jg
from tardis_tpu.model.state import SimulationState
from tardis_tpu.workflows.high_energy import TARDISHEWorkflow

from tests.test_plasma import BASE_CONFIG

torch.set_num_threads(2)

B, S, E = 5000, 20, 100
KEY_SEED, KEY_STEP = 9, 3
VARIANTS = {
    "default": {},
    "grey": dict(grey_opacity=0.05),
    "kasen+artis": dict(photoabsorption_type="kasen",
                        pair_creation_type="artis"),
    "estimators": dict(collect_estimators=True),
}


def energies():
    """20 keV - 4 MeV, both sides of the Thomson-series switch (25.5 keV)
    and the pair thresholds (1,022 and 1,500 keV)."""
    return np.concatenate([np.geomspace(20.0, 4000.0, 400),
                           [25.0, 26.0, 1021.0, 1023.0, 1499.0, 1500.0,
                            1501.0]]).astype(np.float32)


def shell_arrays():
    g = np.random.default_rng(1)
    n = energies().shape[0]
    rho = np.geomspace(1e-12, 5e-15, n).astype(np.float32)
    ne = (rho / 3.3e-24).astype(np.float32)
    iron = g.uniform(0.0, 1.0, n).astype(np.float32)
    z4 = (rho * 2e25).astype(np.float32)
    return rho, ne, iron, z4


OPACITIES = {
    "compton": lambda m, e, rho, ne, fe, z4: m.compton_opacity(e, ne),
    "photoabsorption": lambda m, e, rho, ne, fe, z4:
        m.photoabsorption_opacity(e, rho, fe),
    "photoabsorption_kasen": lambda m, e, rho, ne, fe, z4:
        m.photoabsorption_opacity_kasen(e, z4),
    "pair_creation": lambda m, e, rho, ne, fe, z4:
        m.pair_creation_opacity(e, rho, fe),
    "pair_creation_artis": lambda m, e, rho, ne, fe, z4:
        m.pair_creation_opacity_artis(e, rho, fe),
    "average_compton_fraction": lambda m, e, rho, ne, fe, z4:
        m.average_compton_fraction(e),
    "deposition_estimator_kasen": lambda m, e, rho, ne, fe, z4:
        m.deposition_estimator_kasen(e, ne, rho, fe),
}


def klein_nishina_f64(e_kev):
    """The Klein-Nishina cross-section over sigma_T in f64."""
    k = np.maximum(np.asarray(e_kev, np.float64) / tg.ELECTRON_REST_KEV, 1e-6)
    a = 1.0 + 2.0 * k
    full = 0.75 * ((1.0 + k) / k**3 * (2.0 * k * (1.0 + k) / a - np.log(a))
                   + np.log(a) / (2.0 * k) - (1.0 + 3.0 * k) / a**2)
    return np.where(k < 0.05, 1.0 - 2.0 * k + 5.2 * k * k, full)


# where the closed Klein-Nishina form loses ~4 digits in f32 to
# cancellation (k = E / 511 keV from the series switch 0.05 to ~0.4)
CANCELLATION_KEV = (0.05 * tg.ELECTRON_REST_KEV, 200.0)


@pytest.mark.parametrize("name", sorted(OPACITIES))
def test_opacity_matches_jax(name):
    """Each prescription and the mean Compton fraction within 1e-6
    relative of the JAX package's (f32 both).  In the Compton opacity's
    cancellation window (CANCELLATION_KEV) an ulp of log(1 + 2k) moves the
    f32 closed form by up to ~1e-4: there both packages stay within 5e-4 of
    the f64 cross-section and within 1e-4 of each other."""
    e = energies()
    arrays = shell_arrays()
    ours = OPACITIES[name](tg, torch.as_tensor(e),
                           *(torch.as_tensor(a) for a in arrays)).numpy()
    ref = np.asarray(OPACITIES[name](jg, jnp.asarray(e),
                                     *(jnp.asarray(a) for a in arrays)))
    assert ours.dtype == np.float32
    assert np.abs(ref).max() > 0
    atol = 1e-6 * np.abs(ref).max()
    if name == "compton":
        window = (e >= CANCELLATION_KEV[0]) & (e < CANCELLATION_KEV[1])
        assert 0 < window.sum() < e.size // 2
        exact = klein_nishina_f64(e[window]) * tg.SIGMA_THOMSON * (
            arrays[1][window].astype(np.float64))
        for got in (ours[window], ref[window]):
            np.testing.assert_allclose(got, exact, rtol=5e-4)
        np.testing.assert_allclose(ours[window], ref[window], rtol=1e-4)
        ours, ref = ours[~window], ref[~window]
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=atol)


def test_kn_table_and_lookup_match_jax():
    """The Klein-Nishina inverse-CDF table bitwise, and its bilinear lookup
    within 1e-6."""
    log_e, table = tg.build_kn_table()
    jlog_e, jtable = jg.build_kn_table()
    np.testing.assert_array_equal(log_e.numpy(), np.asarray(jlog_e))
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))
    g = np.random.default_rng(2)
    e = energies()
    u = g.uniform(0.0, 1.0, e.shape[0]).astype(np.float32)
    ours = tg.sample_kn_cos(log_e, table, torch.as_tensor(e),
                            torch.as_tensor(u)).numpy()
    ref = np.asarray(jg.sample_kn_cos(jlog_e, jtable, jnp.asarray(e),
                                      jnp.asarray(u)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


POOLS = {
    "ni56": (dict(Ni56=np.geomspace(1e52, 1e50, S)), 0.0),
    "positronium": (dict(Ni56=np.geomspace(1e52, 1e50, S)), 0.4),
    "two_families": (dict(Ni56=np.geomspace(1e52, 1e50, S),
                          Cr48=np.full(S, 3e50)), 0.0),
}


@pytest.mark.parametrize("name", sorted(POOLS))
def test_sample_gamma_packets_bitwise(name):
    """The decay pools are the JAX package's bit for bit (the same Philox
    draws), with the ortho-positronium continuum and across two decay
    families."""
    numbers, ps_frac = POOLS[name]
    kw = dict(seed=5, positronium_fraction=ps_frac)
    ours = tdecay.sample_gamma_packets(4000, numbers, 2 * DAY, 60 * DAY, **kw)
    ref = jdecay.sample_gamma_packets(4000, numbers, 2 * DAY, 60 * DAY, **kw)
    for field in ("shell", "radius_frac", "mu", "energy_kev", "time",
                  "packet_energy", "positron_energy", "time_bin_edges",
                  "member"):
        np.testing.assert_array_equal(getattr(ours, field),
                                      getattr(ref, field), err_msg=field)
    assert ours.total_energy == ref.total_energy
    assert ours.members == ref.members
    if ps_frac:
        assert (np.abs(ours.energy_kev - 511.0) > 1.0).sum() > 0


def step_inputs():
    """One time step's packets and shells (shells of 2e15 cm, densities of a
    few days after explosion, seven decay-line energies)."""
    g = np.random.default_rng(5)
    r_edges = np.linspace(1e15, 3e15, S + 1)
    r = g.uniform(r_edges[0], r_edges[-1], B)
    shell = np.clip(np.searchsorted(r_edges, r, side="right") - 1, 0, S - 1)
    return dict(
        r=r, mu=g.uniform(-1, 1, B),
        e=g.choice([158.38, 511.0, 846.77, 1238.29, 1771.35, 2598.46,
                    3253.42], B),
        w=np.ones(B), shell=shell.astype(np.int32),
        status=np.zeros(B, np.int32), budget=np.full(B, 3e15),
        r_inner=r_edges[:-1], r_outer=r_edges[1:],
        ne=np.geomspace(3e9, 1e8, S), rho=np.geomspace(1e-13, 5e-15, S),
        iron=np.full(S, 0.4), z4=np.geomspace(1e-13, 5e-15, S) * 2e25,
        ebins=np.logspace(1, np.log10(4000), E + 1))


def test_per_packet_draws_are_jax_bits():
    """K6 draws packet i's uniforms alone, at counter i of the step key
    folded with the packet's own event count and the column; the JAX
    package draws the whole lockstep array of one global iteration.  As a
    packet of status 0 steps on every iteration, the two are the same bits:
    any subset of counters equals the JAX array at those entries."""
    key = jax.random.fold_in(jax.random.key(np.uint32(KEY_SEED)), KEY_STEP)
    tkey = rng.fold_in(rng.key(KEY_SEED), KEY_STEP)
    idx = torch.tensor([0, 3, 17, 2500, B - 1])
    for event in (0, 1, 7):
        k = jax.random.fold_in(key, event)
        for col, lo in ((0, 1e-9), (1, 0.0), (2, 0.0), (3, 0.0)):
            ref = np.asarray(jax.random.uniform(
                jax.random.fold_in(k, col), (B,), dtype=jnp.float32,
                minval=lo, maxval=1.0))
            ours = rng.uniform(rng.random_bits(
                rng.fold_in(rng.fold_in(tkey, event), col), idx), lo, 1.0)
            np.testing.assert_array_equal(ours.numpy(), ref[idx.numpy()])


@pytest.fixture(scope="module")
def steps():
    """Both packages' step on identical inputs, in each variant."""
    x = step_inputs()
    f32 = np.float32
    kn = jg.build_kn_table()
    tkn = tg.build_kn_table()
    key = jax.random.fold_in(jax.random.key(np.uint32(KEY_SEED)), KEY_STEP)
    tkey = rng.fold_in(rng.key(KEY_SEED), KEY_STEP)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a)).to(dtype)

    out = {}
    for name, opts in VARIANTS.items():
        ref = jg.gamma_step_transport(
            *(jnp.asarray(x[k], f32) for k in ("r", "mu", "e", "w")),
            jnp.asarray(x["shell"]), jnp.asarray(x["status"]),
            jnp.asarray(x["budget"], f32), key,
            *(jnp.asarray(x[k], f32) for k in ("r_inner", "r_outer", "ne",
                                               "rho", "iron")),
            *kn, jnp.asarray(x["ebins"], f32), n_shells=S, n_ebins=E,
            kasen_z4=jnp.asarray(x["z4"], f32), **opts)
        ours = tg.gamma_step_transport(
            *(t(x[k]) for k in ("r", "mu", "e", "w")),
            t(x["shell"], torch.int32), t(x["status"], torch.int32),
            t(x["budget"]), tkey,
            *(t(x[k]) for k in ("r_inner", "r_outer", "ne", "rho", "iron")),
            *tkn, t(x["ebins"]), kasen_z4=t(x["z4"]), **opts)
        out[name] = (ref, ours)
    return out


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_plain_step_matches_jax(steps, name):
    """K6's plain version against gamma_step_transport: at least 0.99 of
    statuses equal; on those packets r, E and w within 1e-5 relative and
    mu within 1e-5; deposition, escape histogram and estimators within
    1e-4 of their totals."""
    ref, ours = steps[name]
    st = ours.status.numpy()
    same = st == np.asarray(ref[5])
    assert same.mean() >= 0.99, same.mean()
    assert (st != tg.STATUS_ACTIVE).all()
    for i, field in ((0, "r"), (2, "energy_kev"), (3, "weight")):
        np.testing.assert_allclose(getattr(ours, field).numpy()[same],
                                   np.asarray(ref[i])[same], rtol=1e-5,
                                   err_msg=field)
    np.testing.assert_allclose(ours.mu.numpy()[same],
                               np.asarray(ref[1])[same], rtol=0, atol=1e-5)
    sums = [(ours.deposition, ref[6]), (ours.escape_hist, ref[7])]
    if VARIANTS[name].get("collect_estimators"):
        sums += [(row, ref[8][k]) for row, k in zip(ours.estimators,
                                                   tg.ESTIMATORS)]
    else:
        assert ours.estimators.shape == (0, S)
    for a, b in sums:
        b = np.asarray(b, np.float64)
        assert np.abs(b).sum() > 0
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).sum()
    assert ours.events.max().item() >= 2


@pytest.fixture(scope="module")
def workflows():
    """Both packages' TARDISHEWorkflow at 5,000 packets over 8 steps
    (tests/test_gamma.py:64-67), with the path-length estimators."""
    run = dict(n_packets=5000, t_start=5 * DAY, t_end=40 * DAY,
               n_time_steps=8, collect_estimators=True)
    ref = TARDISHEWorkflow(
        SimulationState.from_config(config_from_dict(BASE_CONFIG)),
        ni56_mass_fraction=0.1, seed=1).run(**run)
    ours = TorchHE(TorchState.from_config(torch_config(BASE_CONFIG)),
                   ni56_mass_fraction=0.1, seed=1, device="cpu").run(**run)
    return ref, ours


def test_workflow_matches_jax(workflows):
    """Emitted, escaped and deposited totals within 1e-3, the (T, S)
    deposition and the escape spectrum within 1e-3 of their totals, and
    the estimators within 1e-3 of theirs."""
    ref, ours = workflows
    for name in ("total_emitted", "total_escaped", "total_deposited",
                 "total_positron_energy"):
        assert abs(getattr(ours, name) / getattr(ref, name) - 1) < 1e-3, name
    np.testing.assert_array_equal(ours.time_edges, ref.time_edges)
    np.testing.assert_array_equal(ours.positron_deposition,
                                  ref.positron_deposition)
    for a, b in ((ours.deposition, ref.deposition),
                 (ours.escape_spectrum, ref.escape_spectrum),
                 *((ours.estimators[k], ref.estimators[k])
                   for k in ref.estimators)):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-3 * np.abs(b).sum()
    accounted = ours.total_escaped + ours.total_deposited
    assert 0.3 < accounted / ours.total_emitted <= 1.02


def test_workflow_defaults_to_the_card(monkeypatch):
    """TARDISHEWorkflow asks for the card unless told otherwise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state = TorchState.from_config(torch_config(BASE_CONFIG))
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchHE(state, ni56_mass_fraction=0.1)
