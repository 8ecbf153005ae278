"""What K6's queue of moving packets relies on, held on K6's plain version
on the CPU: on a sparse pool the packets that do not move pass through
unchanged, and a moving packet's result depends only on its own index and
state, not on which other packets move beside it (K6 walks the movers in
whatever order its lanes take them, and the card's check holds it bitwise
against the plain version).  The same sparse pool goes through the JAX
package's gamma step too.  Also the gamma-ray workflow's per-step shell
tables, built for every step before the step loop, against the per-step
build they replace.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tardis_torch.config.reader import config_from_dict
from tardis_torch.constants import DAY, M_U
from tardis_torch.energy_input import gamma_kernel as tg
from tardis_torch.model.state import SimulationState
from tardis_torch.transport import rng
from tardis_torch.workflows.high_energy import step_shell_tables
from tardis_tpu.energy_input import gamma_kernel as jg

from tests.test_plasma import BASE_CONFIG

torch.set_num_threads(2)

B, S, E = 20_000, 20, 100
ACTIVE = 0.01
VARIANTS = {
    "default": {},
    "grey": dict(grey_opacity=0.05),
    "kasen+artis": dict(photoabsorption_type="kasen",
                        pair_creation_type="artis"),
    "estimators": dict(collect_estimators=True),
}
FIELDS = ("r", "mu", "energy_kev", "weight", "shell", "status")
KEY_SEED, KEY_STEP = 11, 4
LINES_KEV = [158.38, 511.0, 846.77, 1238.29, 1771.35, 2598.46, 3253.42]


def packets(seed, moving):
    """A pool of B packets in shells of 1e15-3e15 cm, those at ``moving``
    of status 0 and the others of status 1, 2 or 3 (escaped, absorbed,
    waiting), drawn from ``seed``."""
    g = np.random.default_rng(seed)
    r_edges = np.linspace(1e15, 3e15, S + 1)
    r = g.uniform(r_edges[0], r_edges[-1], B)
    shell = np.clip(np.searchsorted(r_edges, r, side="right") - 1, 0, S - 1)
    status = g.integers(1, 4, B).astype(np.int32)
    status[moving] = tg.STATUS_ACTIVE
    return dict(r=r, mu=g.uniform(-1, 1, B), e=g.choice(LINES_KEV, B),
                w=g.uniform(0.5, 1.5, B), shell=shell.astype(np.int32),
                status=status, budget=np.full(B, 3e15))


def shells():
    r_edges = np.linspace(1e15, 3e15, S + 1)
    rho = np.geomspace(1e-13, 5e-15, S)
    return dict(r_inner=r_edges[:-1], r_outer=r_edges[1:],
                ne=np.geomspace(3e9, 1e8, S), rho=rho, iron=np.full(S, 0.4),
                z4=rho * 2e25, ebins=np.logspace(1, np.log10(4000), E + 1))


def moving_set(seed, fraction=ACTIVE):
    """``fraction`` of the pool, scattered over it."""
    g = np.random.default_rng(seed)
    return np.sort(g.choice(B, int(fraction * B), replace=False))


def step(x, opts, fn=tg.gamma_step_transport):
    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a)).to(dtype)

    sh = shells()
    return fn(
        *(t(x[k]) for k in ("r", "mu", "e", "w")),
        t(x["shell"], torch.int32), t(x["status"], torch.int32),
        t(x["budget"]), rng.fold_in(rng.key(KEY_SEED), KEY_STEP),
        *(t(sh[k]) for k in ("r_inner", "r_outer", "ne", "rho", "iron")),
        *tg.build_kn_table(), t(sh["ebins"]), kasen_z4=t(sh["z4"]), **opts)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_packets_that_do_not_move_pass_through(name):
    """About 1% of the pool moves: every other packet comes out bitwise as
    it went in, with 0 events; every mover takes at least one event and
    ends its step (the budget is long enough for every fate)."""
    moving = moving_set(1)
    x = packets(2, moving)
    out = step(x, VARIANTS[name])
    still = np.ones(B, bool)
    still[moving] = False
    inputs = dict(r=x["r"].astype(np.float32),
                  mu=x["mu"].astype(np.float32),
                  energy_kev=x["e"].astype(np.float32),
                  weight=x["w"].astype(np.float32), shell=x["shell"],
                  status=x["status"])
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(out, f).numpy()[still],
                                      inputs[f][still], err_msg=f)
    events = out.events.numpy()
    assert (events[still] == 0).all()
    assert (events[moving] >= 1).all()
    assert (out.status.numpy()[moving] != tg.STATUS_ACTIVE).all()
    assert out.deposition.sum().item() > 0


def jax_step(x, opts, max_steps=tg.MAX_STEPS):
    """The JAX package's gamma step on the pool ``x`` (the same key)."""
    f32 = np.float32
    sh = shells()
    return jg.gamma_step_transport(
        *(jnp.asarray(x[k], f32) for k in ("r", "mu", "e", "w")),
        jnp.asarray(x["shell"]), jnp.asarray(x["status"]),
        jnp.asarray(x["budget"], f32),
        jax.random.fold_in(jax.random.key(np.uint32(KEY_SEED)), KEY_STEP),
        *(jnp.asarray(sh[k], f32) for k in ("r_inner", "r_outer", "ne",
                                            "rho", "iron")),
        *jg.build_kn_table(), jnp.asarray(sh["ebins"], f32), n_shells=S,
        n_ebins=E, max_steps=max_steps, kasen_z4=jnp.asarray(sh["z4"], f32),
        **opts)


@pytest.mark.parametrize("name", ["default", "estimators"])
def test_sparse_pool_matches_jax(name):
    """The ~1%-active pool through the JAX package's gamma step and the
    port's: the packets that do not move come out of both bitwise as they
    went in (the port's with 0 events); every mover ends with the JAX
    package's status, and r, E and w within 1e-5 relative and mu within
    1e-5 of it (the parity bars of tests/test_torch_gamma.py); deposition,
    escape histogram and estimators within 1e-4 of their totals.  The JAX
    package returns no event counts: stopped one iteration before the
    port's longest mover ends, exactly the movers with the port's largest
    count are still in flight there, and every other mover has its
    status."""
    moving = moving_set(1)
    x = packets(2, moving)
    ours, ref = step(x, VARIANTS[name]), jax_step(x, VARIANTS[name])
    still = np.ones(B, bool)
    still[moving] = False
    inputs = dict(r=x["r"].astype(np.float32),
                  mu=x["mu"].astype(np.float32),
                  energy_kev=x["e"].astype(np.float32),
                  weight=x["w"].astype(np.float32), shell=x["shell"],
                  status=x["status"])
    for i, f in enumerate(FIELDS):
        np.testing.assert_array_equal(np.asarray(ref[i])[still],
                                      inputs[f][still], err_msg=f)
        np.testing.assert_array_equal(getattr(ours, f).numpy()[still],
                                      inputs[f][still], err_msg=f)
    events = ours.events.numpy()
    assert (events[still] == 0).all()
    status = ours.status.numpy()
    np.testing.assert_array_equal(status, np.asarray(ref[5]))
    for i, f in ((0, "r"), (2, "energy_kev"), (3, "weight")):
        np.testing.assert_allclose(getattr(ours, f).numpy()[moving],
                                   np.asarray(ref[i])[moving], rtol=1e-5,
                                   err_msg=f)
    np.testing.assert_allclose(ours.mu.numpy()[moving],
                               np.asarray(ref[1])[moving], rtol=0, atol=1e-5)
    sums = [(ours.deposition, ref[6]), (ours.escape_hist, ref[7])]
    if VARIANTS[name].get("collect_estimators"):
        sums += [(row, ref[8][k]) for row, k in zip(ours.estimators,
                                                   tg.ESTIMATORS)]
    for a, b in sums:
        b = np.asarray(b, np.float64)
        assert np.abs(b).sum() > 0
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).sum()
    longest = events.max()
    short = np.asarray(jax_step(x, VARIANTS[name], int(longest) - 1)[5])
    np.testing.assert_array_equal(short == tg.STATUS_ACTIVE,
                                  events == longest)
    np.testing.assert_array_equal(short[events < longest],
                                  status[events < longest])


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_mover_depends_only_on_its_index_and_state(name):
    """The same movers at the same indices, in two pools whose other
    packets differ in state and status (the second moves another 2% of the
    pool beside them): each mover ends bitwise the same, with the same
    event count."""
    moving = moving_set(3)
    a = packets(4, moving)
    extra = np.setdiff1d(moving_set(5, 0.02), moving)
    b = packets(6, np.concatenate([moving, extra]))
    for k in ("r", "mu", "e", "w", "shell", "budget"):
        b[k][moving] = a[k][moving]
    out_a, out_b = step(a, VARIANTS[name]), step(b, VARIANTS[name])
    for f in FIELDS + ("events",):
        np.testing.assert_array_equal(getattr(out_a, f).numpy()[moving],
                                      getattr(out_b, f).numpy()[moving],
                                      err_msg=f)
    assert (out_b.events.numpy()[extra] >= 1).all()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_plain_tally_counts_energy_changes(name):
    """The plain version's tally of energy changes (Compton scatters and
    pair creations), which the card's check charges the estimators'
    quadrature for, leaves the step bitwise as it was; it counts at least
    one change for every mover whose energy changed and at most one an
    event, and none in the grey mode (no Compton, no pair creation)."""
    moving = moving_set(1)
    x = packets(2, moving)
    tally = {}
    plain = step(x, VARIANTS[name])
    counted = step(x, dict(VARIANTS[name], tally=tally),
                   tg.gamma_step_transport_plain)
    for f in FIELDS + ("events", "deposition", "escape_hist", "estimators"):
        assert torch.equal(getattr(plain, f), getattr(counted, f)), f
    changes = tally["energy_changes"].item()
    changed = int((counted.energy_kev.numpy()
                   != x["e"].astype(np.float32)).sum())
    if VARIANTS[name].get("grey_opacity", -1.0) >= 0.0:
        assert changes == 0 and changed == 0
    else:
        assert 0 < changed <= changes <= counted.events.sum().item()


@pytest.mark.parametrize("n_steps", [8, 50])
def test_step_shell_tables_match_the_per_step_build(n_steps):
    """The shell tables of every step, built before the step loop, equal bit
    for bit those the loop built at each step before (f64 on the host,
    rounded to f32 on the device)."""
    state = SimulationState.from_config(config_from_dict(BASE_CONFIG))
    g = np.random.default_rng(7)
    S_state = state.no_of_shells
    z_over_a = g.uniform(0.4, 0.5, S_state)
    z4_over_a = g.uniform(10.0, 300.0, S_state)
    time_edges = np.logspace(np.log10(2 * DAY), np.log10(100 * DAY),
                             n_steps + 1)
    v_inner, v_outer = state.geometry.v_inner, state.geometry.v_outer
    rho = state.composition.density
    base_ne = rho * z_over_a / M_U
    base_z4 = rho * z4_over_a / M_U
    tables = step_shell_tables(time_edges, state.time_explosion, v_inner,
                               v_outer, base_ne, rho, base_z4, "cpu")

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(torch.float32)

    for ts in range(n_steps):
        t0, t1 = time_edges[ts], time_edges[ts + 1]
        t_mid = np.sqrt(t0 * t1)
        scale = (t_mid / state.time_explosion) ** -3
        want = dict(r_inner=f32(v_inner * t_mid), r_outer=f32(v_outer * t_mid),
                    electron_density=f32(base_ne * scale),
                    density=f32(rho * scale), kasen_z4=f32(base_z4 * scale))
        for name, row in want.items():
            got = tables[name][ts]
            assert got.is_contiguous() and got.dtype == torch.float32
            assert torch.equal(got, row), (name, ts)
