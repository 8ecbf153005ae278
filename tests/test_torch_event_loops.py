"""The event loops' line-estimator switch, K1's search and the continuum
check's bound.

K1 (``transport_loop``: classic, full relativity, the options set) and K7
(``nonhom_transport_loop``: scatter, macroatom) take ``line_estimators``;
off, they neither allocate nor write the line difference array and every
other output is bitwise the run with it on.  Here on their plain versions
(the CPU path): against themselves, against the JAX package's event loops
(whose readback skips the array under ``need_line_estimators=False``) at
the parity bars of ``tests/test_torch_transport.py`` and
``tests/test_torch_nonhomologous.py`` (K7 on seeds of its own), over 2
and 4 CPU shards, and through the solvers, which pass
``need_line_estimators`` on.  K1's card search (a gallop from next_line)
against its plain version's bisection.  Then the summation bound that
``chip_smoke.py`` holds the continuum K1's racing moment and free-free
sums to, and the lane efficiency it prints.
"""

import copy
import dataclasses
import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.parallel.transport import run_transport_sharded
from tardis_torch.simulation.base import run_tardis as torch_run_tardis
from tardis_torch.transport import kernel as tk
from tardis_torch.transport import nonhomologous as tnh
from tardis_torch.transport import rng
from tardis_torch.transport import solver as solver_module
from tardis_torch.transport.tables import (
    GAMMA_FLOOR,
    LINE_SCATTER,
    TransportTables,
    lorentz_gamma,
)
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.model.geometry import NonhomologousRadial1DGeometry
from tardis_tpu.model.state import SimulationState
from tardis_tpu.opacities.macro_atom_solver import solve_macro_state
from tardis_tpu.plasma.solver import PlasmaSolver
from tardis_tpu.transport.kernel import run_transport
from tardis_tpu.transport.nonhomologous import (
    _nonhom_pred_search,
    build_nonhom_tables,
    nonhomologous_plasma_state,
    run_nonhom_transport,
)
from tardis_tpu.transport.source import (
    sample_blackbody_packets,
    sample_blackbody_packets_relativistic,
)

from tests.test_plasma import BASE_CONFIG
from tests.test_torch_nonhomologous import N as NH_N
from tests.test_torch_nonhomologous import SEED as NH_SEED
from tests.test_torch_nonhomologous import mixed_gradient_kw, port_plasma
from tests.test_torch_slice import CONFIG
from tests.test_torch_spawn_records import both_tables

torch.set_num_threads(2)

N = 2048
SEED = 29
HOT = 5.0
# K1's instantiations held here: (name, full relativity, options set)
K1_CASES = [("classic", False, False), ("full_relativity", True, False),
            ("options", False, True)]
OUTPUTS = ("out", "est_j", "est_nubar", "summary", "last_interaction",
           "tracker", "vp_count", "events")


@pytest.fixture(scope="module", params=["scatter", "macroatom"])
def k1(request):
    """Both packages' tables of one host-mode plasma solve (classic and
    full relativity), a hot pool of N packets of each kind and the JAX
    event loop's runs on them."""
    mode = request.param
    base = jax.random.key(np.uint32(SEED))
    run_key = rng.fold_in(rng.key(SEED), 1)
    out = {"mode": mode, "key": run_key}
    for name, full_rel, _ in K1_CASES[:2]:
        tables, static, pt, state, _ = both_tables(mode, full_relativity=full_rel)
        if full_rel:
            pool = sample_blackbody_packets_relativistic(
                jax.random.fold_in(base, 0), N, HOT * state.t_inner,
                float(pt.r_inner[0]))
        else:
            pool = (*sample_blackbody_packets(jax.random.fold_in(base, 0), N,
                                              HOT * state.t_inner), None)
        carry = run_transport(
            tables, static._replace(track_last_interaction=full_rel),
            *pool[:2], jax.random.fold_in(base, 1), n_packets=N,
            batch_size=256, **({"pool_w": pool[2]} if full_rel else {}))
        out[name] = dict(pt=pt, carry=carry, pool=tuple(
            None if a is None else torch.as_tensor(np.array(a)) for a in pool))
    # the options set: the classic tables with a reflective core, a weighted
    # pool and the r-packet tracker
    pt = copy.copy(out["classic"]["pt"])
    pt.inner_boundary_albedo = 0.5
    mu, nu, _ = out["classic"]["pool"]
    w = torch.as_tensor(np.random.default_rng(SEED).uniform(
        0.5, 1.5, N).astype(np.float32))
    out["options"] = dict(pt=pt, pool=(mu, nu, w))
    return out


def k1_kw(name):
    return {"classic": {},
            "full_relativity": dict(last_interaction=True),
            "options": dict(tracker_length=6, vpacket_capacity=4 * N)}[name]


@pytest.mark.parametrize("name", [c[0] for c in K1_CASES])
def test_k1_without_line_estimators_is_bitwise(k1, name):
    """The plain K1 without line estimators: no line difference array, and
    every packet's row, the bulk estimators, the summary, the trackers and
    the spawn-record count bitwise the run with them."""
    case = k1[name]
    mu, nu, w = case["pool"]
    kw = dict(pool_w=w, batch_size=256, **k1_kw(name))
    on = tk.transport_loop_plain(case["pt"], mu, nu, k1["key"], **kw)
    off = tk.transport_loop_plain(case["pt"], mu, nu, k1["key"],
                                  line_estimators=False, **kw)
    S, L = case["pt"].n_shells, case["pt"].n_lines
    assert on.line_diff.numel() == 2 * (L + 1) * S
    assert off.line_diff.numel() == 0
    assert on.line_diff.abs().sum() > 0
    for field in OUTPUTS:
        assert torch.equal(getattr(off, field), getattr(on, field)), field
    n_rec = on.n_vp_records
    assert torch.equal(off.vp_records[:n_rec], on.vp_records[:n_rec])
    # the plain version's per-packet counts add up to the event total
    assert off.events.shape == (N,)
    assert int(off.events.sum()) == int(off.summary[2])
    # the CPU wrapper takes the plain version with the flag
    wrapped = tk.transport_loop(case["pt"], mu, nu, k1["key"],
                                line_estimators=False,
                                **{k: v for k, v in kw.items()
                                   if k != "batch_size"})
    assert torch.equal(wrapped.out, off.out)
    assert wrapped.line_diff.numel() == 0
    assert not tk.transport_loop.launches_by_variant


@pytest.mark.parametrize("name", [c[0] for c in K1_CASES[:2]])
def test_k1_without_line_estimators_matches_jax(k1, name):
    """The plain K1 without line estimators against the JAX event loop on
    the same tables, pool and key: statuses agree on >= 0.95 of packets,
    nu within 1e-3 on >= 0.95, the bulk estimators within 5%."""
    case = k1[name]
    mu, nu, w = case["pool"]
    carry = case["carry"]
    res = tk.transport_loop_plain(case["pt"], mu, nu, k1["key"], pool_w=w,
                                  batch_size=256, line_estimators=False,
                                  **k1_kw(name))
    nu_p = res.out[:, 0].numpy().astype(np.float64)
    st_p = np.where(nu_p > 0, 1, np.where(nu_p < 0, 2, 0))
    st_j = np.asarray(carry.out_status)
    nu_j = np.asarray(carry.out_nu, np.float64)
    match = st_p == st_j
    close = np.abs(np.abs(nu_p) - nu_j) <= 1e-3 * nu_j
    assert (st_p != 0).all()
    assert match.mean() >= 0.95, match.mean()
    assert (match & close).mean() >= 0.95, (match & close).mean()
    np.testing.assert_allclose(res.est_j.numpy(), carry.est_j_f64(),
                               rtol=0.05)
    np.testing.assert_allclose(res.est_nubar.numpy(), carry.est_nubar_f64(),
                               rtol=0.05)
    assert res.line_diff.numel() == 0


def _search_states(k1, name, M=4096):
    """M event states (shell, r, mu, nu, tau_event, boundary distance)
    drawn across the grid of ``k1[name]``'s tables, as K1 searches them:
    (tables, shell, next_line, the search's arguments after ``lo``)."""
    t = k1[name]["pt"]
    full_rel = name == "full_relativity"
    S, L = t.n_shells, t.n_lines
    g = np.random.default_rng(SEED)
    shell = torch.as_tensor(g.integers(0, S, M))
    f = torch.as_tensor(g.uniform(0.0, 1.0, M).astype(np.float32))
    r = t.r_inner[shell] + f * (t.r_outer[shell] - t.r_inner[shell])
    mu = torch.as_tensor(g.uniform(-1.0, 1.0, M).astype(np.float32))
    nu = k1[name]["pool"][1][torch.as_tensor(g.integers(0, N, M))]
    u = torch.as_tensor(g.uniform(1e-9, 1.0, M).astype(np.float32))
    tau_event = (-torch.log(u.double())).float()
    z = mu * r
    # boundary distances up to most of the comoving band below the packet,
    # so that some searches run far down the list
    d_b = torch.as_tensor(g.uniform(0.0, 0.9, M).astype(np.float32)) \
        * (1.0 - z)
    chi = t.chi_e[shell]
    if full_rel:
        dop = (1.0 - z) * lorentz_gamma(r)
        chi = chi * dop
        p2 = torch.clamp((r * r) * (1.0 - mu * mu), min=0.0)
        rb2 = (r * r + d_b * d_b) + ((2.0 * r) * d_b) * mu
        nu_thresh = (nu * (1.0 - (z + d_b))) / torch.sqrt(
            torch.clamp(1.0 - rb2, min=GAMMA_FLOOR))
    else:
        dop, p2 = 1.0 - z, None
        nu_thresh = nu * (1.0 - (z + d_b))
    next_line = (t.line_nu[None, :] >= (nu * dop)[:, None]).sum(1)
    c0 = t.prefix.reshape(-1)[shell * (L + 1) + next_line]
    return t, shell, next_line, (chi, z, nu, tau_event, nu_thresh, c0, p2)


@pytest.mark.parametrize("name", ["classic", "full_relativity"])
def test_k1_gallop_finds_the_bisection_index(k1, name):
    """K1's card search gallops from next_line; the plain version bisects
    [next_line, L].  The two find the same line wherever the event
    predicate is monotone in the line index: without full relativity it
    is, in f32, on a non-decreasing prefix row; under full relativity (the
    resonance quadratic's root in f32) it is not proven so, and the card
    checks the gallop's index with a margin guard (``_gallop_guarded``, the
    kernel's search in torch ops), which must give the bisection's index
    and leave nearly every search it covers to the gallop.  Held over
    4,096 event states (shell, r, mu, nu, tau_event, boundary distance)
    drawn across the grid, every line from next_line on tested for
    monotonicity."""
    t, shell, next_line, args = _search_states(k1, name)
    M, L = shell.shape[0], t.n_lines
    nu_thresh = args[4]
    i = torch.arange(L)[None, :].expand(M, L)
    col = lambda a: None if a is None else a[:, None].expand(M, L)  # noqa: E731
    fire = tk._fires(t, col(shell), i, *(col(a) for a in args))
    fire = fire & (i >= next_line[:, None])
    assert bool((fire[:, 1:] >= fire[:, :-1]).all())
    assert bool((t.prefix[:, 1:] >= t.prefix[:, :-1]).all())
    bisect = tk._search(t, shell, next_line.clone(), *args)
    assert torch.equal(tk._gallop(t, shell, next_line.clone(), *args),
                       bisect)
    if name == "full_relativity":
        guarded, fell_back = tk._gallop_guarded(t, shell, next_line.clone(),
                                                *args)
        assert torch.equal(guarded, bisect)
        # the guard's bound holds where the boundary's frequency is at least
        # half the packet's (every search of a real shell grid); these
        # states also reach far below, where it falls back
        nu, p2 = args[2], args[6]
        covered = (2.0 * nu_thresh >= nu) & (p2 <= 0.1)
        assert int(covered.sum()) > M // 2
        assert bool(fell_back[~covered].all())
        assert int((fell_back & covered).sum()) <= M // 100, int(
            (fell_back & covered).sum())
    # the states end at lines (tau reached) and at boundaries, some far on
    found = (bisect < L) & (t.line_nu[torch.clamp(bisect, max=L - 1)]
                            > nu_thresh)
    assert 0 < int(found.sum()) < M
    assert int((bisect - next_line).max()) > 16


# an f32 dip of the full-relativity resonance distance: consecutive f32
# line frequencies nu_i > nu_{i+1} with s(nu_{i+1}) < s(nu_i)
DIP_TRIALS = 256
DIP_SPAN = 1 << 16


def _f32(x):
    return torch.tensor([x], dtype=torch.float32)


def _dips(n_wanted):
    """Packet states (nu, z, p2) and line triples (a line 4,096 f32 steps
    above the dip, then the dip's two lines), found by scanning DIP_SPAN
    consecutive f32 frequencies below each drawn state's comoving
    frequency with the plain version's ``_resonance_distance``."""
    g = np.random.default_rng(SEED)
    found = []
    for _ in range(DIP_TRIALS):
        nu = np.float32(g.uniform(0.3, 3.0))
        r = np.float32(g.uniform(0.02, 0.1))
        mu = np.float32(g.uniform(-1.0, 1.0))
        z = _f32(mu) * _f32(r)
        p2 = torch.clamp((_f32(r) * _f32(r)) * (1.0 - _f32(mu) * _f32(mu)),
                         min=0.0)
        top = np.float32(nu * (1.0 - float(z)) * g.uniform(0.8, 1.0))
        steps = np.arange(DIP_SPAN + 4096, dtype=np.int32)
        lines = torch.as_tensor((np.int32(top.view(np.int32)) - steps).view(
            np.float32))
        s = tk._resonance_distance(lines, _f32(nu), z, p2, True)
        dip = torch.nonzero(s[4097:] < s[4096:-1])
        if dip.numel():
            i = 4096 + int(dip[0])
            found.append((_f32(nu), z, p2, lines[[i - 4096, i, i + 1]]))
        if len(found) == n_wanted:
            break
    return found


def test_k1_guard_on_an_f32_dip():
    """Under full relativity the f32 root of the resonance quadratic dips:
    a line one f32 step below another can lie an ulp nearer.  On hand-made
    tables (one shell, chi 1, four lines: one well above the dip, the
    dip's pair with no optical depth, then a thick line) with tau_event
    at the dip's lower distance, the predicate fires on the pair's first
    line and not its second: K1's unguarded gallop stops at the first, the
    plain version's bisection of [0, L] at the thick line.  The margin
    guard must send each such search to the bisection."""
    dips = _dips(8)
    assert len(dips) == 8
    for nu, z, p2, lines in dips:
        lines = torch.cat([lines, lines[2:] * 0.9])
        t = TransportTables(
            r_inner=_f32(0.01), r_outer=_f32(0.2), chi_e=_f32(1.0),
            line_nu=lines,
            prefix=torch.tensor([[0.0, 0.0, 0.0, 0.0, 100.0]],
                                dtype=torch.float64),
            line2macro=torch.zeros(4, dtype=torch.int32),
            chain_cdf=torch.zeros(1, 1), emit_cdf=torch.zeros(1, 3),
            mode=LINE_SCATTER, full_relativity=True)
        s = tk._resonance_distance(lines, nu, z, p2, True)
        assert s[0] < s[2] < s[1]
        args = (_f32(1.0), z, nu, s[2:3].clone(), lines[3:] * 0.5,
                torch.zeros(1, dtype=torch.float64), p2)
        shell, lo = torch.zeros(1, dtype=torch.int64), torch.zeros(
            1, dtype=torch.int64)
        bisect = tk._search(t, shell, lo.clone(), *args)
        assert int(bisect) == 3
        assert int(tk._gallop(t, shell, lo.clone(), *args)) == 1
        guarded, fell_back = tk._gallop_guarded(t, shell, lo.clone(), *args)
        assert bool(fell_back) and torch.equal(guarded, bisect)


def test_k1_guard_falls_back_near_ties(k1):
    """The margin guard on near ties: each of the 4,096 states of
    ``test_k1_gallop_finds_the_bisection_index`` that ends at a line
    (full relativity) gets tau_event one f32 step below that line's optical
    depth, so the predicate still fires there, within the guard's margin:
    every such search must fall back to the bisection, and find it."""
    t, shell, next_line, args = _search_states(k1, "full_relativity")
    L = t.n_lines
    chi, z, nu, tau_event, nu_thresh, c0, p2 = args
    k = tk._search(t, shell, next_line.clone(), *args)
    kk = torch.clamp(k, max=L - 1)
    at_line = (k < L) & (t.line_nu[kk] > nu_thresh)
    g = tk._depth(t, shell, kk, chi, z, nu, c0, p2)
    tie = torch.nextafter(g, torch.full_like(g, -math.inf))
    # states the guard's bound covers (else it falls back whatever tau is)
    keep = at_line & (tie > 0) & (2.0 * nu_thresh >= nu) & (p2 <= 0.1)
    assert int(keep.sum()) > 100
    sel = lambda a: a[keep]  # noqa: E731
    args = tuple(sel(a) for a in (chi, z, nu)) + (sel(tie),) + tuple(
        sel(a) for a in (nu_thresh, c0, p2))
    start = next_line[keep]
    bisect = tk._search(t, shell[keep], start.clone(), *args)
    assert torch.equal(bisect, k[keep])
    guarded, fell_back = tk._gallop_guarded(t, shell[keep], start.clone(),
                                            *args)
    assert bool(fell_back.all())
    assert torch.equal(guarded, bisect)


def k7_problem():
    """``tests/test_torch_nonhomologous.py``'s problem (the mixed-gradient
    law, blueshifting shells) in both packages and both modes, and a pool
    of its NH_N packets under its seed."""
    from tardis_torch.model.geometry import (
        NonhomologousRadial1DGeometry as TorchNonhomGeometry,
    )
    from tardis_torch.opacities.macro_atom_solver import (
        solve_macro_state as torch_macro_state,
    )
    from tardis_tpu.atomic.synthetic import make_synthetic_atom_data

    atom = make_synthetic_atom_data().prepare(
        selected_atoms=[8, 12, 14, 16, 18, 20],
        line_interaction_type="macroatom")
    state = SimulationState.from_config(config_from_dict(BASE_CONFIG))
    ps = PlasmaSolver(atom, state).update(
        state.t_radiative, state.dilution_factor, line_mode="host")
    kw = mixed_gradient_kw(state.geometry)
    geom = NonhomologousRadial1DGeometry(**kw)
    tgeom = TorchNonhomGeometry(**kw)
    port_atom = atom_data_from_arrays(atom_data_to_arrays(atom))
    ps_nh = nonhomologous_plasma_state(ps, geom)
    tps_nh = tnh.nonhomologous_plasma_state(port_plasma(ps), tgeom)
    base = jax.random.key(np.uint32(NH_SEED))
    pool = sample_blackbody_packets(jax.random.fold_in(base, 0), NH_N,
                                    state.t_inner)
    out = {"pool": tuple(torch.as_tensor(np.array(a)) for a in pool),
           "key": rng.fold_in(rng.key(NH_SEED), 1), "t_inner": state.t_inner}
    for mode in ("scatter", "macroatom"):
        ms = walk = None
        if mode == "macroatom":
            ms = solve_macro_state(atom.macro_atom, ps_nh.beta_sobolev,
                                   ps_nh.j_blues,
                                   ps_nh.stimulated_emission_factor)
            walk = torch_macro_state(port_atom.macro_atom,
                                     tps_nh.beta_sobolev, tps_nh.j_blues,
                                     tps_nh.stimulated_emission_factor)
        tables, static = build_nonhom_tables(geom, ps_nh, atom, mode,
                                             macro_state=ms)
        tt = tnh.build_nonhom_tables(tgeom, tps_nh, port_atom, mode,
                                     walk=walk)
        out[mode] = dict(tables=tables, static=static, tt=tt)
    return out


@pytest.fixture(scope="module")
def k7():
    return k7_problem()


@pytest.mark.parametrize("mode", ["scatter", "macroatom"])
def test_k7_without_line_estimators_is_bitwise(k7, mode):
    """The plain K7 without line estimators: no line difference array, and
    every packet's row, the bulk estimators, the summary and the
    last-interaction rows bitwise the run with them."""
    tt = k7[mode]["tt"]
    mu, nu = k7["pool"]
    kw = dict(batch_size=256, last_interaction=True)
    on = tnh.nonhom_transport_loop_plain(tt, mu, nu, k7["key"], **kw)
    off = tnh.nonhom_transport_loop_plain(tt, mu, nu, k7["key"],
                                          line_estimators=False, **kw)
    assert on.line_diff.numel() == 2 * (tt.n_lines + 1) * tt.n_shells
    assert off.line_diff.numel() == 0
    for field in OUTPUTS:
        assert torch.equal(getattr(off, field), getattr(on, field)), field
    assert int(off.events.sum()) == int(off.summary[2])
    wrapped = tnh.nonhom_transport_loop(tt, mu, nu, k7["key"],
                                        line_estimators=False,
                                        last_interaction=True)
    assert torch.equal(wrapped.out, off.out)
    assert not tnh.nonhom_transport_loop.launches_by_variant


def k7_parity(k7, mode, seed, n):
    """Both packages' nonhomologous loops on a pool of ``n`` packets under
    ``seed`` (the port without line estimators): each packet's status
    agreement and closeness (nu and energy within 1e-5), the bulk
    estimators' largest relative differences, and the events whose line
    the port's count search took."""
    case = k7[mode]
    base = jax.random.key(np.uint32(seed))
    pool = sample_blackbody_packets(jax.random.fold_in(base, 0), n,
                                    k7["t_inner"])
    carry = run_nonhom_transport(case["tables"], case["static"], *pool,
                                 jax.random.fold_in(base, 1), n_packets=n,
                                 batch_size=256, max_steps=60000)
    res = tnh.nonhom_transport_loop_plain(
        case["tt"], *(torch.as_tensor(np.array(a)) for a in pool),
        rng.fold_in(rng.key(seed), 1), batch_size=256,
        line_estimators=False)
    nu_p = res.out[:, 0].numpy().astype(np.float64)
    st_p = np.where(nu_p > 0, 1, np.where(nu_p < 0, 2, 0))
    same = st_p == np.asarray(carry.out_status)
    nu_j = np.asarray(carry.out_nu, np.float64)
    e_j = np.asarray(carry.out_energy, np.float64)
    e_p = res.out[:, 1].numpy().astype(np.float64)
    close = (same & (np.abs(np.abs(nu_p) - nu_j) <= 1e-5 * nu_j)
             & (np.abs(e_p - e_j) <= 1e-5 * np.abs(e_j)))
    rel = {name: float(np.max(np.abs(getattr(res, name).numpy() - ref)
                              / np.abs(ref)))
           for name, ref in (("est_j", carry.est_j_f64()),
                             ("est_nubar", carry.est_nubar_f64()))}
    assert (st_p > 0).all() and res.summary[3].item() == 0
    assert res.line_diff.numel() == 0
    return dict(same=same, close=close, rel=rel,
                count_search_events=res.count_search_events)


# seeds that tests/test_torch_nonhomologous.py (11) does not use; before
# the count search, one packet of K7_N took another trajectory in the two
# packages on each (seed 29's packet 124, seed 3's packet 455)
K7_SEEDS = (3, 29)
K7_N = 2048


@pytest.mark.parametrize("seed", K7_SEEDS)
@pytest.mark.parametrize("mode", ["scatter", "macroatom"])
def test_k7_without_line_estimators_matches_jax(k7, mode, seed):
    """The plain K7 without line estimators against the JAX nonhomologous
    loop on seeds of their own, every packet compared: statuses agree on
    >= 0.95 of packets, nu and energy within 1e-5 on >= 0.95, the bulk
    estimators within the 1e-3 bar of tests/test_torch_nonhomologous.py.
    Shell 0 of this law has a velocity that falls steeply outward, where
    the event predicate turns back over some walked windows; there the port
    takes the JAX package's line (``count_search``), and the packets that
    once parted (seed 29's 124, seed 3's 455) agree like the rest."""
    res = k7_parity(k7, mode, seed, K7_N)
    assert res["same"].mean() >= 0.95, res["same"].mean()
    assert res["close"].mean() >= 0.95, res["close"].mean()
    assert all(r <= 1e-3 for r in res["rel"].values()), res["rel"]
    assert res["count_search_events"] > 0


def k7_windows(k7, seed, n=32768):
    """``n`` event states of the steep-gradient law and their walked
    windows: half of them in shell 0, whose velocity falls steeply
    outward, in its inner fifth, where the pool is born (r, mu, the lab
    frequency from the pool and tau_event drawn), half across the grid;
    next_line the count of lines at or above the comoving frequency."""
    tt = k7["scatter"]["tt"]
    S = tt.n_shells
    g = np.random.default_rng(seed)
    steep = torch.as_tensor(g.random(n) < 0.5)
    shell = torch.where(steep, 0, torch.as_tensor(g.integers(0, S, n)))
    f = torch.as_tensor(g.uniform(0.0, 1.0, n).astype(np.float32))
    f = torch.where(steep, 0.2 * f, f)
    r = tt.r_inner[shell] + f * (tt.r_outer[shell] - tt.r_inner[shell])
    mu = torch.as_tensor(g.uniform(-1.0, 1.0, n).astype(np.float32))
    pool_nu = k7["pool"][1]
    nu = pool_nu[torch.as_tensor(g.integers(0, pool_nu.shape[0], n))]
    u = torch.as_tensor(g.uniform(1e-9, 1.0, n).astype(np.float32))
    tau_event = (-torch.log(u.double())).float()
    m = tt.m_grad[shell]
    nu_cmf = nu * (1.0 - mu * (tt.beta_in[shell]
                               + m * (r - tt.r_inner[shell])))
    next_line = torch.searchsorted(-tt.line_nu, -nu_cmf, right=True)
    return tnh.event_window(tt, r, mu, nu, shell, next_line,
                            tau_event).window, shell


def held_rows(tt, w):
    """The search's predicate over every line of each window (false below
    lo, true from hi on), (n, widest window) from each lane's lo."""
    width = int((w.hi - w.lo).max())
    idx = w.lo[:, None] + torch.arange(width + 1)[None, :]
    wc = w.column()
    return (idx >= wc.hi) | tnh.window_pred(tt, wc, idx)


@pytest.mark.parametrize("seed", K7_SEEDS)
def test_k7_count_search_matches_jax(k7, seed):
    """The port's count search returns the JAX package's
    ``_nonhom_pred_search`` line on every sampled window, forward and
    backward, those over which the predicate turns back included, with
    the JAX package's two-float prefix tables and the port's f64 prefix;
    and where the predicate is monotone it is the bisection's line."""
    tables = k7["scatter"]["tables"]
    tt = k7["scatter"]["tt"]
    w, shell = k7_windows(k7, seed)
    found = tnh.count_search(tt, w)
    assert torch.equal(found[w.lo == w.hi], w.lo[w.lo == w.hi])
    jax_found = np.zeros(found.shape[0], np.int64)
    for forward in (True, False):
        sel = (w.fwd == forward).nonzero()[:, 0]
        pt = tables.pred_fwd if forward else tables.pred_bwd
        c_hi, c_lo = ((tables.tau_cum_hi, tables.tau_cum_lo) if forward
                      else (tables.rev_cum_hi, tables.rev_cum_lo))
        sh, lo = shell[sel].numpy(), w.lo[sel].numpy()

        def arg(a):
            return jax.numpy.asarray(a[sel].numpy())

        jax_found[sel.numpy()] = np.asarray(_nonhom_pred_search(
            pt, jax.numpy.asarray(sh, np.int32),
            jax.numpy.asarray(lo, np.int32),
            jax.numpy.asarray(w.hi[sel].numpy(), np.int32),
            jax.numpy.asarray(np.asarray(c_hi)[sh, lo]),
            jax.numpy.asarray(np.asarray(c_lo)[sh, lo]), arg(w.inv_chi),
            arg(w.tau_event), arg(w.x0), arg(w.p2), arg(w.m), arg(w.q),
            arg(w.nu), forward=forward))
    assert np.array_equal(found.numpy(), jax_found)
    held = held_rows(tt, w)
    turns = ~(held[:, 1:] >= held[:, :-1]).all(1)
    steps = int(np.ceil(np.log2(tt.n_lines + 1))) + 1
    bisect = tnh._bisect(tt, w, steps)
    assert torch.equal(found[~turns], bisect[~turns])
    # forward and backward windows, and windows that turn back
    assert 0 < int(w.fwd.sum()) < w.fwd.shape[0]
    assert int(turns.sum()) > 0


@pytest.mark.parametrize("seed", K7_SEEDS)
def test_k7_guard_sends_no_turning_window_to_the_bisection(k7, seed):
    """``monotone_window`` (the sign of beta_los' at the interval's nearest
    and farthest |x|) holds only where the predicate, as the card
    evaluates it in f32 from the exact prefix difference, is false then
    true over the whole window; it sends the
    windows that turn back to the count search, and takes the bisection
    for most forward windows of the shells whose velocity rises outward
    (not all: with q = beta_in - m r_in < 0, m + q / p turns negative for
    a chord that passes close to the centre)."""
    tt = k7["scatter"]["tt"]
    w, shell = k7_windows(k7, seed)
    proven = tnh.monotone_window(tt, w) & (w.lo < w.hi)
    held = held_rows(tt, w)
    monotone = (held[:, 1:] >= held[:, :-1]).all(1)
    assert bool(monotone[proven].all())
    rising = tt.m_grad[shell] > 0.0
    assert float(proven[rising & w.fwd].float().mean()) > 0.5
    assert 0 < int(proven.sum()) < proven.shape[0]


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_without_line_estimators(k1, n_dev):
    """The CPU sharded path without line estimators: every packet's row,
    last-interaction row and spawn records as one device, the bulk
    estimators within 1e-12, and no line difference array in the sum."""
    case = k1["full_relativity"]
    mu, nu, w = case["pool"]
    kw = dict(pool_w=w, last_interaction=True, vpacket_capacity=8 * N,
              line_estimators=False)
    one = tk.transport_loop(case["pt"], mu, nu, k1["key"], **kw)
    many = run_transport_sharded(case["pt"], mu, nu, k1["key"],
                                 ["cpu"] * n_dev, **kw)
    assert torch.equal(many.out, one.out)
    assert torch.equal(many.last_interaction, one.last_interaction)
    assert int(many.vp_count[0]) == int(one.vp_count[0]) <= 8 * N
    assert torch.equal(chip_smoke.sorted_rows(many.vp_records),
                       chip_smoke.sorted_rows(one.vp_records[
                           :one.n_vp_records]))
    assert many.line_diff.numel() == one.line_diff.numel() == 0
    for name in ("est_j", "est_nubar", "summary"):
        assert chip_smoke.rel_err(getattr(many, name),
                                  getattr(one, name)) <= 1e-12, name


def _recording(monkeypatch, module, attr):
    calls = []
    launch = getattr(module, attr)

    def record(*args, **kw):
        calls.append(kw.get("line_estimators", True))
        return launch(*args, **kw)

    monkeypatch.setattr(module, attr, record)
    return calls


@pytest.mark.parametrize("nonhomologous", [False, True])
def test_solvers_pass_need_line_estimators(monkeypatch, atom_data_prepared,
                                           nonhomologous):
    """run_tardis runs its convergence iterations without line estimators
    and its final iteration with them (the classic K1 and K7); the final
    j_blue estimators are those of a run with line estimators throughout,
    bit for bit."""
    attr = "nonhom_transport_loop" if nonhomologous else "transport_loop"
    cfg = copy.deepcopy(CONFIG)
    cfg["montecarlo"].update(no_of_packets=512, last_no_of_packets=1024,
                             iterations=3)
    if nonhomologous:
        cfg["montecarlo"]["enable_nonhomologous_expansion"] = True
    atom = atom_data_from_arrays(atom_data_to_arrays(atom_data_prepared))
    calls = _recording(monkeypatch, solver_module, attr)
    sim = torch_run_tardis(copy.deepcopy(cfg), atom_data=atom, device="cpu")
    assert calls == [False, False, True]
    res = sim.last_transport_result
    assert res.j_blue_estimator is not None
    # the same run with the line estimators of every iteration accumulated
    launch = getattr(solver_module, attr)

    def always(*args, **kw):
        kw["line_estimators"] = True
        return launch(*args, **kw)

    monkeypatch.setattr(solver_module, attr, always)
    ref = torch_run_tardis(copy.deepcopy(cfg), atom_data=atom, device="cpu")
    np.testing.assert_array_equal(res.j_blue_estimator,
                                  ref.last_transport_result.j_blue_estimator)
    np.testing.assert_array_equal(sim.state.t_radiative,
                                  ref.state.t_radiative)


def test_variant_names_and_flags(k1):
    """An instantiation without line estimators is its own library
    (TL_LINE_ESTIMATORS=0, NH_LINE_ESTIMATORS=0) and its own kernels-line
    name; the continuum instantiations refuse to run without them."""
    pt = k1["classic"]["pt"]
    on, off = tk.variant(pt), tk.variant(pt, line_estimators=False)
    assert tk.variant_name(on) == "classic"
    assert tk.variant_name(off) == "no_line_estimators"
    assert "TL_LINE_ESTIMATORS=0" in tk.library_defines(off)
    assert "TL_LINE_ESTIMATORS=1" in tk.library_defines(on)
    rel = tk.variant(k1["full_relativity"]["pt"], torch.ones(2), True, 0,
                     False)
    assert tk.variant_name(rel) == (
        "full_relativity+last_interaction+weights+no_line_estimators")
    nh = tnh.variant(SimpleNamespace(mode=2, inner_boundary_albedo=0.0), True,
                     0, False)
    assert tnh.variant_name(nh) == "macro+last_interaction+no_line_estimators"
    assert tnh.library_defines(nh)[-1] == "NH_LINE_ESTIMATORS=0"
    cont = dataclasses.replace(pt, continuum=SimpleNamespace())
    with pytest.raises(ValueError, match="line estimators"):
        tk.transport_loop_plain(cont, torch.zeros(4), torch.ones(4),
                                k1["key"], line_estimators=False)


def _sum(terms, order):
    total = 0.0
    for x in terms[order]:
        total += float(x)
    return total


@pytest.mark.parametrize("n", [2, 17, 1000, 20000])
def test_summation_bound(n):
    """Two orders of the same non-negative f64 terms stay within
    summation_bound of each other; a sum moved by twice the bound fails;
    one term leaves no room."""
    gen = np.random.default_rng(n)
    terms = gen.lognormal(0.0, 3.0, n)
    a = torch.tensor([_sum(terms, np.arange(n))], dtype=torch.float64)
    b = torch.tensor([_sum(terms, gen.permutation(n))], dtype=torch.float64)
    c = torch.tensor([math.fsum(sorted(terms))], dtype=torch.float64)
    count = torch.tensor([float(n)])
    for x, y in ((a, b), (a, c), (b, c)):
        assert chip_smoke.over_bound(
            x, y, chip_smoke.summation_bound(count, x, y)) <= 1.0
    bound = chip_smoke.summation_bound(count, a, b)
    assert bound.item() == pytest.approx(2 * (n - 1) * 2.0**-53 * a.item(),
                                         rel=1e-6)
    moved = a + 2 * bound
    assert chip_smoke.over_bound(
        moved, b, chip_smoke.summation_bound(count, moved, b)) > 1.0
    one = torch.tensor([1.0])
    x = torch.tensor([3.0], dtype=torch.float64)
    assert chip_smoke.summation_bound(one, x, x).item() == 0.0
    assert chip_smoke.over_bound(x, x, torch.zeros(1)) == 0.0
    assert chip_smoke.over_bound(x, x + 1e-15, torch.zeros(1)) == math.inf


def test_continuum_sum_bounds_by_row():
    """continuum_sum_bounds reads each moment row's term count from column
    6 and each shell's free-free count from its rows: the same terms summed
    in two orders pass row by row, a row moved past its bound fails, and
    differing counts are reported."""
    gen = np.random.default_rng(5)
    S, rows = 4, 12
    moments = [np.zeros((rows * S, 8)) for _ in range(2)]
    ff = [np.zeros(S) for _ in range(2)]
    for r in range(rows * S):
        n = int(gen.integers(1, 400))
        terms = gen.lognormal(0.0, 2.0, (n, 6))
        heat = gen.lognormal(0.0, 2.0, n)
        for side, order in enumerate((np.arange(n), gen.permutation(n))):
            for i in order:
                moments[side][r, :6] += terms[i]
                moments[side][r, 6] += 1.0
                ff[side][r % S] += heat[i]
    k, p = (SimpleNamespace(cont_moments=torch.tensor(m),
                            est_ff_heat=torch.tensor(f))
            for m, f in zip(moments, ff))
    equal, sums = chip_smoke.continuum_sum_bounds(k, p)
    assert equal
    assert all(v["over_bound"] <= 1.0 for v in sums.values()), sums
    assert sums["cont_moments"]["terms_max"] < 400
    bad = copy.deepcopy(k)
    bad.cont_moments[3, 2] *= 1.0 + 1e-12
    assert chip_smoke.continuum_sum_bounds(bad, p)[1]["cont_moments"][
        "over_bound"] > 1.0
    bad.cont_moments[3, 6] += 1.0
    assert not chip_smoke.continuum_sum_bounds(bad, p)[0]


def test_lane_efficiency():
    """The share of a warp's lane-events that do work when one thread walks
    each packet: 1 for equal counts, 1/32 for one long packet a warp."""
    assert chip_smoke.lane_efficiency(torch.full((64,), 7)) == 1.0
    one_long = torch.ones(64, dtype=torch.int32)
    one_long[::32] = 1000
    assert chip_smoke.lane_efficiency(one_long) == pytest.approx(
        (2 * 1000 + 62) / (64 * 1000))
    numbers = chip_smoke.events_numbers(torch.arange(1, 101), 0)
    assert numbers["events_per_packet"]["max"] == 100


if __name__ == "__main__":
    # the readings behind test_k7_without_line_estimators_matches_jax
    # (JAX_PLATFORMS=cpu python -m tests.test_torch_event_loops)
    problem = k7_problem()
    for seed in (1, 2, 11) + K7_SEEDS:
        for mode in ("scatter", "macroatom"):
            res = k7_parity(problem, mode, seed, K7_N)
            print(f"seed {seed} {mode}: parted "
                  f"{np.flatnonzero(~res['close']).tolist()} (status "
                  f"differs: {np.flatnonzero(~res['same']).tolist()}); "
                  f"est_j / est_nubar max rel {res['rel']}; events by the "
                  f"count search {res['count_search_events']}")
