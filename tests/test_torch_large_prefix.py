"""K1's event line on a line list whose tau prefix is large.

``tests/test_full_e2e.py``'s list (``make_synthetic_atom_data(n_levels=55,
fine_structure_split=3e-6)``, 105,948 lines with near-degenerate
multiplets) gives shell 0 a tau prefix of 1.42e9, where one f32 ulp is
128 and tau_event is ~1.  The plain K1 takes the prefix difference in f64
and rounds it to f32, so its event line must be the line an exact f64
scan of the event predicate finds, on every event state that a run of
the chain and of the walk sampler reaches.  K7's count search reads the
f64 difference at every level too: on sampled nonhomologous windows it
takes the first line where the f64-prefix predicate holds, except where
that predicate turns back, where it takes the count of false samples by
design.  Beside them the script reports the JAX package's per-packet
agreement with the port on the same pool and key (its coarse search
levels read the f32-rounded prefix; ``ROADMAP.md`` section 3) and K7's
agreement with the first true line.  Run it as a script
(``JAX_PLATFORMS=cpu python -m tests.test_torch_large_prefix``) to print
those readings.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from tardis_torch.atomic.convert import atom_data_from_arrays, atom_data_to_arrays
from tardis_torch.config.reader import config_from_dict as torch_config
from tardis_torch.model.geometry import (
    NonhomologousRadial1DGeometry as TorchNonhomGeometry,
)
from tardis_torch.model.state import SimulationState as TorchState
from tardis_torch.opacities import macro_atom_solver as torch_mas
from tardis_torch.transport import kernel as tk
from tardis_torch.transport import nonhomologous as tnh
from tardis_torch.transport import rng
from tardis_torch.transport.tables import build_transport_tables as torch_tables
from tardis_tpu.atomic.synthetic import make_synthetic_atom_data
from tardis_tpu.config.reader import config_from_dict
from tardis_tpu.model.state import SimulationState
from tardis_tpu.opacities import macro_atom_solver as jax_mas
from tardis_tpu.plasma.solver import PlasmaSolver
from tardis_tpu.transport.device_state import NU_UNIT, build_transport_tables
from tardis_tpu.transport.kernel import run_transport
from tardis_tpu.transport.source import sample_blackbody_packets

from tests.test_plasma import BASE_CONFIG
from tests.test_torch_event_loops import k7_windows
from tests.test_torch_nonhomologous import mixed_gradient_kw, port_plasma

torch.set_num_threads(2)

N = 2048
SEED = 7
HOT = 5.0
SAMPLERS = ("chain", "walk")


@functools.lru_cache(maxsize=None)
def problem():
    atom = make_synthetic_atom_data(
        n_levels=55, fine_structure_split=3e-6).prepare(
        selected_atoms=[8, 12, 14, 16, 18, 20],
        line_interaction_type="macroatom")
    state = SimulationState.from_config(config_from_dict(BASE_CONFIG))
    ps = PlasmaSolver(atom, state).update(
        state.t_radiative, state.dilution_factor, line_mode="host")
    S, L = ps.tau_sobolev.shape[1], ps.tau_sobolev.shape[0]
    prefix = np.zeros((S, L + 1))
    np.cumsum(ps.tau_sobolev.T, axis=1, out=prefix[:, 1:])
    port_atom = atom_data_from_arrays(atom_data_to_arrays(atom))
    args = (ps.beta_sobolev, ps.j_blues, ps.stimulated_emission_factor)
    targs = tuple(torch.as_tensor(a) for a in args)
    kw = {"chain": dict(macro_chain=torch_mas.solve_macro_chain(
              port_atom.macro_atom, *targs, mode="macroatom",
              line_nu_scaled=atom.line_nu / NU_UNIT)),
          "walk": dict(macro_walk=torch_mas.solve_macro_state(
              port_atom.macro_atom, *targs))}
    pstate = TorchState.from_config(torch_config(BASE_CONFIG))
    tables = {m: torch_tables(pstate.geometry, ps.electron_densities,
                              torch.as_tensor(prefix), port_atom,
                              "macroatom", **kw[m]) for m in SAMPLERS}
    base = jax.random.key(np.uint32(SEED))
    pool = sample_blackbody_packets(jax.random.fold_in(base, 0), N,
                                    HOT * state.t_inner)
    return dict(atom=atom, state=state, ps=ps, prefix=prefix,
                port_atom=port_atom, tables=tables, pool=pool, base=base)


def run_with_states(sampler):
    """The plain K1 on the hot pool, with every event search's inputs and
    line kept (the states of every event of every packet)."""
    p = problem()
    captured = []
    search = tk._search

    def keep(t, shell, lo, chi, z, nu, tau_event, nu_thresh, c0, p2):
        found = search(t, shell, lo, chi, z, nu, tau_event, nu_thresh, c0,
                       p2)
        captured.append((shell, lo, chi, z, nu, tau_event, nu_thresh, c0,
                         found))
        return found

    mu, nu = (torch.as_tensor(np.array(a)) for a in p["pool"])
    tk._search = keep
    try:
        res = tk.transport_loop_plain(p["tables"][sampler], mu, nu,
                                      rng.fold_in(rng.key(SEED), 1),
                                      batch_size=512)
    finally:
        tk._search = search
    return res, [torch.cat(x) for x in zip(*captured)]


def exact_event_line(prefix, line_nu, shell, lo, chi, z, nu, tau_event,
                     nu_thresh, c0):
    """First i in [lo, L] with i == L or the event predicate, all in f64
    on the f64 prefix (exact arithmetic keeps the predicate monotone, so a
    bisection is the scan)."""
    L = line_nu.shape[0]
    flat = torch.as_tensor(prefix).reshape(-1)
    lnu = line_nu.double()
    a, b = lo.clone(), torch.full_like(lo, L)
    for _ in range(int(np.ceil(np.log2(L + 1))) + 1):
        active = a < b
        mid = (a + b) >> 1
        mc = mid.clamp(max=L - 1)
        nl = lnu[mc]
        s = torch.clamp((1.0 - nl / nu.double()) - z.double(), min=0.0)
        g = (flat[shell * (L + 1) + mc + 1] - c0) + chi.double() * s
        fire = (nl <= nu_thresh.double()) | (g > tau_event.double())
        a = torch.where(active & ~fire, mid + 1, a)
        b = torch.where(active & fire, mid, b)
    return a


@pytest.fixture(scope="module", params=SAMPLERS)
def sampled(request):
    return request.param, *run_with_states(request.param)


def test_event_line_is_the_exact_f64_line(sampled):
    """Every event state the run reaches, shell 0's included: the plain
    K1's event line is the exact f64 scan's."""
    sampler, res, (shell, lo, chi, z, nu, tau, nu_thresh, c0, found) = \
        sampled
    p = problem()
    assert p["prefix"][0, -1] > 1e9
    exact = exact_event_line(p["prefix"], p["tables"][sampler].line_nu,
                             shell, lo, chi, z, nu, tau, nu_thresh, c0)
    # every live lane's event, and the lockstep loop's idle lanes
    assert shell.shape[0] >= int(res.summary[2]) > 10 * N
    assert int((shell == 0).sum()) > N
    assert torch.equal(found, exact), int((found != exact).sum())
    if sampler == "walk":
        assert res.walk_tally["walks"] > 0


def jax_agreement(sampler, res):
    """Share of packets whose status agrees and whose nu lies within 1e-5
    of the JAX package's run on the same tables, pool and key."""
    p = problem()
    atom, ps = p["atom"], p["ps"]
    args = (ps.beta_sobolev, ps.j_blues, ps.stimulated_emission_factor)
    kw = (dict(macro_chain=jax_mas.solve_macro_chain(
        atom.macro_atom, *args, mode="macroatom",
        line_nu_scaled=atom.line_nu / NU_UNIT)) if sampler == "chain" else
        dict(macro_state=jax_mas.solve_macro_state(atom.macro_atom, *args)))
    tables, static = build_transport_tables(p["state"].geometry, ps, atom,
                                            "macroatom", **kw)
    carry = run_transport(tables, static, *p["pool"],
                          jax.random.fold_in(p["base"], 1), n_packets=N,
                          batch_size=512)
    out = res.out.numpy().astype(np.float64)
    status = np.where(out[:, 0] > 0, 1, 2)
    nu_j = np.asarray(carry.out_nu, np.float64)
    return float(np.mean((status == np.asarray(carry.out_status))
                         & (np.abs(np.abs(out[:, 0]) - nu_j) <= 1e-5 * nu_j)))


@functools.lru_cache(maxsize=None)
def k7_count_search_windows(n=4096, seed=3, chunk=1024):
    """Sampled nonhomologous windows on this list (the mixed-gradient law
    of tests/test_torch_nonhomologous.py, half in its steep shell 0):
    the tables, the windows, their shells, each window's count-search
    line and the first line of the window where the f64-prefix predicate
    holds (a scan of the window; hi if none)."""
    p = problem()
    state = p["state"]
    tgeom = TorchNonhomGeometry(**mixed_gradient_kw(state.geometry))
    tps = tnh.nonhomologous_plasma_state(port_plasma(p["ps"]), tgeom)
    tt = tnh.build_nonhom_tables(tgeom, tps, p["port_atom"], "scatter")
    pool = tuple(torch.as_tensor(np.array(a)) for a in p["pool"])
    w, shell = k7_windows({"scatter": {"tt": tt}, "pool": pool}, seed, n)
    found = tnh.count_search(tt, w)
    exact = w.hi.clone()
    pending = w.lo < w.hi
    start = 0
    while bool(pending.any()):
        sel = pending.nonzero()[:, 0]
        ws = w.take(sel)
        idx = ws.lo[:, None] + start + torch.arange(chunk)[None, :]
        pred = (tnh.window_pred(tt, ws.column(), idx)
                & (idx < ws.hi[:, None]))
        hit = pred.any(1)
        first = idx.gather(1, pred.long().argmax(1, keepdim=True))[:, 0]
        exact[sel[hit]] = first[hit]
        done = hit | (ws.lo + start + chunk >= ws.hi)
        pending[sel[done]] = False
        start += chunk
    return tt, w, shell, found, exact


def k7_count_search_agreement(n=4096, seed=3):
    """Share of the sampled windows whose count-search line is the first
    line where the f64-prefix predicate holds."""
    *_, found, exact = k7_count_search_windows(n, seed)
    return float((found == exact).double().mean())


def f64_count_line(tt, w, lo, hi):
    """The three-level count of false samples (tiles of
    ``nonhomologous.TILE``; a sample below lo false, at hi or beyond
    true), one window at a time on the f64-prefix predicate."""
    tile = tnh.TILE
    t0 = -(-tt.n_lines // tile)
    t1 = -(-t0 // tile)

    def false_samples(base, stride):
        idx = base + torch.arange(tile) * stride
        held = (idx >= lo) & ((idx >= hi)
                              | tnh.window_pred(tt, w, idx[None, :])[0])
        return int((~held).sum())

    tile1 = min(max(false_samples(0, tile * tile) - 1, 0), t1 - 1)
    c1 = false_samples(tile1 * tile * tile, tile)
    tile0 = min(max(tile1 * tile + c1 - 1, 0), t0 - 1)
    return min(max(tile0 * tile + false_samples(tile0 * tile, 1), lo), hi)


def test_k7_count_search_takes_the_f64_line():
    """K7's count search reads the f64 prefix difference at every level:
    on the sampled windows it takes the first line where the f64-prefix
    predicate holds, and each window where it does not is named by its
    cause: the predicate turns back over it (a steep shell-0 window,
    which the guard sends to the count search), where the count search
    takes the count of false samples on that predicate, by design."""
    tt, w, shell, found, exact = k7_count_search_windows()
    assert tt.prefix[0, -1] > 5e8  # one f32 ulp: 64
    assert int((w.lo < w.hi).sum()) > 2048
    parted = (found != exact).nonzero()[:, 0]
    assert parted.numel() <= 4, parted  # 1 of 4,096 on seed 3
    for i in parted.tolist():
        wi = w.take(torch.tensor([i])).column()
        lo, hi = int(w.lo[i]), int(w.hi[i])
        pred = tnh.window_pred(tt, wi, torch.arange(lo, hi)[None, :])[0]
        assert bool((pred[1:].long() < pred[:-1].long()).any()), i
        assert not bool(tnh.monotone_window(tt, w.take(torch.tensor([i]))))
        assert int(shell[i]) == 0
        assert int(found[i]) == f64_count_line(tt, wi, lo, hi), i


if __name__ == "__main__":
    for sampler in SAMPLERS:
        res, _ = run_with_states(sampler)
        print(f"{sampler}: JAX per-packet agreement "
              f"{jax_agreement(sampler, res):.4f}")
    print(f"K7 count-search agreement {k7_count_search_agreement():.4f}")
