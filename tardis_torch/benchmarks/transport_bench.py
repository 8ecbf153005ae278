"""Transport benchmark: packets/s of a tardis_example-scale problem.

Counterpart of ``tardis_tpu/benchmarks/transport_bench.py``.  One Monte
Carlo iteration of the bench problem (W7-like model, 20 shells, synthetic
atomic data scaled to a kurucz-like line count), K1 on K2's pool and, in
the macro modes, K8's chain tables, with line estimators; optionally the
end-to-end convergence loop, the final iteration with virtual packets, the
IIP (continuum) problem, and K1's share of its bound.

Usage:  python -m tardis_torch.benchmarks.transport_bench [--packets N]
        [--levels L] [--jump J] [--mode scatter|downbranch|macroatom]
        [--repeats R] [--e2e-iters K] [--final-vpackets V] [--iip]
        [--roofline] [--device cpu]

``bench.py``'s workload is ``--packets 2097152 --levels 200 --jump 60
--mode macroatom --e2e-iters 5 --final-vpackets 2 --iip --roofline``.  It
runs on the card unless ``--device cpu`` asks for the plain PyTorch
versions, raises where there is no card, and exits non-zero when it ran on
another device than the one asked for.  Every host clock is read after
``torch.cuda.synchronize()``; the first call of each kernel library builds
it with ``nvcc``, which ``first_time_s`` and the untimed warm-up iterations
pay, never ``time_s``.

It prints one JSON line with the JAX module's keys, but for these:

- ``platform`` is ``device`` (``cuda`` or ``cpu``), beside ``card``, the
  card's name and power limit from ``nvidia-smi`` (null on the CPU);
- ``batch_size`` (top level and ``iip``) is not printed: it is the TPU's
  lockstep width, and with ``--batch`` and ``--chunk`` (its watchdog
  slicing) it has no counterpart in K1, whose lanes refill from a packet
  queue; the command line takes neither option;
- ``n_steps`` (top level and ``iip``), the lockstep steps, is not printed:
  K1 takes none; ``stopped`` (the packets the event cap stopped) and
  ``device_ms`` (the K1 launch's device time: CUDA events around a call
  queued behind a hold, ``held_ms``, the least of ``--repeats``) are
  added.  ``n_events`` is every event of every packet (K1's count); the
  JAX carry counts the lanes alive after each lockstep step, which leaves
  out each packet's last event;
- ``iip`` is one run, not ``ladder`` / ``no_ladder`` with
  ``ladder_speedup_events_per_s``: the drain-tail repack they compare is
  what K1's refilling lanes do in every run.  ``max_steps_cap`` is
  ``max_events_cap`` (K1's per-packet event cap), ``alive_at_cap`` is
  ``stopped``, and ``occupancy_vs_full_width`` is ``lane_efficiency``
  (``bounds.lane_efficiency``);
- ``roofline`` holds K1's bound (``bounds.k1_bound``: bytes and operations
  at the card's rates), ``device_ms`` and ``fraction_of_bound`` = bound /
  device_ms, not the TPU's gather budget (``gather_ns_per_row``,
  ``scatter_ns_per_update``, ``critical_gathers_per_step``,
  ``roofline_time_s``, ``fraction_of_roofline``), which counted six
  row gathers a lockstep step.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from tardis_torch.benchmarks.bounds import (
    Rates,
    card_line,
    card_rates,
    k1_bound,
    lane_efficiency,
)
from tardis_torch.cuda import resolve_device

SEED = 23111963


def sync(device: torch.device) -> None:
    """Wait for the card's queue (a no-op on the CPU), so the host clock
    read next times the work and not its launch."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_fields(device: torch.device) -> dict:
    """``device`` (the kind of the device a result's tensors lie on: where
    it ran) and ``card`` (``nvidia-smi``'s name and power limit of that
    card, None on the CPU)."""
    return {"device": device.type,
            "card": card_line(device.index or 0)
            if device.type == "cuda" else None}


def refuse_other_device(asked, *results) -> None:
    """Exit non-zero when a result ran on another kind of device than the
    one asked for (None: the card)."""
    want = torch.device("cuda" if asked is None else asked).type
    ran = {r["device"] for r in results}
    if ran != {want}:
        raise SystemExit(
            f"asked for device {want!r} but ran on {sorted(ran)}: refusing "
            "to report a mislabelled figure")


def build_problem(n_levels=250, max_level_jump=80, mode="scatter",
                  mc_overrides=None, device=None):
    """(config, state, atom, plasma) of the bench problem, the plasma
    solved on ``device`` at the model's initial radiation field."""
    from tardis_torch.atomic.synthetic import make_synthetic_atom_data
    from tardis_torch.config.reader import config_from_dict
    from tardis_torch.model.state import SimulationState
    from tardis_torch.plasma.solver import PlasmaSolver

    device = resolve_device(device)
    montecarlo = {"seed": SEED, "no_of_packets": 1e5, "iterations": 1}
    montecarlo.update(mc_overrides or {})
    config = config_from_dict(
        {
            "supernova": {
                "luminosity_requested": "9.44 log_lsun",
                "time_explosion": "13 day",
            },
            "model": {
                "structure": {
                    "type": "specific",
                    "velocity": {
                        "start": "1.1e4 km/s",
                        "stop": "20000 km/s",
                        "num": 20,
                    },
                    "density": {"type": "branch85_w7"},
                },
                "abundances": {
                    "type": "uniform",
                    "O": 0.19,
                    "Mg": 0.03,
                    "Si": 0.52,
                    "S": 0.19,
                    "Ar": 0.04,
                    "Ca": 0.03,
                },
            },
            "plasma": {"line_interaction_type": mode},
            "montecarlo": montecarlo,
            "spectrum": {"start": "500 angstrom", "stop": "20000 angstrom",
                         "num": 10000},
        }
    )
    state = SimulationState.from_config(config)
    atom = make_synthetic_atom_data(
        n_levels=n_levels, max_level_jump=max_level_jump
    ).prepare(
        selected_atoms=[8, 12, 14, 16, 18, 20], line_interaction_type=mode
    )
    plasma = PlasmaSolver(atom, state, device).update(
        state.t_radiative, state.dilution_factor
    )
    return config, state, atom, plasma


def problem_tables(state, atom, plasma, mode):
    """K1's tables of the problem: in the macro modes K8's chain tables
    where they fit the device budget, else the walk tables, as
    ``TransportSolver.run_iteration`` picks them.  Returns (tables, the
    seconds of the macro-atom solve, of the table build)."""
    from tardis_torch.opacities.macro_atom_solver import (
        solve_macro_chain,
        solve_macro_state,
    )
    from tardis_torch.transport.tables import NU_UNIT, build_transport_tables

    device = plasma.tau_prefix.device
    macro_chain = macro_walk = None
    sync(device)
    t0 = time.perf_counter()
    if mode in ("downbranch", "macroatom"):
        macro = atom.downbranch if mode == "downbranch" else atom.macro_atom
        margs = (macro, plasma.beta_sobolev, plasma.j_blues,
                 plasma.stimulated_emission_factor)
        macro_chain = solve_macro_chain(
            *margs, mode=mode, line_nu_scaled=atom.line_nu / NU_UNIT)
        if macro_chain is None:
            macro_walk = solve_macro_state(*margs)
    sync(device)
    macro_solve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tables = build_transport_tables(
        state.geometry, plasma.electron_densities, plasma.tau_prefix, atom,
        mode, macro_chain=macro_chain, macro_walk=macro_walk)
    sync(device)
    return tables, macro_solve_s, time.perf_counter() - t0


# clock cycles the card spins before a timed launch (~20 ms at the
# 1.98 GHz max SM clock of an NVIDIA H100 SXM),
# so that the host's work for the call (checks, allocations, the launch)
# is done before the card reaches the start event
HOLD_CYCLES = 40_000_000


def held_ms(fn):
    """Device ms of one call of ``fn`` queued behind a hold: CUDA events
    around the call, recorded while the card spins, so they time the
    call's device work and not the host's.  If the card left the hold
    before the host had queued the call, the call is made again behind
    twice the hold (up to three tries)."""
    for attempt in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES << attempt)
        a.record()
        fn()
        held = not a.query()
        b.record()
        torch.cuda.synchronize()
        if held:
            break
    return a.elapsed_time(b)


def timed(fn, device, repeats):
    """``repeats`` calls of ``fn``, each between two synchronisations:
    (each call's host seconds, the least device ms of ``repeats`` more
    calls queued behind a hold (None on the CPU), the last result).  The
    first call pays the builds of the kernels it launches."""
    times, out = [], None
    for _ in range(repeats):
        sync(device)
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        times.append(time.perf_counter() - t0)
    device_ms = None
    if device.type == "cuda":
        device_ms = min(held_ms(fn) for _ in range(repeats))
    return times, device_ms, out


@torch.no_grad()
def bench_transport(
    n_packets=1_000_000,
    n_levels=250,
    max_level_jump=80,
    mode="scatter",
    repeats=2,
    roofline=False,
    device=None,
):
    """One iteration's K1 launch on the problem's K2 pool (the first
    iteration's keys), with line estimators, ``repeats`` times; with
    ``roofline`` also K1's bound at the card's rates (an H100 SXM's on the
    CPU) and its share of the launch's device time."""
    from tardis_torch.transport.kernel import transport_loop
    from tardis_torch.transport.solver import iteration_keys
    from tardis_torch.transport.source import blackbody_source

    device = resolve_device(device)
    config, state, atom, plasma = build_problem(
        n_levels, max_level_jump, mode, device=device)
    tables, macro_solve_s, tables_build_s = problem_tables(
        state, atom, plasma, mode)
    src_key, run_key = iteration_keys(SEED, 0)
    pool_mu, pool_nu, _ = blackbody_source(src_key, n_packets,
                                           state.t_inner, device)
    times, device_ms, res = timed(
        lambda: transport_loop(tables, pool_mu, pool_nu, run_key), device,
        repeats)
    best = min(times)
    n_events = float(res.summary[2])
    out = {
        "n_packets": n_packets,
        "n_lines": atom.n_lines,
        "mode": mode,
        "time_s": best,
        "first_time_s": times[0],
        "macro_solve_s": macro_solve_s,
        "tables_build_s": tables_build_s,
        "packets_per_s": n_packets / best,
        "device_ms": device_ms,
        "n_events": n_events,
        "stopped": int(res.summary[3]),
        "events_per_s": n_events / best,
        **device_fields(res.out.device),
    }
    if roofline:
        rates = card_rates(device.index or 0) if device.type == "cuda" \
            else Rates()
        bound_ms, bound_by = k1_bound(tables, n_packets, n_events, rates)
        launch_ms = out["device_ms"] or best * 1e3
        out["roofline"] = {
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "device_ms": launch_ms,
            "fraction_of_bound": bound_ms / launch_ms,
            "rates": rates.summary(),
        }
    return out


@torch.no_grad()
def bench_e2e(
    n_packets=2_097_152,
    n_iterations=3,
    n_levels=200,
    max_level_jump=60,
    mode="macroatom",
    device=None,
):
    """End-to-end convergence-loop benchmark: full simulation iterations
    (plasma solve, macro-atom chain build, table build, transport,
    estimator inversion, convergence update) on the bench problem, after
    one untimed warm-up iteration that pays the kernels' builds.  The
    number a production run sees, not the kernel alone."""
    from tardis_torch.simulation.base import Simulation

    device = resolve_device(device)
    config, state, atom, plasma = build_problem(
        n_levels, max_level_jump, mode,
        mc_overrides={
            "no_of_packets": n_packets,
            "iterations": n_iterations + 2,
            "last_no_of_packets": n_packets,
            "tracking": {"track_last_interaction": False},
        },
        device=device,
    )
    sim = Simulation.from_config(config, atom_data=atom, device=device)

    # warm-up iteration: the kernels' builds at first use
    sim._solve_plasma()
    res = sim.iterate(n_packets, 0)
    sim.advance_state(res, 0)

    iterate_s = []
    advance_s = []
    sync(device)
    t_all = time.perf_counter()
    for it in range(1, n_iterations + 1):
        ta = time.perf_counter()
        res = sim.iterate(n_packets, it)
        sync(device)
        tb = time.perf_counter()
        sim.advance_state(res, it)
        sync(device)
        tc = time.perf_counter()
        iterate_s.append(tb - ta)
        advance_s.append(tc - tb)
    total = time.perf_counter() - t_all
    best_iter = min(a + b for a, b in zip(iterate_s, advance_s))
    return {
        "n_packets_per_iteration": n_packets,
        "n_iterations": n_iterations,
        "e2e_total_s": total,
        "e2e_s_per_iteration": total / n_iterations,
        "iterate_s": iterate_s,  # plasma tables, K8, K2, K1, finalize
        "advance_s": advance_s,  # inversion, convergence, plasma solve
        "e2e_packets_per_s": n_packets * n_iterations / total,
        # the host phases share the machine's cores with whatever else
        # runs there, so the best iteration is reported beside the mean
        "best_iteration_s": best_iter,
        "best_e2e_packets_per_s": n_packets / best_iter,
        **device_fields(sim.plasma_state.tau_prefix.device),
    }


@torch.no_grad()
def bench_final_iteration(
    n_packets=2_097_152,
    n_vpackets=2,
    n_levels=200,
    max_level_jump=60,
    mode="macroatom",
    n_spectrum_bins=10000,
    device=None,
):
    """Final-iteration benchmark: the high-statistics spectral iteration
    with spawn records, the virtual-packet volley (K4) and the line
    estimators, which a convergence-only figure hides.  One untimed
    warm-up iteration pays the builds; the best of two runs of
    ``Simulation.run_final`` is its steady-state cost."""
    from tardis_torch.simulation.base import Simulation

    device = resolve_device(device)
    config, state, atom, plasma = build_problem(
        n_levels, max_level_jump, mode,
        mc_overrides={
            "no_of_packets": n_packets,
            "iterations": 3,
            "last_no_of_packets": n_packets,
            "no_of_virtual_packets": n_vpackets,
            "tracking": {"track_last_interaction": False},
        },
        device=device,
    )
    config["spectrum"]["num"] = n_spectrum_bins
    sim = Simulation.from_config(config, atom_data=atom, device=device)
    sim._solve_plasma()
    res = sim.iterate(n_packets, 0)
    sim.advance_state(res, 0)

    times = []
    vp_records = 0
    for rep in range(2):
        sim.iterations_executed = 1 + rep
        sync(device)
        t0 = time.perf_counter()
        sim.run_final()
        sync(device)
        times.append(time.perf_counter() - t0)
        vp_records = sim.last_transport_result.vp_records
    best = min(times)
    return {
        "n_packets": n_packets,
        "n_vpackets": n_vpackets,
        "n_spectrum_bins": n_spectrum_bins,
        "vp_spawn_records": int(vp_records),
        "n_rays": int(vp_records) * n_vpackets,
        "time_s": best,
        "first_time_s": times[0],
        "packets_per_s": n_packets / best,
        "spectrum_virtual_finite": bool(
            np.isfinite(sim.spectrum_virtual.luminosity_nu).all()
        ),
        **device_fields(sim.plasma_state.tau_prefix.device),
    }


IIP_CONFIG = {
    "supernova": {
        "luminosity_requested": "9.44 log_lsun",
        "time_explosion": "13 day",
    },
    "model": {
        "structure": {
            "type": "specific",
            "velocity": {"start": "1.1e4 km/s",
                         "stop": "20000 km/s", "num": 20},
            "density": {"type": "branch85_w7"},
        },
        "abundances": {"type": "uniform", "H": 0.8, "He": 0.2},
    },
    "plasma": {"line_interaction_type": "macroatom"},
    "montecarlo": {"seed": SEED, "no_of_packets": 1e5, "iterations": 1},
    "spectrum": {"start": "500 angstrom", "stop": "20000 angstrom",
                 "num": 1000},
}


@torch.no_grad()
def bench_iip(n_packets=65536, max_events=3000, device=None):
    """IIP (continuum) transport throughput and lane efficiency: H / He,
    10 levels an ion, H I continua, full relativity, the relativistic
    pool.  Continuum-thick states random-walk single packets through
    1e4-1e5 events, so every packet stops at ``max_events`` events and the
    metric is events/s, not packets/s.  K1's continuum loop is one launch
    of a persistent grid whose lanes refill from a queue; the best of two
    runs is reported, with ``lane_efficiency``: the events over what a
    layout of one thread a packet would spend, from the per-packet event
    counts."""
    from tardis_torch.atomic.synthetic import make_synthetic_atom_data
    from tardis_torch.config.reader import config_from_dict
    from tardis_torch.constants import C
    from tardis_torch.model.state import SimulationState
    from tardis_torch.opacities.continuum_macro import (
        solve_continuum_macro_state,
    )
    from tardis_torch.plasma.continuum import ContinuumSolver
    from tardis_torch.plasma.solver import PlasmaSolver
    from tardis_torch.transport.kernel import transport_loop
    from tardis_torch.transport.solver import iteration_keys
    from tardis_torch.transport.source import blackbody_source
    from tardis_torch.transport.tables import (
        build_continuum_tables,
        build_transport_tables,
    )

    device = resolve_device(device)
    state = SimulationState.from_config(config_from_dict(IIP_CONFIG))
    atom = make_synthetic_atom_data(
        atomic_numbers=(1, 2), max_ion_stage=2, n_levels=10,
        continuum_species=((1, 0),),
    ).prepare(line_interaction_type="macroatom")
    pls = PlasmaSolver(atom, state, device)
    ps = pls.update(state.t_radiative, state.dilution_factor)
    cont = ContinuumSolver(atom, pls).update(ps)
    macro = solve_continuum_macro_state(atom, ps, cont, ps.j_blues)
    tables = build_transport_tables(
        state.geometry, ps.electron_densities, ps.tau_prefix, atom,
        "macroatom", full_relativity=True,
        continuum=build_continuum_tables(state.geometry, atom, cont, macro,
                                         device))
    src_key, run_key = iteration_keys(SEED, 0)
    beta_inner = float(state.geometry.r_inner[0]
                       / (C * state.time_explosion))
    pool_mu, pool_nu, pool_w = blackbody_source(
        src_key, n_packets, state.t_inner, device, "relativistic",
        beta_inner=beta_inner)
    times, device_ms, res = timed(
        lambda: transport_loop(tables, pool_mu, pool_nu, run_key,
                               max_events=max_events, pool_w=pool_w),
        device, 2)
    best = min(times)
    n_events = float(res.summary[2])
    return {
        "n_packets": n_packets,
        "max_events_cap": max_events,
        "time_s": best,
        "first_time_s": times[0],
        "device_ms": device_ms,
        "n_events": n_events,
        "events_per_s": n_events / best,
        "lane_efficiency": lane_efficiency(res.events),
        "stopped": int(res.summary[3]),
        **device_fields(res.out.device),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="K1's packets/s on the bench problem (one JSON line)")
    ap.add_argument("--packets", type=int, default=1_000_000)
    ap.add_argument("--levels", type=int, default=250)
    ap.add_argument("--jump", type=int, default=80)
    ap.add_argument("--mode", default="scatter",
                    choices=("scatter", "downbranch", "macroatom"))
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument(
        "--e2e-iters", type=int, default=0,
        help="also run an N-iteration end-to-end convergence-loop bench",
    )
    ap.add_argument(
        "--iip", action="store_true",
        help="also run the IIP (continuum) throughput and lane-efficiency "
        "bench",
    )
    ap.add_argument(
        "--final-vpackets", type=int, default=0,
        help="also run the final-iteration bench (spectral iteration with "
        "N virtual packets per spawn record + line estimators)",
    )
    ap.add_argument(
        "--roofline", action="store_true",
        help="report K1's bound at the card's rates and its fraction of "
        "the launch's device time",
    )
    ap.add_argument(
        "--device", default=None,
        help="the device to run on (default: the card; 'cpu' runs the "
        "plain PyTorch versions); exits non-zero if the run lands on "
        "another",
    )
    args = ap.parse_args(argv)
    out = bench_transport(
        n_packets=args.packets,
        n_levels=args.levels,
        max_level_jump=args.jump,
        mode=args.mode,
        repeats=args.repeats,
        roofline=args.roofline,
        device=args.device,
    )
    parts = [out]
    if args.e2e_iters > 0:
        out["e2e"] = bench_e2e(
            n_packets=args.packets,
            n_iterations=args.e2e_iters,
            n_levels=args.levels,
            max_level_jump=args.jump,
            mode=args.mode,
            device=args.device,
        )
        out["e2e"]["ratio_vs_kernel"] = round(
            out["e2e"]["e2e_s_per_iteration"] / out["time_s"], 3
        )
        parts.append(out["e2e"])
    if args.iip:
        out["iip"] = bench_iip(device=args.device)
        parts.append(out["iip"])
    if args.final_vpackets > 0:
        out["final_iteration"] = bench_final_iteration(
            n_packets=args.packets,
            n_vpackets=args.final_vpackets,
            n_levels=args.levels,
            max_level_jump=args.jump,
            mode=args.mode,
            device=args.device,
        )
        parts.append(out["final_iteration"])
    refuse_other_device(args.device, *parts)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
