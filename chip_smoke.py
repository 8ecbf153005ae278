#!/usr/bin/env python3
"""Run the PyTorch port's main path on one NVIDIA GPU and check its kernels.

Usage (from the repository root, one CUDA card):  python3 chip_smoke.py

Phases, one printed line each (plus one line per iteration):
  1. header: the card (nvidia-smi), torch and CUDA versions, and the
     parallel nvcc build of every kernel in tardis_torch/csrc/;
  2. kernel checks at the main path's shapes (bench problem: synthetic atom
     data with 200 levels and level jumps up to 60, 20 shells, macroatom):
     each kernel against its plain PyTorch version on the card, with
     CUDA-event times of both, the least time the card could take (bound)
     and, where one PyTorch call computes the same function, its time;
  3. the main path: run_tardis on the card, 2,097,152 packets x 5 iterations
     (4 convergence + the final one), with the launch counts reset to 0
     just before and read just after;
  4. where the time goes: torch.profiler over a two-iteration run of the
     main path (device time by kernel, host time by tardis.* span, the
     device's busy share);
  5. a JSON line of every kernel, the card's name and power limit, and the
     result line {"ok": true, "device": {...}}.

Any failure raises and exits non-zero before the result line.  The script
imports nothing of JAX and nothing of the JAX package.

Bounds: bytes over 3.35 TB/s (each input read once, each output written
once) against operations over 67 TFLOP/s, the H100 SXM's non-tensor f32
rate; f64 and integer operations are counted against the same rate, which
the card does not exceed for either, so the bound stays a lower bound.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
THREEFRY_OPS = 120  # 20 rounds of add/rotate/xor plus 6 key injections

N_PACKETS = 2_097_152
PLAIN_LANES = 65_536
PROFILE_ITERATIONS = 2
ITERATIONS = 5
SEED = 23111963

BENCH_CONFIG = {
    "supernova": {"luminosity_requested": "9.44 log_lsun",
                  "time_explosion": "13 day"},
    "model": {"structure": {"type": "specific",
                            "velocity": {"start": "1.1e4 km/s",
                                         "stop": "20000 km/s", "num": 20},
                            "density": {"type": "branch85_w7"}},
              "abundances": {"type": "uniform", "O": 0.19, "Mg": 0.03,
                             "Si": 0.52, "S": 0.19, "Ar": 0.04,
                             "Ca": 0.03}},
    "plasma": {"line_interaction_type": "macroatom"},
    "montecarlo": {"seed": SEED, "no_of_packets": N_PACKETS,
                   "iterations": ITERATIONS,
                   "last_no_of_packets": N_PACKETS,
                   "no_of_virtual_packets": 0,
                   "tracking": {"track_last_interaction": False}},
    "spectrum": {"start": "500 angstrom", "stop": "20000 angstrom",
                 "num": 10000},
}


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, reps, warmup=True):
    """Median CUDA-event milliseconds of ``fn`` over ``reps`` runs (after
    one warm-up run unless ``warmup`` is false); returns (ms, last result)."""
    if warmup:
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), out


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def build_problem(device):
    from tardis_torch.atomic.synthetic import make_synthetic_atom_data
    from tardis_torch.config.reader import config_from_dict
    from tardis_torch.model.state import SimulationState

    config = config_from_dict(BENCH_CONFIG)
    state = SimulationState.from_config(config)
    atom = make_synthetic_atom_data(n_levels=200, max_level_jump=60).prepare(
        selected_atoms=[8, 12, 14, 16, 18, 20],
        line_interaction_type="macroatom",
    )
    return config, state, atom


def check_line_tables(state, atom, device):
    from tardis_torch.plasma.line_tables import line_tables, line_tables_plain
    from tardis_torch.plasma.solver import PlasmaSolver

    solver = PlasmaSolver(atom, state, device)
    ps = solver.update(state.t_radiative, state.dilution_factor)
    pop = torch.as_tensor(ps.level_number_density, device=device)
    args = (solver.line_static, pop, state.t_radiative,
            state.dilution_factor, state.time_explosion)
    ms, k = cuda_ms(lambda: line_tables(*args), 10)
    plain_ms, p = cuda_ms(lambda: line_tables_plain(*args), 5)
    max_abs = 0.0
    for name in ("stim", "tau", "beta", "j_blues"):
        a, b = getattr(k, name), getattr(p, name)
        rel = ((a - b).abs() / b.abs().clamp_min(1e-300)).max().item()
        if not (rel <= 1e-12):
            raise AssertionError(f"line_tables {name}: max rel {rel}")
        max_abs = max(max_abs, (a - b).abs().max().item())
    rel = ((k.prefix - p.prefix).abs()
           / p.prefix.abs().clamp_min(1e-300)).max().item()
    if not (rel <= 1e-10):
        raise AssertionError(f"line_tables prefix: max rel {rel}")
    max_abs = max(max_abs, (k.prefix - p.prefix).abs().max().item())
    # the prefix alone, as one PyTorch scan in the (S, L) layout K3 writes
    tau_sl = k.tau.T
    library_ms, _ = cuda_ms(
        lambda: torch.cumsum(tau_sl, dim=1, dtype=torch.float64), 10)
    st = solver.line_static
    L, S = k.tau.shape
    in_bytes = nbytes(pop, st.lower_idx, st.upper_idx, st.g_lower,
                      st.g_upper, st.wl_flu, st.line_nu, st.nu3_coef) + 16 * S
    out_bytes = nbytes(k.stim, k.tau, k.beta, k.j_blues, k.prefix)
    # ~55 f64 operations per element (ratio, stim, tau, two expm1 and the
    # beta / j_blues branches) plus one add of the scan
    b_ms, b_by = bound(in_bytes + out_bytes, L * S * 56)
    say("check_line_tables", L=L, S=S, ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=b_ms, max_abs_err=max_abs)
    return ps, dict(
        name="line_tables", route="cuda",
        source="tardis_torch/csrc/line_tables.cu",
        replaces="tardis_tpu/plasma/device_line.py:163",
        max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=library_ms,
    )


def check_blackbody_source(state, device):
    from tardis_torch.transport.solver import iteration_keys
    from tardis_torch.transport.source import (
        blackbody_source,
        blackbody_source_plain,
    )

    key, _ = iteration_keys(SEED, 0)
    args = (key, N_PACKETS, state.t_inner, device)
    ms, (mu, nu) = cuda_ms(lambda: blackbody_source(*args), 10)
    plain_ms, (mu_p, nu_p) = cuda_ms(lambda: blackbody_source_plain(*args), 3)
    rel = max(((mu - mu_p).abs() / mu_p.abs().clamp_min(1e-30)).max().item(),
              ((nu - nu_p).abs() / nu_p.abs().clamp_min(1e-30)).max().item())
    if not (rel <= 1e-6):
        raise AssertionError(f"blackbody_source: max rel {rel}")
    max_abs = max((mu - mu_p).abs().max().item(),
                  (nu - nu_p).abs().max().item())
    # per packet: 7 threefry hashes, a ~10-step search, ~15 flops
    b_ms, b_by = bound(nbytes(mu, nu) + 999 * 4,
                       N_PACKETS * (7 * THREEFRY_OPS + 30 + 15))
    say("check_blackbody_source", n=N_PACKETS, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, max_rel=rel, bitwise_equal=bool(
            torch.equal(mu, mu_p) and torch.equal(nu, nu_p)))
    return (mu, nu), dict(
        name="blackbody_source", route="cuda",
        source="tardis_torch/csrc/blackbody_source.cu",
        replaces="tardis_tpu/transport/source.py:31",
        max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
    )


def k1_bound(tables, n_packets, n_events):
    """Least time for K1: every table read once, outputs written once,
    against the events' hashing, search and arithmetic.  Every event hashes
    at least twice (its key and the tau draw); interactions hash more, so
    counting two keeps the bound a lower bound."""
    t = tables
    in_bytes = 8 * n_packets + nbytes(
        t.r_inner, t.r_outer, t.chi_e, t.line_nu, t.prefix, t.line2macro,
        t.chain_cdf, t.emit_cdf)
    out_bytes = 8 * n_packets + 8 * (2 * (t.n_lines + 1) * t.n_shells
                                     + 2 * t.n_shells + 4)
    per_event = (2 * THREEFRY_OPS + 8 * math.ceil(math.log2(t.n_lines + 1))
                 + 60)
    return bound(in_bytes + out_bytes, n_events * per_event)


def check_transport_loop(state, atom, ps, pool, device):
    from tardis_torch.opacities.macro_atom_solver import solve_macro_chain
    from tardis_torch.transport.kernel import (
        transport_loop,
        transport_loop_plain,
    )
    from tardis_torch.transport.solver import iteration_keys
    from tardis_torch.transport.tables import NU_UNIT, build_transport_tables

    chain = solve_macro_chain(
        atom.macro_atom, ps.beta_sobolev, ps.j_blues,
        ps.stimulated_emission_factor, mode="macroatom",
        line_nu_scaled=atom.line_nu / NU_UNIT,
    )
    tables = build_transport_tables(
        state.geometry, ps.electron_densities, ps.tau_prefix, atom,
        "macroatom", macro_chain=chain,
    )
    _, run_key = iteration_keys(SEED, 0)
    mu, nu = pool
    ms, k = cuda_ms(lambda: transport_loop(tables, mu, nu, run_key), 5)
    # the plain version's lockstep loop refills PLAIN_LANES lanes from the
    # pool; per-packet results do not depend on the lane count
    plain_ms, p = cuda_ms(
        lambda: transport_loop_plain(tables, mu, nu, run_key,
                                     batch_size=PLAIN_LANES), 1,
        warmup=False)
    # Both versions draw the same bits and take the same f32 steps (no FMA
    # contraction), so every packet must end bitwise equal; the f64 sums
    # differ only in the order of their atomic adds, hence rtol 1e-9.
    sk = torch.sign(k.out[:, 0])
    sp = torch.sign(p.out[:, 0])
    agree = (sk == sp).double().mean().item()
    bitwise = (k.out == p.out).all(dim=1).double().mean().item()

    def rel(a, b):
        """max |a-b| / (|b| + 1e-12 max|b|): rtol, with an atol for
        entries where +w and -w of different packets cancel."""
        scale = b.abs() + 1e-12 * b.abs().max()
        return ((a - b).abs() / scale.clamp_min(1e-300)).max().item()

    rels = {name: rel(getattr(k, name), getattr(p, name))
            for name in ("est_j", "est_nubar", "line_diff")}
    rels["L_window"] = rel(k.summary[0:1], p.summary[0:1])
    rels["L_reabsorbed"] = rel(k.summary[1:2], p.summary[1:2])
    events = k.summary[2].item(), p.summary[2].item()
    immortal = int(k.summary[3].item()), int(p.summary[3].item())
    if not (bitwise == 1.0 and bool((sk != 0).all())
            and all(r <= 1e-9 for r in rels.values())
            and events[0] == events[1] and immortal == (0, 0)):
        raise AssertionError(
            f"transport_loop: bitwise packets {bitwise}, status agreement "
            f"{agree}, max rel {rels}, events {events}, immortal {immortal}")
    max_abs = max((getattr(k, n) - getattr(p, n)).abs().max().item()
                  for n in ("out", "est_j", "est_nubar", "line_diff",
                            "summary"))
    n_events = events[0]
    b_ms, b_by = k1_bound(tables, N_PACKETS, n_events)
    say("check_transport_loop", n=N_PACKETS, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, events=n_events,
        status_agreement=agree, bitwise_packets=bitwise, max_rel=rels,
        max_abs_err=max_abs)
    return dict(
        name="transport_loop", route="cuda",
        source="tardis_torch/csrc/transport_loop.cu",
        replaces="tardis_tpu/transport/kernel.py:425",
        max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
    )


def run_main_path(atom, device):
    from tardis_torch.plasma.line_tables import line_tables
    from tardis_torch.simulation.base import run_tardis
    from tardis_torch.transport.kernel import transport_loop
    from tardis_torch.transport.source import blackbody_source

    wrappers = {"line_tables": line_tables,
                "blackbody_source": blackbody_source,
                "transport_loop": transport_loop}
    marks = []

    def on_iteration(sim):
        torch.cuda.synchronize()
        now = time.perf_counter()
        res = sim.last_transport_result
        ratio = (res.emitted_luminosity(*sim._lum_nu_window())
                 / sim.state.luminosity_requested)
        say("iteration", index=sim.iterations_executed - 1,
            wall_s=now - marks[-1], t_inner=sim.state.t_inner,
            L_emitted_over_requested=ratio, events=res.n_events)
        marks.append(now)

    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks.append(t0)
    sim = run_tardis(BENCH_CONFIG, atom_data=atom, device=device,
                     callbacks=[on_iteration])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}

    res = sim.last_transport_result
    final_ratio = (res.emitted_luminosity(*sim._lum_nu_window())
                   / sim.state.luminosity_requested)
    spec = sim.spectrum_real.luminosity_nu
    finite = bool(np.isfinite(spec).all() and np.isfinite(res.output_nu).all()
                  and all(np.isfinite(h.t_radiative).all()
                          and np.isfinite(h.dilution_factor).all()
                          for h in sim.history))
    n_total = sim.no_of_packets * (ITERATIONS - 1) + sim.last_no_of_packets
    say("main_path", wall_s=wall, packets=n_total,
        packets_per_s=n_total / wall, launches=launches,
        final_L_emitted_over_requested=final_ratio,
        spectrum_bins=int(spec.size), finite=finite,
        immortal=res.n_immortal)
    expected = {"line_tables": ITERATIONS, "blackbody_source": ITERATIONS,
                "transport_loop": ITERATIONS}
    if not finite:
        raise AssertionError("main path produced non-finite values")
    if not 0.8 <= final_ratio <= 1.2:
        raise AssertionError(f"final L_emitted/L_requested {final_ratio}")
    if launches["line_tables"] < expected["line_tables"] or any(
            launches[k] != expected[k]
            for k in ("blackbody_source", "transport_loop")):
        raise AssertionError(f"kernel launches {launches}, want {expected}")
    return launches


def profile_main_path(atom, device):
    """Where the time goes in a short run of the main path: device time by
    kernel, host time by tardis.* span, and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    from tardis_torch.simulation.base import run_tardis

    config = copy.deepcopy(BENCH_CONFIG)
    config["montecarlo"]["iterations"] = PROFILE_ITERATIONS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_tardis(config, atom_data=atom, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device rows: kernels and copies (the spans' device-side twins and
    # host operators that launched kernels are left out, so nothing counts
    # twice); host rows: the tardis.* spans
    events = prof.key_averages()
    on_device = torch.autograd.DeviceType.CUDA
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in events
         if e.device_type == on_device and not e.key.startswith("tardis.")),
        key=lambda r: -r[1])
    spans = sorted(
        ((e.key, e.cpu_time_total / 1e3, e.count) for e in events
         if e.device_type != on_device and e.key.startswith("tardis.")),
        key=lambda r: -r[1])
    device_ms = sum(ms for _, ms, _ in kernels)
    say("profile", iterations=PROFILE_ITERATIONS, wall_ms=wall * 1e3,
        device_busy_ms=device_ms, device_busy_share=device_ms / (wall * 1e3),
        device_ms_by_kernel=[[k[:80], ms, n] for k, ms, n in kernels[:12]],
        host_ms_by_span=[[k, ms, n] for k, ms, n in spans])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tardis_torch import cuda

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    build_s = cuda.build()
    ptxas = {name: [ln.strip() for ln in
                    (cuda.BUILD / f"{name}.log").read_text().splitlines()
                    if "registers" in ln or "spill" in ln]
             for name in cuda.KERNELS
             if (cuda.BUILD / f"{name}.log").exists()}
    say("header", card=card, torch=torch.__version__,
        cuda=torch.version.cuda, build_s=build_s, ptxas=ptxas)

    t = time.perf_counter()
    config, state, atom = build_problem(device)
    say("problem", lines=atom.n_lines, levels=atom.n_levels,
        shells=state.no_of_shells, setup_s=time.perf_counter() - t)
    with torch.no_grad():
        t = time.perf_counter()
        ps, k3 = check_line_tables(state, atom, device)
        pool, k2 = check_blackbody_source(state, device)
        k1 = check_transport_loop(state, atom, ps, pool, device)
        say("kernel_checks", wall_s=time.perf_counter() - t)
        del ps, pool
        launches = run_main_path(atom, device)
        profile_main_path(atom, device)
    kernels = [k1, k2, k3]
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
