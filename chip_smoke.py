#!/usr/bin/env python3
"""Run the PyTorch port's main path on one NVIDIA GPU and check its kernels.

Usage (from the repository root, one CUDA card):  python3 chip_smoke.py

Phases, one printed line each (plus one line per iteration):
  1. header: the card (nvidia-smi), torch and CUDA versions, and the
     parallel nvcc build of every kernel in tardis_torch/csrc/;
  2. checks at the main path's shapes (bench problem: synthetic atom data
     with 200 levels and level jumps up to 60, 20 shells, macroatom): the
     chain build timed alone, and each kernel against its plain PyTorch
     version on the card (K3 line tables; K2 packet source at both packet
     counts; K1 event loop without spawn records at the convergence
     iterations' 2,097,152 packets and with them at the final iteration's
     4,194,304; K4 vpacket volley in one launch on those records), with
     CUDA-event times of both, the least time the card could take (bound)
     and, where one PyTorch call computes the same function, its time;
  3. the main path: run_tardis on the card, 4 convergence iterations of
     2,097,152 packets and the production final iteration (4,194,304
     packets, 2 virtual packets per spawn record, the formal integral at
     1,000 frequencies), with the launch counts reset to 0 just before and
     read just after;
  4. K5 (formal-integral rays) against its plain version on the main
     path's own source-function tables;
  5. where the time goes: torch.profiler over a two-iteration run of the
     main path (device time by kernel, host time by tardis.* span, the
     device's busy share);
  6. a JSON line of every kernel, the card's name and power limit, and the
     result line {"ok": true, "device": {...}}.

Any failure raises and exits non-zero before the result line.  The script
imports nothing of JAX and nothing of the JAX package.

Bounds: bytes over 3.35 TB/s (each input read once, each output written
once) against operations over 67 TFLOP/s, the H100 SXM's non-tensor f32
rate; f64 and integer operations are counted against the same rate, which
the card does not exceed for either, so the bound stays a lower bound.
Where the work depends on the data (events, segments), the count is this
run's.
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
FINAL_PACKETS = 4_194_304
N_VPACKETS = 2
INTEGRATED_POINTS = 1000
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
                   "last_no_of_packets": FINAL_PACKETS,
                   "no_of_virtual_packets": N_VPACKETS,
                   "tracking": {"track_last_interaction": False}},
    "spectrum": {"start": "500 angstrom", "stop": "20000 angstrom",
                 "num": 10000, "method": "integrated",
                 "integrated": {"points": INTEGRATED_POINTS}},
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


def check_blackbody_source(state, device, n_packets, iteration):
    """K2 at ``n_packets`` with the source key of ``iteration``."""
    from tardis_torch.transport.solver import iteration_keys
    from tardis_torch.transport.source import (
        blackbody_source,
        blackbody_source_plain,
    )

    key, _ = iteration_keys(SEED, iteration)
    args = (key, n_packets, state.t_inner, device)
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
                       n_packets * (7 * THREEFRY_OPS + 30 + 15))
    say("check_blackbody_source", n=n_packets, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, max_rel=rel, bitwise_equal=bool(
            torch.equal(mu, mu_p) and torch.equal(nu, nu_p)))
    return (mu, nu), dict(
        name="blackbody_source", route="cuda",
        source="tardis_torch/csrc/blackbody_source.cu",
        replaces="tardis_tpu/transport/source.py:31",
        max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
    )


def rel_err(a, b):
    """max |a-b| / (|b| + 1e-12 max|b|): rtol, with an atol for entries
    where terms of opposite sign cancel."""
    scale = b.abs() + 1e-12 * b.abs().max()
    return ((a - b).abs() / scale.clamp_min(1e-300)).max().item()


def sorted_rows(rows):
    """Rows of an (n, k) f32 tensor in the lexicographic order of their
    bits: a canonical order for comparing two multisets of rows."""
    bits = rows.view(torch.int32)
    idx = torch.arange(rows.shape[0], device=rows.device)
    for c in reversed(range(rows.shape[1])):
        idx = idx[torch.sort(bits[idx, c], stable=True).indices]
    return rows[idx]


def check_chain_build(atom, ps):
    """The macro-atom chain build (torch ops, not yet a kernel) timed alone
    at the main path's shapes.  Its bound: the (L, S) inputs read once and
    the two row tables written once, against the block normalisation and
    one LU solve with n right-hand sides per (shell, component), 8/3 n^3
    operations at the component's real size n."""
    from tardis_torch.opacities.macro_atom_solver import (
        chain_context,
        solve_macro_chain,
    )
    from tardis_torch.transport.tables import NU_UNIT

    args = (atom.macro_atom, ps.beta_sobolev, ps.j_blues,
            ps.stimulated_emission_factor)
    kw = dict(mode="macroatom", line_nu_scaled=atom.line_nu / NU_UNIT)
    ms, chain = cuda_ms(lambda: solve_macro_chain(*args, **kw), 10)
    ctx = chain_context(atom.macro_atom, "macroatom", atom.line_nu / NU_UNIT)
    S = ps.beta_sobolev.shape[1]
    T = atom.macro_atom.n_transitions
    lu_ops = 0.0
    for bi, meta in enumerate(ctx.bucket_meta):
        sizes = ctx.arrays_np[f"b{bi}_member_valid"].reshape(
            meta["n_cb"], meta["Wp"]).sum(axis=1).astype(np.float64)
        lu_ops += S * float((8.0 / 3.0 * sizes**3).sum())
    # ~6 operations per (transition, shell) of the normalisation, ~4 per
    # entry of the CDF rows (clamp, running sum, division)
    n_ops = lu_ops + 6.0 * T * S + 4.0 * (chain.chain_cdf.numel()
                                          + chain.emit_cdf.numel())
    b_ms, b_by = bound(nbytes(*args[1:]) + nbytes(chain.chain_cdf,
                                                  chain.emit_cdf), n_ops)
    say("chain_build", ms=ms, bound_ms=b_ms, bound_by=b_by,
        states=chain.n_states, chain_width=chain.chain_width,
        emit_width=chain.emit_width, lu_ops=lu_ops)
    return chain


def k1_bound(tables, n_packets, n_events, n_records=0):
    """Least time for K1: every table read once, outputs (spawn records
    included) written once, against the events' hashing, search and
    arithmetic.  Every event hashes at least twice (its key and the tau
    draw); interactions hash more, so counting two keeps the bound a lower
    bound."""
    t = tables
    in_bytes = 8 * n_packets + nbytes(
        t.r_inner, t.r_outer, t.chi_e, t.line_nu, t.prefix, t.line2macro,
        t.chain_cdf, t.emit_cdf)
    out_bytes = 8 * n_packets + 8 * (2 * (t.n_lines + 1) * t.n_shells
                                     + 2 * t.n_shells + 4) + 32 * n_records
    per_event = (2 * THREEFRY_OPS + 8 * math.ceil(math.log2(t.n_lines + 1))
                 + 60)
    return bound(in_bytes + out_bytes, n_events * per_event)


def compare_transport_loop(tables, pool, run_key, cap):
    """K1 against its plain version on one pool, with spawn-record capacity
    ``cap`` (0: none).  Both versions draw the same bits and take the same
    f32 steps (no FMA contraction), so every packet must end bitwise equal
    and write the same spawn records (in another order: compared as sorted
    multisets); the f64 sums differ only in the order of their atomic adds,
    hence rtol 1e-9.  Returns the phase's numbers and K1's records."""
    from tardis_torch.transport.kernel import (
        transport_loop,
        transport_loop_plain,
    )

    mu, nu = pool
    n = mu.shape[0]
    ms, k = cuda_ms(lambda: transport_loop(tables, mu, nu, run_key,
                                           vpacket_capacity=cap), 5)
    # the plain version's lockstep loop refills PLAIN_LANES lanes from the
    # pool; per-packet results do not depend on the lane count
    plain_ms, p = cuda_ms(
        lambda: transport_loop_plain(tables, mu, nu, run_key,
                                     batch_size=PLAIN_LANES,
                                     vpacket_capacity=cap), 1,
        warmup=False)
    sk = torch.sign(k.out[:, 0])
    sp = torch.sign(p.out[:, 0])
    agree = (sk == sp).double().mean().item()
    bitwise = (k.out == p.out).all(dim=1).double().mean().item()
    rels = {name: rel_err(getattr(k, name), getattr(p, name))
            for name in ("est_j", "est_nubar", "line_diff")}
    rels["L_window"] = rel_err(k.summary[0:1], p.summary[0:1])
    rels["L_reabsorbed"] = rel_err(k.summary[1:2], p.summary[1:2])
    events = k.summary[2].item(), p.summary[2].item()
    immortal = int(k.summary[3].item()), int(p.summary[3].item())
    records = int(k.vp_count[0]), int(p.vp_count[0])
    n_rec = k.n_vp_records
    rows_k = sorted_rows(k.vp_records[:n_rec])
    rows_p = sorted_rows(p.vp_records[:n_rec])
    records_equal = (records[0] == records[1]
                     and k.n_vp_records == p.n_vp_records
                     and torch.equal(rows_k, rows_p))
    if not (bitwise == 1.0 and bool((sk != 0).all())
            and all(r <= 1e-9 for r in rels.values())
            and events[0] == events[1] and immortal == (0, 0)
            and records_equal and records[0] <= cap
            and (cap == 0 or records[0] > n)):
        raise AssertionError(
            f"transport_loop at {n} packets: bitwise packets {bitwise}, "
            f"status agreement {agree}, max rel {rels}, events {events}, "
            f"immortal {immortal}, records {records} of capacity {cap}, "
            f"records equal {records_equal}")
    max_abs = max([(getattr(k, name) - getattr(p, name)).abs().max().item()
                   for name in ("out", "est_j", "est_nubar", "line_diff",
                                "summary")]
                  + ([(rows_k - rows_p).abs().max().item()] if n_rec else []))
    b_ms, b_by = k1_bound(tables, n, events[0], n_rec)
    numbers = dict(n=n, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, events=events[0], records=records[0],
                   record_capacity=cap, status_agreement=agree,
                   bitwise_packets=bitwise,
                   records_bitwise_as_multiset=records_equal, max_rel=rels,
                   max_abs_err=max_abs)
    return numbers, k.vp_records[:n_rec]


def check_transport_loop(state, atom, ps, chain, pools, device):
    """K1 at both of the main path's shapes: the convergence iterations'
    (N_PACKETS, no records) and the final iteration's (FINAL_PACKETS,
    VPACKET_RECORDS_PER_PACKET records a packet).  The kernels line takes
    the convergence shape, four of K1's five launches on the main path."""
    from tardis_torch.transport.solver import (
        VPACKET_RECORDS_PER_PACKET,
        iteration_keys,
    )
    from tardis_torch.transport.tables import build_transport_tables

    tables = build_transport_tables(
        state.geometry, ps.electron_densities, ps.tau_prefix, atom,
        "macroatom", macro_chain=chain,
    )
    _, run_key = iteration_keys(SEED, 0)
    conv, _ = compare_transport_loop(tables, pools[N_PACKETS], run_key, 0)
    say("check_transport_loop", **conv)
    _, run_key = iteration_keys(SEED, ITERATIONS - 1)
    final, records = compare_transport_loop(
        tables, pools[FINAL_PACKETS], run_key,
        VPACKET_RECORDS_PER_PACKET * FINAL_PACKETS)
    say("check_transport_loop_records", **final)
    return tables, records, dict(
        name="transport_loop", route="cuda",
        source="tardis_torch/csrc/transport_loop.cu",
        replaces="tardis_tpu/transport/kernel.py:425",
        max_abs_err=max(conv["max_abs_err"], final["max_abs_err"]),
        ms=conv["ms"], plain_ms=conv["plain_ms"], bound_ms=conv["bound_ms"],
        bound_by=conv["bound_by"], library_ms=None,
    )


def check_vpacket_volley(tables, records, device):
    """K4 on K1's spawn records at the main path's shapes (the final
    iteration's records, 2 virtual packets, 10,000 bins), one launch over
    every ray as on the main path; the plain version takes them in chunks.
    Per-ray frequencies and energies must be bitwise equal (same f32 steps,
    f64 exp); the f64 histogram differs only in the order of its adds,
    hence rtol 1e-9."""
    from tardis_torch.config.reader import config_from_dict
    from tardis_torch.spectrum.base import frequency_grid
    from tardis_torch.transport.tables import NU_UNIT
    from tardis_torch.transport.vpacket import (
        trace_vpacket_records,
        trace_vpacket_records_plain,
    )

    spec = config_from_dict(BENCH_CONFIG).spectrum
    edges = torch.as_tensor(
        (frequency_grid(spec.start, spec.stop, spec.num) / NU_UNIT)
        .astype(np.float32), device=device)
    args = (tables, records, N_VPACKETS, edges)
    ms, k = cuda_ms(lambda: trace_vpacket_records(*args), 5)
    plain_ms, p = cuda_ms(lambda: trace_vpacket_records_plain(*args), 1,
                          warmup=False)
    before = trace_vpacket_records.launches
    kr = trace_vpacket_records(*args, return_packets=True)
    launches = trace_vpacket_records.launches - before
    pr = trace_vpacket_records_plain(*args, return_packets=True)
    rays_bitwise = bool(torch.equal(kr.nu, pr.nu)
                        and torch.equal(kr.energy, pr.energy))
    rel = rel_err(k.hist, p.hist)
    segments = int(k.n_segments[0]), int(p.n_segments[0])
    if not (rays_bitwise and rel <= 1e-9 and segments[0] == segments[1]
            and k.hist.sum().item() > 0 and launches == 1):
        raise AssertionError(
            f"vpacket_volley: rays bitwise {rays_bitwise}, hist max rel "
            f"{rel}, segments {segments}, total {k.hist.sum().item()}, "
            f"launches per call {launches}")
    max_abs = (k.hist - p.hist).abs().max().item()
    R = records.shape[0]
    n_rays = R * N_VPACKETS
    M = edges.shape[0] - 1
    # per segment: a ~log2(L)-probe search (~4 operations a probe) and ~30
    # operations of geometry and tau; per ray: ~40 operations of direction,
    # weight and Doppler factors, the f64 exp, and a log2(M)-probe bin search
    n_ops = (segments[0] * (4 * math.ceil(math.log2(tables.n_lines + 1))
                            + 30)
             + n_rays * (4 * math.ceil(math.log2(M + 1)) + 40))
    in_bytes = nbytes(records, tables.r_inner, tables.r_outer, tables.chi_e,
                      tables.line_nu, tables.prefix, edges)
    b_ms, b_by = bound(in_bytes + nbytes(k.hist), n_ops)
    say("check_vpacket_volley", records=R, rays=n_rays, bins=M,
        segments=segments[0], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, kernel_launches=launches,
        plain_chunks=math.ceil(n_rays / 8_388_608),
        rays_bitwise=rays_bitwise, hist_max_rel=rel, max_abs_err=max_abs)
    return dict(
        name="vpacket_volley", route="cuda",
        source="tardis_torch/csrc/vpacket_volley.cu",
        replaces="tardis_tpu/transport/vpacket.py:224",
        max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
    )


def check_formal_integral(sim, device):
    """K5 on the main path's own source-function tables (1,000 frequencies
    x 80 impact parameters).  Same f32 steps in both versions, so I p must
    be bitwise equal, with equal event counts and no capped ray."""
    from tardis_torch.spectrum.formal_integral import (
        COUNT_CAPPED,
        FormalIntegralSolver,
        integrate_rays,
        integrate_rays_plain,
    )

    inputs = FormalIntegralSolver(n_points=INTEGRATED_POINTS).ray_inputs(
        sim.spectrum_nu_edges, sim.state, sim.plasma_state,
        sim.last_transport_result, sim.atom_data, "macroatom", device)
    a = inputs.tensors
    ms, k = cuda_ms(lambda: integrate_rays(**a), 5)
    plain_ms, p = cuda_ms(lambda: integrate_rays_plain(**a), 1, warmup=False)
    bitwise = bool(torch.equal(k.i_p, p.i_p))
    counts = k.counts.tolist(), p.counts.tolist()
    if not (bitwise and counts[0] == counts[1]
            and counts[0][COUNT_CAPPED] == 0
            and bool(torch.isfinite(k.i_p).all())):
        raise AssertionError(
            f"formal_integral: bitwise {bitwise}, counts {counts}, "
            f"max abs {(k.i_p - p.i_p).abs().max().item()}")
    max_abs = (k.i_p - p.i_p).abs().max().item()
    F, P = k.i_p.shape
    S, L = a["exp_tau"].shape
    n_line, n_boundary, _ = counts[0]
    # ~16 f32 operations per line event (zeta, J average, e-scatter source,
    # attenuation), ~20 per boundary event (two sqrt, the source), and the
    # start-line search
    n_ops = (16 * n_line + 20 * n_boundary
             + F * P * 4 * math.ceil(math.log2(L + 1)))
    b_ms, b_by = bound(nbytes(*a.values()) + nbytes(k.i_p), n_ops)
    say("check_formal_integral", frequencies=F, impact_parameters=P,
        lines=L, shells=S, line_events=n_line, boundary_events=n_boundary,
        capped=counts[0][COUNT_CAPPED], ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, bitwise=bitwise, max_abs_err=max_abs)
    return dict(
        name="formal_integral", route="cuda",
        source="tardis_torch/csrc/formal_integral.cu",
        replaces="tardis_tpu/spectrum/formal_integral.py:137",
        max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
    )


def run_main_path(atom, device):
    from tardis_torch.plasma.line_tables import line_tables
    from tardis_torch.simulation.base import run_tardis
    from tardis_torch.spectrum.formal_integral import integrate_rays
    from tardis_torch.transport.kernel import transport_loop
    from tardis_torch.transport.source import blackbody_source
    from tardis_torch.transport.vpacket import trace_vpacket_records

    wrappers = {"line_tables": line_tables,
                "blackbody_source": blackbody_source,
                "transport_loop": transport_loop,
                "vpacket_volley": trace_vpacket_records,
                "formal_integral": integrate_rays}
    marks = []

    def on_iteration(sim):
        torch.cuda.synchronize()
        now = time.perf_counter()
        res = sim.last_transport_result
        ratio = (res.emitted_luminosity(*sim._lum_nu_window())
                 / sim.state.luminosity_requested)
        say("iteration", index=sim.iterations_executed - 1,
            packets=res.n_packets, wall_s=now - marks[-1],
            t_inner=sim.state.t_inner, L_emitted_over_requested=ratio,
            events=res.n_events, vp_records=res.vp_records)
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
    spectra = {"real": sim.spectrum_real, "virtual": sim.spectrum_virtual,
               "integrated": sim.spectrum_integrated}
    finite = bool(
        all(s is not None and np.isfinite(s.luminosity_nu).all()
            for s in spectra.values())
        and np.isfinite(res.output_nu).all()
        and all(np.isfinite(h.t_radiative).all()
                and np.isfinite(h.dilution_factor).all()
                for h in sim.history))
    lum = {k: s.luminosity for k, s in spectra.items() if s is not None}
    virt_ratio = lum.get("virtual", np.nan) / lum["real"]
    int_ratio = lum.get("integrated", np.nan) / lum["real"]
    n_total = sim.no_of_packets * (ITERATIONS - 1) + sim.last_no_of_packets
    say("main_path", wall_s=wall, packets=n_total,
        packets_per_s=n_total / wall, launches=launches,
        final_L_emitted_over_requested=final_ratio,
        spectrum_bins=int(sim.spectrum_real.luminosity_nu.size),
        luminosity=lum, virtual_over_real=virt_ratio,
        integrated_over_real=int_ratio, vp_records=res.vp_records,
        finite=finite, immortal=res.n_immortal)
    if not finite:
        raise AssertionError("main path produced non-finite values or "
                             "lacks a spectrum")
    if not 0.8 <= final_ratio <= 1.2:
        raise AssertionError(f"final L_emitted/L_requested {final_ratio}")
    if not 0.85 <= virt_ratio <= 1.18:
        raise AssertionError(f"virtual / real luminosity {virt_ratio}")
    if not 0.7 <= int_ratio <= 1.4:
        raise AssertionError(f"integrated / real luminosity {int_ratio}")
    if not (launches["line_tables"] >= ITERATIONS
            and launches["blackbody_source"] == ITERATIONS
            and launches["transport_loop"] == ITERATIONS
            and launches["vpacket_volley"] == 1
            and launches["formal_integral"] == 1):
        raise AssertionError(f"kernel launches {launches}")
    return sim, launches


def profile_main_path(atom, device):
    """Where the time goes in a short run of the main path (one convergence
    iteration and the final one): device time by kernel, host time by
    tardis.* span, and the device's busy share."""
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
        device_ms_by_kernel=[[k[:80], ms, n] for k, ms, n in kernels[:24]],
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
        pools = {}
        pools[N_PACKETS], k2 = check_blackbody_source(state, device,
                                                      N_PACKETS, 0)
        pools[FINAL_PACKETS], _ = check_blackbody_source(
            state, device, FINAL_PACKETS, ITERATIONS - 1)
        chain = check_chain_build(atom, ps)
        tables, records, k1 = check_transport_loop(state, atom, ps, chain,
                                                   pools, device)
        k4 = check_vpacket_volley(tables, records, device)
        say("kernel_checks", wall_s=time.perf_counter() - t)
        del ps, pools, chain, tables, records
        torch.cuda.empty_cache()
        sim, launches = run_main_path(atom, device)
        k5 = check_formal_integral(sim, device)
        del sim
        torch.cuda.empty_cache()
        profile_main_path(atom, device)
    kernels = [k1, k2, k3, k4, k5]
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
