#!/usr/bin/env python3
"""Run the PyTorch port's paths on one NVIDIA GPU and check its kernels.

Usage (from the repository root, one CUDA card):  python3 chip_smoke.py

Phases, one printed line each (plus one line per iteration):
  0. hdf_loader: whether h5py and pandas import here, which decides how
     the walk path takes its atomic data (a carsus file through
     atom_data_from_hdf, else atom_data_from_arrays) and whether the
     cli_path runs its HDF step (--hdf, a checkpoint and a resume), and
     the import that failed;
  1. header: the card (nvidia-smi), torch and CUDA versions, the rates of
     the bounds (the integer rate read from the card), and the
     parallel nvcc build of the kernel libraries in tardis_torch/csrc/
     without options (K2, K3, K5 and the probe's three kernels);
  2. checks at the paths' shapes (bench problem: synthetic atom data
     with 200 levels and level jumps up to 60, 20 shells, macroatom): K8,
     the macro-atom chain build (check_chain_build: each instantiation,
     the cluster one and downbranch at 20 and at 100 shells, the
     large-system one on three 600-level components at 4 shells (12
     systems) and on the large-ion problem at 20 (360), and a mixed build
     of both (two launches), with the plans and ptxas's report; the
     chain rows within 1e-6 and the emission rows within 2.4e-7 of the
     plain version with the shares bit for bit, the copied columns bit for
     bit, two calls bit for bit, beside one torch.linalg.solve a
     component size of the same systems; the large-system one forced on
     the bench build bit for bit the cluster one's tables; and a singular
     component's rows the plain version's self-deactivation step), and
     each kernel
     against its plain PyTorch
     version on the card, with CUDA-event times of both, the least time the
     card could take (bound) and, where one PyTorch call computes the same
     function, its time.  The probe kernels (check_probe2: scale2,
     take_1d, take_along_rows, bitwise at the probe's shapes and at one
     large shape each; take_1d also after an L2 flush, beside the launch
     floor, its bound the 32-byte sectors its indices touch; scale2 in
     turns with torch.mul); K3 line tables (bitwise equal run to run, timed
     as device time of queued calls and with the host's launch work,
     beside torch.cumsum of its prefix both ways; then at 100 and 200
     shells, the bench lines with the shells repeated, past one block's
     chunk of 87 shells and past the 128 shells whose inputs go by value:
     against the plain version, bitwise run to run and bitwise equal to
     the 20-shell run in each repeated shell); K3's estimators
     instantiation (detailed radiative rates) on a seeded stand-in for
     the estimator j_blues with zeros in ~30% of its entries, at the bench
     shape and at 100 and 200 shells: bitwise equal to the default
     instantiation with the select applied (torch.where, also its
     library_ms), bitwise run to run, against its plain version (the
     estimator entries bit for bit); K2's three pools at 1,048,576,
     2,097,152 and 4,194,304 packets (check_pools: mu, nu and w bit for
     bit against the plain version, the weighted pool's w also from run
     to run; its kernels alone from the profiler, kernel_ms, one launch a
     call with no other device record; device time of queued calls,
     device_ms, with held true: no call synchronises; host microseconds a
     call; the hashes and the instructions a packet must issue, all and
     by pipe, read from the SASS, a k2_sass line, and the bound they give,
     sass_bound, beside the earlier hash bound); then the K1 and
     K4 instantiations the paths select (kernel.variant and
     vpacket.variant_name on the tables and pools built here, the two
     continuum K1 instantiations of the IIP paths included), built in
     parallel, and K1 at each path's shapes: the convergence iterations'
     2,097,152 packets without spawn records or line estimators and the
     final iteration's with line estimators (on the main, relativity and
     v_inner paths 4,194,304 packets with 8 records a packet; on the main path
     also at 2,097,152 without records, the detailed_nlte path's
     convergence shape), each timed as CUDA
     events around each call (ms) and as device time of queued calls
     (device_ms), with its per-packet event distribution and the lane
     efficiency a layout of one thread a packet would have (from the plain
     version's counts); K4 in one launch on each path's final-iteration
     records (ms, device_ms, segments a ray, the record of the ray with
     the most segments alone as floor_ms, and the line list's bucket
     table: entries, bytes, lines a bucket);
     then the sharding of parallel/transport.py on this one card
     (check_sharded_transport): the main path's convergence K1 over 1, 2
     and 4 shards (cuda:0 repeated) against one device, the final
     iteration's records over 2 shards, and _final_reduce timed alone;
     then K1's RNG-walk instantiations (check_walk_loop, WALK_CASES:
     macroatom without line estimators at 2,097,152, with them and 8
     records a packet at 4,194,304, downbranch at 2,097,152, on the walk
     tables of solve_macro_state) bit for bit against their plain
     version as the chain's are, and a walk line (jumps a macro-atom
     event, mean and max, the share of walks at the 40-jump cap, the
     walk tables' bytes and build ms); then the large-prefix list
     (check_large_prefix: tests/test_full_e2e.py's 105,948 lines from the
     port's generator, shell 0's prefix 1.42e9; 65,536 packets at 5
     t_inner, both sides stopped at IIP_EVENT_CAP events): K1's chain and
     walk instantiations of the final iteration, and the relativity
     path's (its margin guard's fallbacks counted), and K4 on their
     records, each bitwise against its plain version, one large_prefix
     line a sampler;
  3. the IIP paths' kernels (the JAX package's IIP problem: H / He, H I
     continua, 20 shells, 1,048,576 packets): K3 at its line tables, K2's
     relativistic pool at 1,048,576, and each continuum K1 instantiation
     (the IIP path's, and one with the two-photon and adiabatic channels,
     boosted so both fire) timed uncapped as the path runs it (one
     launch of the persistent grid), with its per-packet event
     distribution, in both table placements (shared and device memory),
     bitwise per packet against each other, the racing moment and
     free-free sums within a bound derived from their term counts
     (summation_bound); against its plain version
     with both stopped at IIP_EVENT_CAP events a packet; and the longest
     packet alone, the floor of any schedule; and the IIP path's over 2
     shards against one device
     (check_sharded_continuum, the same cap); then K7
     (nonhomologous event loop) on the bench problem under the perturbed
     velocity law of the JAX package's end-to-end test, in scatter and in
     macroatom mode (the RNG-walk macro atom) with last-interaction rows
     and without line estimators at 2,097,152 packets and, macroatom, with
     them at 4,194,304, bitwise against its plain version (ms, device_ms,
     the event distribution and lane efficiency as for K1, and the events
     whose line the JAX package's count search took), and in scatter
     mode under the homologous law against K1 (status agreement >= 0.999);
     and K6 (gamma-ray step) on a pool of 4,194,304 packets for one step
     in each of its four instantiations, bitwise against its plain version,
     with every packet in flight and with the gamma path's first- and
     last-step shares in flight (0.8% and 4.5%, scattered), and with none
     (the step's fixed cost);
  4. the main path: run_tardis on the card, 4 convergence iterations of
     2,097,152 packets and the production final iteration (4,194,304
     packets, 2 virtual packets per spawn record, the formal integral at
     1,000 frequencies), tracking off as bench.py runs it; then the
     sharded path, the same run with device=[card, card] (K1 twice an
     iteration; each iteration replayed on one device from the same
     inputs, bitwise per packet; t_inner, t_rad and the luminosities
     within 1e-5 of the main path's separate run); then the large-ion
     path, the main path's run without the formal integral on the
     large-ion problem's atomic data (the bench elements with 600 levels
     and level jumps up to 60: 18 components of 600 levels, 615,060
     lines), whose 5 chain builds take K8's large-system instantiation and
     never the cluster one, the luminosity and virtual / real bands held;
     then the detailed_nlte
     path, the main path with radiative_rates_type: detailed and Si II
     in NLTE (K1 with line estimators in all 5 iterations, K3's
     estimators instantiation in the 4 solves after a convergence
     iteration), each iteration line with the NLTE solve's host seconds
     and the estimator readback's ms, the bands of PERF.md section 2;
  5. the relativity path: the same run with enable_full_relativity and
     last-interaction tracking at its default (on), so the relativistic
     pool, K1's full-relativity instantiation with last-interaction rows
     and K4's full-relativity branch; a line with the searches K1's
     margin guard sent to the bisection in each launch;
  6. the options path: 3 iterations of 2,097,152 packets with the weighted
     pool, the reflective inner boundary (albedo 0.5) and the r-packet
     tracker, then an "rpacket" line: RPacketPlotter's coordinates of 15
     tracked packets taken in torch on the card and padded to one length
     (packets, the padded length m, the data-prep seconds on the host
     clock after a synchronize), every coordinate finite and within the
     outer shell's velocity (relative 1e-6), and the figure where plotly
     (the animated one) or matplotlib imports; then the walk path: the
     bench problem's atomic data written with the port's carsus writer to
     a temporary file and read back with atom_data_from_hdf (every array
     equal to the written one), and
     Simulation.from_config with atom_data: <that file> and
     sim.transport.use_macro_chain = False, 2 convergence iterations of
     2,097,152 packets and the production final iteration (K1's walk
     instantiations, K4, K5), the bands of PERF.md section 2 held; then
     the helium path at reduced depth: the bench problem's elements with
     He (synthetic data, 200 levels, jumps up to 60), recomb-nlte over 2
     convergence iterations of 2,097,152 packets and a final one of
     4,194,304 without virtual packets, then numerical-nlte with a
     heating-rate file written here over one convergence iteration, each
     with the helium solve's host seconds; then the model-file path:
     run_tardis on a YAML whose csvy_model is a csvy written here (20
     shells over 1.1e4-2e4 km/s, branch85_w7 density tabulated at 1 day,
     O / Mg outside, Si / S / Ar / Ca in the middle, Ni56 0.6 in the
     inner 5 shells falling to 0 by shell 10 and a small Co56 column,
     isotopes at 0 days, read at 13 days), on the bench problem's
     synthetic data with Fe / Co / Ni (200 levels, jumps up to 60, ~2.7e5
     lines), 2 convergence iterations of 2,097,152 packets and the
     production final iteration: shell 0's decayed Ni / Co / Fe
     fractions (Ni held to the Bateman solution), K1-K5 launched, the
     bands of PERF.md section 2; then the cli_path:
     tardis_torch.cli.main in this process with no --device (so on the
     card) on a YAML naming a CMFGEN model of O-Ca written here
     (structure type file, v_inner_boundary 11,700 km/s: shell 0 dropped,
     shell 1 trimmed) on the default synthetic data, one convergence
     iteration and a final one of 2,097,152 packets, --spectrum-kind
     virtual: exit code 0, K1-K4 launched, the spectrum file finite and
     equal row for row to the run's virtual spectrum, 19 shells; where
     h5py imports, --hdf (read back) and a run checkpointed every
     iteration, stopped after its first and resumed from the file,
     within 1e-5 of the uninterrupted run in t_rad, W and t_inner, else
     a line "hdf: skipped, <the failed import>"; then the v_inner path:
     InnerVelocitySolverWorkflow with no device on the bench problem,
     the target tau the first solve's Rosseland profile at shell 5
     (printed), 3 convergence iterations of 2,097,152 packets, each
     moving the inner boundary (one line each: v_inner, t_inner,
     get_tau_integ's CUDA-event ms), and the final iteration of
     4,194,304 packets with 2 virtual packets and last-interaction rows,
     no formal integral (K1's two last-interaction instantiations, K2,
     K3, K4): the boundary moved and stayed inside the grid, the
     virtual / real band; where matplotlib imports, a ConvergencePlots
     frame an iteration in a temporary directory, else a line "plots:
     skipped, <the failed import>"; then the analysis of its final
     simulation: get_tau_integ and OpacityCalculator (300 bins) within
     1e-10 of a host numpy f64 evaluation of the same tables,
     LastLineInteraction's line counts and (in, out) pairs in two
     windows and both filter modes equal to a host numpy count over the
     rows, and, where pandas imports, the DataFrames of
     LastLineInteraction, LineInfo, shell_info_table and
     ion_fraction_table held to the same counts, each call's ms; then
     the grid path: TardisGrid.from_axes on the bench data over 10 and
     13 days x 15 and 20 shells with no device, each row 1 + 1
     iterations of 1,048,576 packets (one line a row: wall, t_inner,
     launches, torch.cuda.max_memory_allocated);
  7. the IIP path: TypeIIPWorkflow on the IIP problem, 3 convergence
     iterations of 1,048,576 packets, each with its thermal balance (25
     evaluations at most), and the final iteration; per iteration its
     wall, thermal-balance host time, K1 milliseconds and luminosity;
     then the IIP options path, 2 iterations with the two-photon and
     adiabatic-cooling channels on; the iip_vpacket path: TypeIIPWorkflow
     for one iteration, then its TransportSolver.run_iteration with the
     workflow's continuum state and Markov macro atom and 2 virtual
     packets a record (K1's continuum records instantiation, checked
     before in check_continuum_records: timed uncapped at 1,048,576,
     nearly every attempt past the capacity; capped at IIP_EVENT_CAP
     against the plain version, every packet bitwise, the attempts
     exactly and the capacity's rows kept; on the records problem, the
     IIP problem at 1.6e4-2.6e4 km/s and 14 days with 32 rows a packet
     so that every record fits, the records bitwise as a multiset; K4
     on its records), then
     run_tardis with continuum species (the classic loop, 2 iterations
     of 1,048,576 with virtual packets and their logging), each part's
     wall, the kept rows by li_type, and the visualization modules' data
     preparation on the card's result (SDEC in both modes, LIV,
     Grotrian; the figures where matplotlib imports, else "plots:
     skipped, ..."; their plotly figures, SDEC of the virtual packets,
     with each figure's trace count where plotly and matplotlib import,
     else "plotly: skipped, ..."); the nonhomologous path,
     NonhomologousTARDISWorkflow on the bench problem under the perturbed
     law, 4 convergence iterations of 2,097,152 packets and a final one of
     4,194,304 (real-packet spectrum); the gamma-ray path,
     TARDISHEWorkflow on the bench model with Ni56 (0.6 in the inner 10
     shells, 0.05 outside), 4,194,304 packets over 50 steps from 2 to 100
     days, 100 energy bins and the path-length estimators; the probe path,
     tardis_torch.benchmarks.probe2.main() (its JSON lines);
     on each path the launch counts are reset to 0 just before the run and
     read just after, every variant a wrapper launched under its own line
     (K1 and K7 without line estimators in the convergence iterations,
     with them in the final one);
  8. K5 (formal-integral rays) against its plain version on the main
     path's own source-function tables (ms, device_ms, the per-ray event
     distribution, and the ray with the most events alone as floor_ms);
  9. where the time goes: torch.profiler over a two-iteration run of the
     main path, of the large-ion path (profile_large_ion), of the walk
     path and of the IIP path, and over the gamma path (device time
     by kernel, host time by tardis.* span, the device's busy share; K6's
     device time summed over the gamma path's steps);
 10. the harness phase: the three benchmark harnesses run as a user runs
     them, each in a subprocess from the repository's root
     (python -m tardis_torch.benchmarks.<name>, HARNESS_RUNS):
     transport_bench with bench.py's workload less --batch and --chunk,
     production_run at its defaults, scaling_bench over 1, 2 and 4 shards
     of this card; each JSON line echoed on a "harness" line with the
     subprocess's wall, held by check_harness_line (exit code 0, every
     number finite, device cuda, L_emitted / L_requested in [0.8, 1.2],
     finite spectra, the keys the phase reads), then a harness_phase line:
     its seconds and the harness's K1 device ms (one launch, line
     estimators, 2,097,152 packets) beside the same instantiation's at
     the same shape in phase 2 (detailed_convergence);
 11. a JSON line of every kernel (each K1, K2 and K4 variant on its own
     line, K6 and K7 by the instantiations their paths run, K3's
     estimators instantiation as line_tables[estimators], with the
     launches of the path that runs it; K6's entry also carries its
     gamma-path totals: ms around each call, device ms, bound ms; K2's
     lines carry each shape's readings under "shapes"; the kernels the
     large-prefix phase held list it under "checks"), the card's name and
     power
     limit, and the result line {"ok": true, "device": {...}}.

Any failure raises and exits non-zero before the result line.  The script
imports nothing of JAX and nothing of the JAX package.

Bounds: bytes over 3.35 TB/s (each input read once, each output written
once) against float operations over 67 TFLOP/s (the H100 SXM's non-tensor
f32 rate, an FMA counted as two; f64 operations are counted against it
too, which the card does not exceed) and integer operations (the threefry
hashes, the searches' index arithmetic and compares) over the card's
integer rate, its SMs x 64 int32 lanes a clock x its max SM clock, read
on the card (tardis_torch/benchmarks/bounds.py, card_rates, shared with
the benchmark harnesses); the larger time is the bound.  Where the work
depends on the data (events, segments, walk jumps), the count is this
run's.  K2's bound counts instructions instead: those a packet must issue,
read from its SASS, each at its pipe's lanes (and all at the SM's issue
rate) at the card's SMs and max SM clock (sass_bound).
"""

from __future__ import annotations

import contextlib
import copy
import importlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from tardis_torch.benchmarks.bounds import (  # noqa: E402
    THREEFRY_OPS,
    Rates,
    bound,
    card_line,
    card_rates,
    k1_bound,
    lane_efficiency,
    nbytes,
)

# the bounds' rates: an H100 SXM's until main() reads the card's
RATES = Rates()

N_PACKETS = 2_097_152
FINAL_PACKETS = 4_194_304
N_VPACKETS = 2
INTEGRATED_POINTS = 1000
PLAIN_LANES = 1_048_576
OPTIONS_ITERATIONS = 3
ALBEDO = 0.5
TRACKER_LENGTH = 10
PROFILE_ITERATIONS = 2
ITERATIONS = 5
SEED = 23111963
IIP_PACKETS = 1_048_576
IIP_ITERATIONS = 4  # 3 convergence iterations (each with its thermal balance)
IIP_OPTIONS_ITERATIONS = 2  # and the final one
IIP_EVENT_CAP = 2_000  # both sides of a continuum K1 check stop here
NONHOM_ITERATIONS = 5  # 4 convergence iterations and the final one
NONHOM_PLAIN_LANES = 4_194_304  # K7's plain version: every packet a lane
GAMMA_PACKETS = 4_194_304
GAMMA_STEPS = 50
GAMMA_BINS = 100
GAMMA_DAYS = (2.0, 100.0)
GAMMA_CHECK_DAY = 10.0  # K6's check: every packet in flight at this epoch
GAMMA_CHECK_STEP_DAYS = 1.0
# K6's check cases: the share of the pool in flight, scattered over it (the
# gamma path moves 0.8% in its first step and 4.5% in its last); "idle"
# moves none, the step's fixed cost
GAMMA_CASES = {"dense": 1.0, "step0": 0.008, "step49": 0.045, "idle": 0.0}

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


RELATIVITY_CONFIG = copy.deepcopy(BENCH_CONFIG)
RELATIVITY_CONFIG["montecarlo"]["enable_full_relativity"] = True
del RELATIVITY_CONFIG["montecarlo"]["tracking"]  # tracking at its default

OPTIONS_CONFIG = copy.deepcopy(BENCH_CONFIG)
OPTIONS_CONFIG["montecarlo"].update(
    last_no_of_packets=N_PACKETS, iterations=OPTIONS_ITERATIONS,
    no_of_virtual_packets=0,
    packet_source="weighted", enable_reflective_inner_boundary=True,
    inner_boundary_albedo=ALBEDO,
    tracking={"track_last_interaction": False, "track_rpacket": True,
              "initial_array_length": TRACKER_LENGTH})
OPTIONS_CONFIG["spectrum"].update(method="real")
del OPTIONS_CONFIG["spectrum"]["integrated"]

# the JAX package's IIP problem (tardis_tpu/benchmarks/transport_bench.py:
# 391-422): H / He, 20 shells, macroatom, H I continua, 1,000 bins
IIP_CONFIG = {
    "supernova": BENCH_CONFIG["supernova"],
    "model": {"structure": BENCH_CONFIG["model"]["structure"],
              "abundances": {"type": "uniform", "H": 0.8, "He": 0.2}},
    "plasma": {"line_interaction_type": "macroatom",
               "continuum_interaction": {"species": ["H I"]}},
    "montecarlo": {"seed": SEED, "no_of_packets": IIP_PACKETS,
                   "iterations": IIP_ITERATIONS,
                   "last_no_of_packets": IIP_PACKETS},
    "spectrum": {"start": "500 angstrom", "stop": "20000 angstrom",
                 "num": 1000},
}
IIP_OPTIONS_CONFIG = copy.deepcopy(IIP_CONFIG)
IIP_OPTIONS_CONFIG["montecarlo"]["iterations"] = IIP_OPTIONS_ITERATIONS
IIP_OPTIONS_CONFIG["plasma"]["continuum_interaction"].update(
    enable_two_photon_decay=True, enable_adiabatic_cooling=True)
# the continuum-records problem of tests/test_torch_continuum_vpackets.py:
# the IIP problem at 1.6e4-2.6e4 km/s and 14 days, where few packets
# random-walk and continuum processes still write type-3 records; at its
# 1,000 packets every record fits 8 a packet, at 65,536 on the card the
# walkers (one of 44,227 events) made 16.3 attempts a packet, so its
# kernel check keeps RECORDS_PROBLEM_PER_PACKET rows a packet to hold
# every record
RECORDS_CONFIG = copy.deepcopy(IIP_CONFIG)
RECORDS_CONFIG["model"]["structure"]["velocity"].update(start="1.6e4 km/s",
                                                        stop="2.6e4 km/s")
RECORDS_CONFIG["supernova"]["time_explosion"] = "14 day"
RECORDS_PROBLEM_PER_PACKET = 32
# both sides of the records problem's bitwise check stop here: its p99 is
# 39 events a packet at 1,048,576 packets (on an NVIDIA H100 80GB HBM3),
# and the plain lockstep loop runs as many steps as the cap (32.3 s there
# at IIP_EVENT_CAP)
RECORDS_EVENT_CAP = 300
# continuum species through run_tardis (the classic loop, as the JAX
# package runs it): the IIP problem, 2 iterations at its width with
# virtual packets and their logging
CONTINUUM_SPECIES_CONFIG = copy.deepcopy(IIP_CONFIG)
CONTINUUM_SPECIES_CONFIG["montecarlo"].update(
    iterations=2, no_of_virtual_packets=N_VPACKETS)
CONTINUUM_SPECIES_CONFIG["spectrum"]["virtual"] = {
    "virtual_packet_logging": True}
# K4 (full relativity) on K1's continuum records: its own kernels line,
# counted under the full-relativity instantiation's launches
K4_CONTINUUM_LINE = "vpacket_volley[full_relativity,continuum_records]"

# the nonhomologous path: the bench problem under a perturbed velocity law
# (the JAX package's end-to-end test, tests/test_nonhomologous.py:252-257),
# tracking at its default (last-interaction rows), real-packet spectrum
NONHOM_CONFIG = copy.deepcopy(BENCH_CONFIG)
NONHOM_CONFIG["montecarlo"].update(iterations=NONHOM_ITERATIONS,
                                   no_of_virtual_packets=0)
del NONHOM_CONFIG["montecarlo"]["tracking"]
NONHOM_CONFIG["spectrum"].update(method="real")
del NONHOM_CONFIG["spectrum"]["integrated"]
# the gamma-ray path: Ni56 0.6 in the bench model's inner 10 shells, 0.05
# outside, with the path-length estimators
GAMMA_RUN = dict(n_packets=GAMMA_PACKETS, n_time_steps=GAMMA_STEPS,
                 n_energy_bins=GAMMA_BINS, collect_estimators=True)
# K6's instantiations held against the plain version
GAMMA_OPTIONS = {
    "default": {}, "grey": dict(grey_opacity=0.05),
    "kasen+artis": dict(photoabsorption_type="kasen",
                        pair_creation_type="artis"),
    "estimators": dict(collect_estimators=True)}

# the large-ion path: the bench run (20 shells, macroatom, 4 convergence
# iterations and the production final iteration with virtual packets) on
# the large-ion problem's atomic data, whose 600-level components take K8's
# large-system instantiation in every build; the real and virtual spectra
# (the formal integral stays on the main path: its host source function
# on 10,800 macro-atom levels is the JAX package's host numpy too)
LARGE_ION_CONFIG = copy.deepcopy(BENCH_CONFIG)
LARGE_ION_CONFIG["spectrum"].update(method="real")
del LARGE_ION_CONFIG["spectrum"]["integrated"]

# what each path hands K1: the transport tables' options, the pool, the
# trackers, and whether its final iteration writes spawn records
PATHS = {
    "main": dict(tables={}, pool="simple", last_interaction=False,
                 tracker_length=0, records=True),
    "relativity": dict(tables={"full_relativity": True}, pool="relativistic",
                       last_interaction=True, tracker_length=0, records=True),
    "options": dict(tables={"inner_boundary_albedo": ALBEDO}, pool="weighted",
                    last_interaction=False, tracker_length=TRACKER_LENGTH,
                    records=False),
    # the v_inner path: the main path's tables and pool with
    # last-interaction rows; its K4 instantiation is the main path's
    "v_inner": dict(tables={}, pool="simple", last_interaction=True,
                    tracker_length=0, records=True),
}
WITH_OPTIONS = ("transport_loop", "vpacket_volley", "nonhom_loop",
                "gamma_step")
# the walk path: the bench problem from a carsus file, with K1's RNG-walk
# macro atom (use_macro_chain False); 2 convergence iterations and the
# production final iteration
WALK_ITERATIONS = 3
WALK_CONFIG = copy.deepcopy(BENCH_CONFIG)
WALK_CONFIG["montecarlo"]["iterations"] = WALK_ITERATIONS
# K1's walk instantiations held against the plain version: (role, mode,
# packets, line estimators and records); downbranch is the convergence
# instantiation with one jump
WALK_CASES = (("convergence", "macroatom", N_PACKETS, False),
              ("final", "macroatom", FINAL_PACKETS, True),
              ("downbranch", "downbranch", N_PACKETS, False))
# the detailed_nlte path: the main path with detailed radiative rates and
# Si II in NLTE, so K1 accumulates line estimators in every iteration and
# each plasma solve after the first takes K3's estimators instantiation
DETAILED_CONFIG = copy.deepcopy(BENCH_CONFIG)
DETAILED_CONFIG["plasma"].update(radiative_rates_type="detailed",
                                 nlte={"species": ["Si 2"]})
W_EPSILON = 1e-10  # the configuration's default
# the helium path, at reduced depth: the bench problem's elements with He
# (synthetic data, 200 levels, jumps up to 60), recomb-nlte over 2
# convergence iterations and the final one without virtual packets, then
# numerical-nlte over one convergence iteration with a heating-rate file
HELIUM_ELEMENTS = (2, 8, 12, 14, 16, 18, 20)
HELIUM_ITERATIONS = 3
HELIUM_CONFIG = copy.deepcopy(BENCH_CONFIG)
HELIUM_CONFIG["model"]["abundances"] = {
    "type": "uniform", "He": 0.2, "O": 0.15, "Mg": 0.03, "Si": 0.42,
    "S": 0.12, "Ar": 0.04, "Ca": 0.04}
HELIUM_CONFIG["plasma"].update(helium_treatment="recomb-nlte")
HELIUM_CONFIG["montecarlo"].update(iterations=HELIUM_ITERATIONS,
                                   no_of_virtual_packets=0)
HELIUM_CONFIG["spectrum"].update(method="real")
del HELIUM_CONFIG["spectrum"]["integrated"]
NUMERICAL_HELIUM_CONFIG = copy.deepcopy(HELIUM_CONFIG)
NUMERICAL_HELIUM_CONFIG["plasma"]["helium_treatment"] = "numerical-nlte"
NUMERICAL_HELIUM_CONFIG["montecarlo"]["iterations"] = 2
# the model-file path: a csvy written here (MODEL_FILE_SHELLS shells over
# the bench velocities, branch85_w7 density tabulated at 1 day, O / Mg
# outside, Si / S / Ar / Ca in the middle, Ni56 0.6 in the inner 5 shells
# falling to 0 by shell 10, a small Co56 column, isotopes at 0 days) read
# through csvy_model at 13 days, on the bench problem's synthetic data
# with the iron group; 2 convergence iterations and the production final
# iteration
MODEL_FILE_ELEMENTS = (8, 12, 14, 16, 18, 20, 26, 27, 28)
MODEL_FILE_SHELLS = 20
MODEL_FILE_ITERATIONS = 3
MODEL_FILE_CONFIG = copy.deepcopy(BENCH_CONFIG)
del MODEL_FILE_CONFIG["model"]
MODEL_FILE_CONFIG["montecarlo"]["iterations"] = MODEL_FILE_ITERATIONS
# the command-line path: a CMFGEN model of O-Ca written here, named by
# model.structure (type file) with a v_inner_boundary that drops shell 0
# and trims shell 1, on the default synthetic data; one convergence
# iteration and a final one, both of N_PACKETS, with 2 virtual packets
CLI_ITERATIONS = 2
CLI_V_INNER_KMS = 11700.0
CLI_CONFIG = copy.deepcopy(BENCH_CONFIG)
CLI_CONFIG["montecarlo"].update(iterations=CLI_ITERATIONS,
                                last_no_of_packets=N_PACKETS)
del CLI_CONFIG["model"]["abundances"]  # the model file carries them
CLI_CONFIG["spectrum"] = {"start": "500 angstrom", "stop": "20000 angstrom",
                          "num": 1000}
# the resume after a crash, against the uninterrupted run: the sharded
# path's bar, since K1's racing f64 atomics part two runs in the last bits
RESUME_RTOL = 1e-5
# the inner-velocity solver path: the bench problem through
# InnerVelocitySolverWorkflow, 3 convergence iterations (each moving the
# inner boundary) and the production final iteration without the formal
# integral, last-interaction tracking at its default (on)
V_INNER_ITERATIONS = 4
# the target tau: the first solve's Rosseland profile at this shell, inside
# the profile (the default 2/3 may lie above it, where the boundary stays)
V_INNER_TAU_SHELL = 5
V_INNER_CONFIG = copy.deepcopy(BENCH_CONFIG)
V_INNER_CONFIG["montecarlo"]["iterations"] = V_INNER_ITERATIONS
del V_INNER_CONFIG["montecarlo"]["tracking"]
V_INNER_CONFIG["spectrum"].update(method="real")
del V_INNER_CONFIG["spectrum"]["integrated"]
# the analysis of the v_inner path's final simulation against a host
# numpy f64 evaluation of the same tables (f64 on both sides: only the
# order of the sums differs)
ANALYSIS_RTOL = 1e-10
OPACITY_BINS = 300
ANALYSIS_WINDOWS = ((500.0, 20000.0), (3000.0, 7000.0))  # Angstrom
# the grid path: TardisGrid.from_axes on the bench data, each row 1 + 1
# iterations of GRID_PACKETS, real-packet spectrum
GRID_PACKETS = 1_048_576
GRID_AXES = {"supernova.time_explosion": ["10 day", "13 day"],
             "model.structure.velocity.num": [15, 20]}
GRID_CONFIG = copy.deepcopy(BENCH_CONFIG)
GRID_CONFIG["montecarlo"].update(iterations=2, no_of_packets=GRID_PACKETS,
                                 last_no_of_packets=GRID_PACKETS,
                                 no_of_virtual_packets=0)
GRID_CONFIG["spectrum"].update(method="real")
del GRID_CONFIG["spectrum"]["integrated"]


def line_name(kernel, variant):
    """The kernels-line name of one variant of a wrapper (K2 by pool, K1
    and K4 by the variant names of their modules)."""
    if variant in ("simple", "classic", "scatter", "default") or (
            kernel, variant) == ("macro_chain", "macroatom_cluster"):
        return kernel
    return f"{kernel}[{variant}]"


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


def cuda_ms_queued(fn, reps, hold_cycles=40_000_000, report_hold=False):
    """Device milliseconds per call of ``fn`` over ``reps`` calls queued
    back to back after a warm-up, for kernels of a few hundredths of a
    millisecond, where a single call's events would time the host's launch
    overhead: the card first spins ``hold_cycles`` clock cycles (~20 ms)
    while the host queues every call, so the events around the calls see
    the card's work alone.  When the card has left the hold before the
    host queued the last call (a host stall, or a call that synchronises),
    it may have waited for the host: the run is made again with twice the
    hold, up to three runs, and the smallest time is kept.  Returns (ms,
    last result), and with ``report_hold`` also whether the hold held in
    the kept run (if not, the time is paced by the host)."""
    out = fn()
    torch.cuda.synchronize()
    ms, held_at_min = math.inf, False
    for attempt in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold_cycles << attempt)
        a.record()
        for _ in range(reps):
            out = fn()
        held = not a.query()
        b.record()
        torch.cuda.synchronize()
        run_ms = a.elapsed_time(b) / reps
        if run_ms < ms:
            ms, held_at_min = run_ms, held
        if held:
            break
    return (ms, out, held_at_min) if report_hold else (ms, out)


def kernel_ms(fn, reps, names):
    """Device milliseconds a call of the kernels whose names contain one
    of ``names``, from torch.profiler's kernel records over ``reps`` calls
    of ``fn`` after a warm-up: the kernels alone, whatever the host does
    between them.  Returns (ms, their launches a call, the ms and count a
    call of every other device record: copies, memsets, other kernels).
    A session whose records of those kernels are not a whole number a call
    has lost some, and is made again."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    on_device = torch.autograd.DeviceType.CUDA
    # a session has come back without some or all of the kernels' records
    # (cause not known): it is made again, up to three sessions, and each
    # such session prints what it did record
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        mine, other, seen = [0.0, 0], [0.0, 0], {}
        for e in prof.key_averages():
            if e.self_device_time_total > 0:
                seen[e.key[:80]] = (str(e.device_type), e.count)
            if e.device_type != on_device or e.self_device_time_total <= 0:
                continue
            row = mine if any(n in e.key for n in names) else other
            row[0] += e.self_device_time_total / 1e3
            row[1] += e.count
        if mine[1] and mine[1] % reps == 0:
            return (mine[0] / reps, mine[1] / reps, other[0] / reps,
                    other[1] / reps)
        say("kernel_ms_lost_records", attempt=attempt, names=names,
            calls=reps, records=mine[1], events=len(prof.events()),
            device_records=seen)
    raise AssertionError(f"the profiler lost records of the kernels "
                         f"named {names} in three sessions")


def host_us(fn, reps):
    """Host microseconds a call of ``fn`` over ``reps`` calls, after a
    warm-up and a synchronize, with no synchronize between them (a call
    that waits for the card waits here)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def build_large_ion_atom():
    """The large-ion problem's atomic data: the bench problem's elements
    with LARGE_ION_LEVELS levels and level jumps up to LARGE_ION_JUMP."""
    from tardis_torch.atomic.synthetic import make_synthetic_atom_data

    return make_synthetic_atom_data(
        n_levels=LARGE_ION_LEVELS, max_level_jump=LARGE_ION_JUMP).prepare(
            selected_atoms=[8, 12, 14, 16, 18, 20],
            line_interaction_type="macroatom")


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


K3_NAMES = ("stim", "tau", "beta", "j_blues", "prefix")
# shell counts past K3's one chunk of shells a block (87) and past its
# per-shell inputs by value (128): the bench lines with the shells repeated
K3_WIDE_SHELLS = (100, 200)


def compare_line_tables(k, p, what):
    """K3's outputs ``k`` against its plain version's ``p``: the four
    tables within 1e-12, the prefix, summed in another order, within
    1e-10, relative.  Returns the largest absolute error."""
    max_abs = 0.0
    for name in K3_NAMES:
        a, b = getattr(k, name), getattr(p, name)
        rel = ((a - b).abs() / b.abs().clamp_min(1e-300)).max().item()
        limit = 1e-10 if name == "prefix" else 1e-12
        if not (rel <= limit):
            raise AssertionError(f"line_tables {what} {name}: max rel {rel}")
        max_abs = max(max_abs, (a - b).abs().max().item())
    return max_abs


def line_tables_bitwise(a, b):
    return all(torch.equal(getattr(a, name), getattr(b, name))
               for name in K3_NAMES)


def estimator_table(jb, seed=SEED):
    """A stand-in for the estimator j_blues: the dilute-Planck table times
    a seeded factor in [0.5, 1.5), zero in ~30% of the entries, so K3's
    select takes both branches."""
    g = torch.Generator(device=jb.device).manual_seed(seed)
    u = torch.rand(jb.shape, generator=g, device=jb.device,
                   dtype=torch.float64)
    return torch.where(u < 0.3, 0.0, jb * (0.5 + u))


def estimators_bitwise(k_est, k, est):
    """K3's estimators instantiation against its default one on the same
    inputs: stim, tau, beta and the prefix bit for bit, and the j_blues
    the select over the default's, est where est > 0, else W_EPSILON times
    the dilute-Planck value."""
    picked = torch.where(est > 0, est, W_EPSILON * k.j_blues)
    return (all(torch.equal(getattr(k_est, name), getattr(k, name))
                for name in ("stim", "tau", "beta", "prefix"))
            and torch.equal(k_est.j_blues, picked))


def check_estimators(args, k, pop, static):
    """K3's estimators instantiation (``detailed`` radiative rates) at the
    shape of ``args``: bitwise against its default instantiation with the
    select applied (``estimators_bitwise``), bitwise run to run, against
    its plain version within compare_line_tables's limits (the estimator
    entries bit for bit), timed as for the default one, beside the one
    PyTorch expression that applies the select to K3's output
    (``torch.where``).  Returns (numbers, estimators table, output)."""
    from tardis_torch.plasma.line_tables import line_tables, line_tables_plain

    est = estimator_table(k.j_blues)
    kw = dict(j_estimators=est, w_epsilon=W_EPSILON)
    ms, ke = cuda_ms_queued(lambda: line_tables(*args, **kw), 200)
    host_ms, _ = cuda_ms(lambda: line_tables(*args, **kw), 20)
    plain_ms, pe = cuda_ms(lambda: line_tables_plain(*args, **kw), 5)
    taken = est > 0
    bitwise = (estimators_bitwise(ke, k, est)
               and line_tables_bitwise(line_tables(*args, **kw), ke)
               and torch.equal(ke.j_blues[taken], pe.j_blues[taken]))
    if not bitwise:
        raise AssertionError("line_tables[estimators]: not bitwise")
    max_abs = compare_line_tables(ke, pe, "estimators")
    library_ms, _ = cuda_ms_queued(
        lambda: torch.where(est > 0, est, W_EPSILON * k.j_blues), 200)
    L, S = k.tau.shape
    in_bytes = nbytes(pop, static.lower_idx, static.upper_idx,
                      static.g_lower, static.g_upper, static.wl_flu,
                      static.line_nu, static.nu3_coef, est) + 16 * S
    out_bytes = nbytes(ke.stim, ke.tau, ke.beta, ke.j_blues, ke.prefix)
    b_ms, b_by = bound(in_bytes + out_bytes, L * S * 57, 0, RATES)
    numbers = dict(L=L, S=S, ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                   estimator_share=taken.double().mean().item(),
                   bitwise=bitwise, max_abs_err=max_abs)
    return numbers, est, ke


def check_line_tables(state, atom, device, wide_shells=()):
    """K3 against its plain version (``compare_line_tables``), bitwise
    equal to itself over two more runs, and timed two ways beside the one
    PyTorch call that computes its prefix alone: device time of calls
    queued back to back (cuda_ms_queued) and time with the host's launch
    work included (cuda_ms, one call between two events).  Then, for each
    count in ``wide_shells``, the same lines over that many shells (shell
    s takes the inputs of shell s % S): against the plain version, bitwise
    run to run, and bitwise equal to the S-shell run in every repeated
    shell, each shell being scanned on its own."""
    from tardis_torch.plasma.line_tables import line_tables, line_tables_plain
    from tardis_torch.plasma.solver import PlasmaSolver

    solver = PlasmaSolver(atom, state, device)
    ps = solver.update(state.t_radiative, state.dilution_factor)
    pop = torch.as_tensor(ps.level_number_density, device=device)
    args = (solver.line_static, pop, state.t_radiative,
            state.dilution_factor, state.time_explosion)
    ms, k = cuda_ms_queued(lambda: line_tables(*args), 200)
    host_ms, _ = cuda_ms(lambda: line_tables(*args), 20)
    plain_ms, p = cuda_ms(lambda: line_tables_plain(*args), 5)
    bitwise = all(line_tables_bitwise(line_tables(*args), k)
                  for _ in range(2))
    if not bitwise:
        raise AssertionError("line_tables: two runs differ")
    max_abs = compare_line_tables(k, p, "")
    del p
    # the prefix alone, as one PyTorch scan in the (S, L) layout K3 writes
    tau_sl = k.tau.T

    def scan():
        return torch.cumsum(tau_sl, dim=1, dtype=torch.float64)

    library_ms, _ = cuda_ms_queued(scan, 200)
    library_host_ms, _ = cuda_ms(scan, 20)
    st = solver.line_static
    L, S = k.tau.shape
    in_bytes = nbytes(pop, st.lower_idx, st.upper_idx, st.g_lower,
                      st.g_upper, st.wl_flu, st.line_nu, st.nu3_coef) + 16 * S
    out_bytes = nbytes(k.stim, k.tau, k.beta, k.j_blues, k.prefix)
    # ~55 f64 operations per element (ratio, stim, tau, two expm1 and the
    # beta / j_blues branches) plus one add of the scan
    b_ms, b_by = bound(in_bytes + out_bytes, L * S * 56, 0, RATES)
    say("check_line_tables", L=L, S=S, ms=ms, host_ms=host_ms,
        plain_ms=plain_ms, library_ms=library_ms,
        library_host_ms=library_host_ms, bound_ms=b_ms,
        bitwise_run_to_run=bitwise, max_abs_err=max_abs)
    est_numbers, est, k_est = check_estimators(args, k, pop, st)
    say("check_line_tables_estimators", **est_numbers)
    est_wide = {}
    wide = {}
    for n_shells in wide_shells:
        idx = torch.arange(n_shells, device=device) % S
        host_idx = idx.cpu().numpy()
        wide_args = (st, pop[:, idx].contiguous(),
                     np.asarray(state.t_radiative)[host_idx],
                     np.asarray(state.dilution_factor)[host_idx],
                     state.time_explosion)
        w_ms, kwide = cuda_ms_queued(lambda: line_tables(*wide_args), 20)
        w_bitwise = line_tables_bitwise(line_tables(*wide_args), kwide)
        repeated = all(torch.equal(getattr(kwide, name),
                                   getattr(k, name)[:, idx])
                       if name != "prefix" else
                       torch.equal(kwide.prefix, k.prefix[idx])
                       for name in K3_NAMES)
        w_abs = compare_line_tables(kwide, line_tables_plain(*wide_args),
                                    f"at {n_shells} shells")
        if not (w_bitwise and repeated):
            raise AssertionError(
                f"line_tables at {n_shells} shells: run to run bitwise "
                f"{w_bitwise}, repeated shells bitwise {repeated}")
        max_abs = max(max_abs, w_abs)
        wide[n_shells] = dict(ms=w_ms, max_abs_err=w_abs)
        say("check_line_tables_wide", L=L, S=n_shells, ms=w_ms,
            bitwise_run_to_run=w_bitwise, repeated_shells_bitwise=repeated,
            max_abs_err=w_abs)
        # the estimators instantiation over the same repeated shells
        e_kw = dict(j_estimators=est[:, idx].contiguous(),
                    w_epsilon=W_EPSILON)
        e_ms, ke_wide = cuda_ms_queued(
            lambda: line_tables(*wide_args, **e_kw), 20)
        e_bitwise = (estimators_bitwise(ke_wide, kwide, e_kw["j_estimators"])
                     and line_tables_bitwise(
                         line_tables(*wide_args, **e_kw), ke_wide)
                     and torch.equal(ke_wide.j_blues, k_est.j_blues[:, idx]))
        if not e_bitwise:
            raise AssertionError(
                f"line_tables[estimators] at {n_shells} shells: not bitwise")
        e_abs = compare_line_tables(
            ke_wide, line_tables_plain(*wide_args, **e_kw),
            f"estimators at {n_shells} shells")
        est_wide[n_shells] = dict(ms=e_ms, max_abs_err=e_abs)
        est_numbers["max_abs_err"] = max(est_numbers["max_abs_err"], e_abs)
        say("check_line_tables_estimators_wide", L=L, S=n_shells, ms=e_ms,
            bitwise=e_bitwise, max_abs_err=e_abs)
        del kwide, ke_wide
    k3 = dict(
        name="line_tables", route="cuda",
        source="tardis_torch/csrc/line_tables.cu",
        replaces="tardis_tpu/plasma/device_line.py:163",
        max_abs_err=max_abs, ms=ms, host_ms=host_ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
        library_host_ms=library_host_ms,
        **({"wide_shells": wide} if wide else {}),
    )
    k3_est = dict(
        name=line_name("line_tables", "estimators"), route="cuda",
        source="tardis_torch/csrc/line_tables.cu",
        replaces="tardis_tpu/plasma/solver.py:458",
        **{key: est_numbers[key] for key in (
            "max_abs_err", "ms", "host_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
        **({"wide_shells": est_wide} if est_wide else {}),
    )
    return ps, k3, k3_est


REPLACES_K2 = {"simple": "tardis_tpu/transport/source.py:31",
               "relativistic": "tardis_tpu/transport/source.py:89",
               "weighted": "tardis_tpu/transport/source.py:58"}


def beta_inner(state):
    from tardis_torch.constants import C

    return float(state.geometry.r_inner[0]
                 / (C * state.geometry.time_explosion))


K2_SHAPES = (IIP_PACKETS, N_PACKETS, FINAL_PACKETS)
K2_HASHES = {"simple": 7, "relativistic": 8, "weighted": 3}
K2_KERNELS = ("blackbody_source_kernel", "weighted_pool_kernel",
              "normalize_weights_kernel")
K2_SASS_KERNELS = {"simple": "blackbody_source_kernelILi0E",
                   "relativistic": "blackbody_source_kernelILi1E",
                   "weighted": "weighted_pool_kernel"}
K2_PACKETS_A_THREAD = {"simple": 1, "relativistic": 1, "weighted": 8}
# An H100 SM issues one warp instruction a clock on each of its four
# sub-partitions (128 thread instructions a clock); the pipes below take
# the opcodes named at their lanes a clock an SM (CUDA C++ Programming
# Guide, arithmetic throughput for compute capability 9.0; IMAD runs on
# the FMA pipe's heavy half, beside the ALU).  An opcode named nowhere
# still takes its issue slot.
ISSUE_LANES = 128
SASS_PIPES = {
    "alu": (64, ("IADD3", "LOP3", "SHF", "ISETP", "LEA", "SEL", "IMNMX")),
    "fmaheavy": (64, ("IMAD", "IMUL")),
    "fma": (128, ("IMAD", "IMUL", "FFMA", "FMUL", "FADD")),
    "fp64": (64, ("DFMA", "DADD", "DMUL")),
    "xu": (16, ("MUFU",)),
}
_SASS_LINE = re.compile(
    r"/\*([0-9a-f]+)\*/\s+(@!?U?P[T0-6]\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_SASS_PRED = re.compile(r"(^|[\s,])!?U?P[0-6]\b")


def sass_functions(text):
    """{function: [(address, predicated, opcode, operands)]} of the output
    of ``cuobjdump -sass``; an instruction under @PT is not predicated."""
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = _SASS_LINE.search(ln)
        if m and name is not None:
            pred = m.group(2) or ""
            out[name].append((int(m.group(1), 16),
                              bool(pred) and pred.strip() != "@PT",
                              m.group(3), m.group(4).strip()))
    return out


def search_min_trips(n):
    """The fewest turns of K2's bisection (while lo < hi) over an n-entry
    table, over every index it can return."""
    def turns(r):
        lo, hi, c = 0, n, 0
        while lo < hi:
            mid = (lo + hi) >> 1
            lo, hi = (mid + 1, hi) if mid < r else (lo, mid)
            c += 1
        return c
    return min(turns(r) for r in range(n + 1))


def sass_path_counts(code, loop_trips=1):
    """Instructions (and each pipe's, SASS_PIPES) that a thread must issue
    for the packets it stores, from a kernel's SASS: the cheapest path from
    the entry to an exit that passes every global load (LDG) and every
    f32 global store (STG) in address order (every store alone where no
    path passes them all) minus the cheapest path that stores nothing (the
    thread with no packet), with each loop taken once (back branches
    dropped).  With ``loop_trips`` > 1, a single loop that holds no store
    and that no branch leaves but its own is counted that many times.
    Cheapest for each count on its own, and a branch whose sides both pass
    the sites is charged its cheaper side, so each is a lower bound.
    Returns ({"issue": n, pipe: n, ...} a thread, "loads and stores" or
    "stores": the sites the path passes)."""
    n = len(code)
    index = {addr: i for i, (addr, _, _, _) in enumerate(code)}
    succ, terminal, back = [[] for _ in range(n)], [False] * n, []
    for i, (addr, pred, op, args) in enumerate(code):
        base = op.split(".")[0]
        cond = pred or bool(_SASS_PRED.search(args)) or ".DIV" in op
        if base == "BRA":
            target = index.get(int(re.findall(r"0x([0-9a-f]+)", args)[-1],
                                   16))
            if target is not None and target > i:
                succ[i].append(target)
            elif target is not None:
                back.append((target, i))
            if cond and i + 1 < n:
                succ[i].append(i + 1)
        elif base == "EXIT":
            terminal[i] = True
            if pred and i + 1 < n:
                succ[i].append(i + 1)
        elif base not in ("RET", "BPT", "JMP", "JMX", "BRX", "KILL"):
            if i + 1 < n:
                succ[i].append(i + 1)
    # the packets' f32 stores (not the weighted pool's f64 chunk sums)
    stg = {i for i, c in enumerate(code) if c[2].startswith("STG")}
    stores = sorted(i for i in stg if not re.search(r"\.(64|128)\b",
                                                    code[i][2]))
    loads = [i for i, c in enumerate(code) if c[2].startswith("LDG")]

    def weight(kind):
        if kind == "issue":
            return [0 if c[2].startswith("NOP") else 1 for c in code]
        ops = SASS_PIPES[kind][1]
        return [1 if c[2].split(".")[0] in ops else 0 for c in code]

    def cheapest(w, src, dst, allowed=None):
        """Least weight of a forward path src -> dst (both counted), or of
        src -> any exit when dst is None, through ``allowed`` nodes."""
        cost = [math.inf] * n
        cost[src] = w[src]
        best = math.inf
        for i in range(src, n):
            if cost[i] == math.inf:
                continue
            if i == dst:
                return cost[i]
            if dst is None and terminal[i]:
                best = min(best, cost[i])
            for j in succ[i]:
                if (allowed is None or j in allowed) and (
                        cost[i] + w[j] < cost[j]):
                    cost[j] = cost[i] + w[j]
        return best

    reached = [False] * n
    reached[0] = True
    for i in range(n):
        for j in succ[i] if reached[i] else ():
            reached[j] = True
    back = [(t, i) for t, i in back if reached[i]]  # not the closing BRA
    loads = [i for i in loads if reached[i]]
    loops = []
    for t, i in back:
        inside = set(range(t, i + 1))
        leaves = any(j > i + 1 for k in inside for j in succ[k])
        nested = any(t <= b <= i for a, b in back if (a, b) != (t, i))
        if not (leaves or nested or inside & stg):
            loops.append((t, i, inside))
    no_store = set(range(n)) - stg

    def through(w, sites):
        total, at = 0, 0
        for s in sites:
            total += cheapest(w, at, s) - (w[at] if at else 0)
            at = s
        return total + cheapest(w, at, None) - w[at]

    sites = sorted(set(stores) | set(loads))
    passes = "loads and stores"
    if through(weight("issue"), sites) == math.inf:
        sites, passes = stores, "stores"
    out = {}
    for kind in ("issue", *SASS_PIPES):
        w = weight(kind)
        total = through(w, sites)
        idle = cheapest(w, 0, None, no_store)
        extra = 0
        if loop_trips > 1 and len(loops) == 1:
            t, i, inside = loops[0]
            extra = (loop_trips - 1) * cheapest(w, t, i, inside)
        out[kind] = total - idle + extra
    return out, passes


def k2_sass(lib):
    """K2's SASS (cuobjdump) of the library ``lib``: for each pool, the
    threefry hashes a packet (a hash rotates left by 13 three times, each a
    funnel shift by 13 or right by 19) and the instructions a packet must
    issue, all and by pipe (sass_path_counts; the search's loop at its
    fewest turns over the 999-entry table).  Raises if it cannot be read."""
    from tardis_torch import cuda
    from tardis_torch.transport.source import _L_ARRAY

    tool = os.path.join(os.path.dirname(cuda._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    funcs = sass_functions(text)
    rot13 = re.compile(r"SHF\.(L\.W\.U32(\.HI)?\s+R\d+,\s*R\d+,\s*0xd,|"
                       r"R\.W\.U32(\.HI)?\s+R\d+,\s*R\d+,\s*0x13,)")
    trips = search_min_trips(len(_L_ARRAY))
    out = {}
    for pool, tag in K2_SASS_KERNELS.items():
        (name,) = [f for f in funcs if tag in f]
        code = funcs[name]
        per = K2_PACKETS_A_THREAD[pool]
        counts, passes = sass_path_counts(code, 1 if per > 1 else trips)
        out[pool] = dict(
            instructions=len(code), search_trips=None if per > 1 else trips,
            path_through=passes,
            hashes=sum(1 for c in code if rot13.search(
                f"{c[2]} {c[3]},")) / 3 / per,
            per_packet={k: v / per for k, v in counts.items()})
    return out


def sass_bound(n_bytes, n_packets, per_packet):
    """Least ms for K2's ``n_packets``: the larger of the bytes' time and
    each pipe's (and the issue slots') time for the instructions a packet
    must issue (k2_sass), at the card's SMs and max SM clock.  Returns
    (ms, what bounds it, each term's ms)."""
    lanes = {"issue": ISSUE_LANES, **{k: v[0] for k, v in SASS_PIPES.items()}}
    terms = {k: n_packets * per_packet[k]
             / (RATES.sms * lanes[k] * RATES.sm_clock_hz) * 1e3
             for k in lanes}
    terms["bytes"] = n_bytes / RATES.hbm_bytes_per_s * 1e3
    top = max(terms, key=terms.get)
    return terms[top], "bytes" if top == "bytes" else "operations", terms


def k2_timings(call):
    """One K2 wrapper's readings: its kernels alone (profiler), its calls
    queued behind the hold (and whether the hold held), the host's
    microseconds a call."""
    k_ms, k_launches, other_ms, other_n = kernel_ms(call, 20, K2_KERNELS)
    device_ms, _, held = cuda_ms_queued(call, 10, report_hold=True)
    return dict(kernel_ms=k_ms, kernel_launches=k_launches,
                other_device_ms=other_ms, other_device_records=other_n,
                device_ms=device_ms, held=held, host_us=host_us(call, 20))


def check_blackbody_source(state, device, n_packets, iteration, sass,
                           pool="simple"):
    """K2 at ``n_packets`` with the source key of ``iteration``: mu, nu and
    w bit for bit against the plain version, the weighted pool's w also
    bit for bit from run to run; timed by CUDA events around each call
    (``ms``), as its kernels alone (``kernel_ms``, profiler), as device
    time of queued calls (``device_ms``, with ``held``) and as host
    microseconds a call.  Each call must be one kernel launch with no
    other device work beside it, and must leave the hold held (no
    synchronisation).  The bound is the instructions a packet must issue,
    read from the SASS (``sass``, k2_sass), at each pipe's rate
    (sass_bound); ``hash_bound_ms`` is the earlier bound, the pool's
    hashes at 72 integer operations each on 64 lanes an SM."""
    from tardis_torch.transport.solver import iteration_keys
    from tardis_torch.transport.source import (
        blackbody_source,
        blackbody_source_plain,
    )

    key, _ = iteration_keys(SEED, iteration)
    args = (key, n_packets, state.t_inner, device, pool, beta_inner(state))
    ms, (mu, nu, w) = cuda_ms(lambda: blackbody_source(*args), 10)
    plain_ms, (mu_p, nu_p, w_p) = cuda_ms(
        lambda: blackbody_source_plain(*args), 3)
    pairs = [(mu, mu_p), (nu, nu_p)] + ([] if w is None else [(w, w_p)])
    bitwise = {name: bool(torch.equal(a, b))
               for name, (a, b) in zip(("mu", "nu", "w"), pairs)}
    again = [blackbody_source(*args) for _ in range(2)]
    run_to_run = all(torch.equal(a, b) for out in again
                     for a, b in zip((mu, nu, w), out) if a is not None)
    if not (all(bitwise.values()) and run_to_run):
        raise AssertionError(f"blackbody_source[{pool}] at {n_packets}: "
                             f"bitwise {bitwise}, run to run {run_to_run}")
    max_abs = max((a - b).abs().max().item() for a, b in pairs)
    t = k2_timings(lambda: blackbody_source(*args))
    if not (t["kernel_launches"] == 1 and t["other_device_records"] == 0
            and t["held"]):
        raise AssertionError(
            f"blackbody_source[{pool}] at {n_packets}: a call must be one "
            f"launch, with nothing else on the card and no "
            f"synchronisation: {t}")
    n_out = nbytes(mu, nu) + (0 if w is None else nbytes(w))
    table = 0 if pool == "weighted" else 999 * 4
    b_ms, b_by, terms = sass_bound(n_out + table, n_packets,
                                   sass[pool]["per_packet"])
    hash_bound_ms, _ = bound(n_out + table, n_packets * 15, n_packets * (
        K2_HASHES[pool] * THREEFRY_OPS + 30), RATES)
    numbers = dict(
        ms=ms, kernel_ms=t["kernel_ms"], device_ms=t["device_ms"],
        held=t["held"], host_us=t["host_us"], plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, share=b_ms / t["kernel_ms"],
        hash_bound_ms=hash_bound_ms,
        hash_share=hash_bound_ms / t["kernel_ms"])
    say("check_blackbody_source", pool=pool, n=n_packets, **numbers,
        bound_terms=terms, max_rel=max(
            ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()
            for a, b in pairs), bitwise=bitwise, run_to_run=run_to_run)
    return (mu, nu, w), dict(
        name=line_name("blackbody_source", pool), route="cuda",
        source="tardis_torch/csrc/blackbody_source.cu",
        replaces=REPLACES_K2[pool], max_abs_err=max_abs, **numbers,
        library_ms=None)


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


# K8's bars against its plain version on the card: the chain rows, whose
# solves differ (Gauss-Jordan at the real size against LU with partial
# pivoting at the power-of-two size), and the emission rows, whose sums
# the plain version takes in atomic order and its running sum by a
# parallel scan
K8_CHAIN_ATOL = 1e-6
K8_EMIT_ATOL = 2.4e-7
K8_WIDE_SHELLS = 100  # K3's wide shape: the bench lines, shells repeated
# components past the cluster instantiation's reach (384 levels), which
# take the large-system instantiation: one synthetic element of 600 levels
# (three components) at 4 shells, the few-system case
K8_WIDE_LEVELS = 600
K8_WIDE_LEVELS_SHELLS = 4
# the large-ion problem: the bench problem's six elements with 600 levels
# and level jumps up to 60 (18 components of 600 levels, 615,060 lines),
# 20 shells: 360 systems a build, all the large-system instantiation's
LARGE_ION_LEVELS = 600
LARGE_ION_JUMP = 60
# the mixed build: the bench atom's macro table (18 components of 200
# levels, the cluster instantiation's) and the wide element's (3 of 600,
# the large one's) side by side, at this many shells
K8_MIXED_SHELLS = 4
REPLACES_K8 = "tardis_tpu/opacities/macro_atom_solver.py:389"
# a macro table with a closed two-level internal cycle and no emission
# (levels 0 <-> 1), beside a two-level component with emission (2, 3) and
# a lone emitting level (4); one line a transition
K8_CYCLE_LEVELS = (0, 1)
K8_CYCLE = dict(
    transition_type=[0, 1, -1, 1, 0, -1, -1, -1],
    destination_level_id=[1, 0, -1, 3, 2, -1, -1, -1],
    coef=[1.0, 0.7, 0.8, 0.3, 0.5, 0.9, 0.4, 1.1],
    block_references=[0, 1, 2, 4, 7, 8],
    line2macro_level_upper=[1, 0, 2, 3, 2, 3, 3, 4],
)


def shells_repeated(rates, n_shells):
    """The (L, S) tables with shell s taking shell s % S's column."""
    S = rates[0].shape[1]
    idx = torch.arange(n_shells, device=rates[0].device) % S
    return tuple(t[:, idx].contiguous() for t in rates)


def compare_chain(ctx, k, p, what):
    """K8's (chain_cdf, emit_cdf) ``k`` against the plain version's ``p``:
    the CDF columns within their bars, the copied columns (line ids,
    frequencies, base level) bit for bit, every row non-decreasing and
    finite; returns the largest differences and the shares of CDF entries
    equal bit for bit."""
    (kc, ke), (pc, pe) = k, p
    out = {}
    for name, a, b, width, bar in (("emit", ke, pe, ctx.We, K8_EMIT_ATOL),
                                   ("chain", kc, pc, ctx.W, K8_CHAIN_ATOL)):
        if width == 0:
            if a is not None or b is not None:
                raise AssertionError(f"macro_chain {what}: chain rows in "
                                     "downbranch mode")
            continue
        err = (a[:, :width] - b[:, :width]).abs().max().item()
        out[f"{name}_max_abs"] = err
        out[f"{name}_bitwise_share"] = (
            a[:, :width] == b[:, :width]).double().mean().item()
        if not (err <= bar and bool(torch.isfinite(a).all())
                and bool((a[:, :width].diff(dim=1) >= 0).all())
                and torch.equal(a[:, width:], b[:, width:])):
            raise AssertionError(f"macro_chain {what} {name}: max abs {err}"
                                 f" (bar {bar}), or a row not finite, "
                                 f"decreasing, or its copies differ")
    return out


def chain_bitwise(a, b):
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(a, b))


def k8_bound(ctx, arrays, rates, out):
    """Least time for one K8 build: the three (L, S) tables, the
    transition table, the emission blocks' line ids and frequencies and
    the work groups read once, the two row tables written once; against
    2 n^3 f64 operations a (component, shell) system for its Gauss-Jordan
    inverse (fewer than LU and two triangular solves, 8/3 n^3, so the
    bound stays a lower bound), ~6 a (transition, shell) for p, the block
    sum and the normalisation, and ~4 an entry of the row tables (the
    product by d, the clamp, the running sum, the division).  Operations
    at RATES.ops_per_s, 67e12: the H100 SXM's FP64 tensor-core peak (its FP64
    vector peak is half that; K8 uses no tensor cores).  Returns (ms, what
    bounds it, the elimination's operations)."""
    S = rates[0].shape[1]
    read = [arrays[k] for k in ("coef", "k8_refs", "k8_line", "k8_type",
                                "k8_dest", "line_dense", "nu_dense",
                                "k8_base", "k8_size", "k8_t0", "k8_t1")]
    written = [t for t in out if t is not None]
    sizes = ctx.arrays_np["k8_size"].astype(np.float64)
    gj_ops = S * float((2.0 * sizes**3).sum()) if ctx.W else 0.0
    n_ops = (gj_ops + 6.0 * len(ctx.arrays_np["coef"]) * S
             + 4.0 * sum(t.numel() for t in written))
    return bound(nbytes(*rates, *read, *written), n_ops, 0, RATES) + (
        gj_ops,)


def chain_library_inputs(ctx, arrays, rates):
    """The build's (shell, component) systems at their real size n: A = I
    - Q and diag(d), from the plain version's arithmetic, one (A, rhs) a
    size of each power-of-two bucket (each one torch.linalg.solve)."""
    from tardis_torch.opacities import macro_atom_solver as mas

    pn = mas.p_norm(ctx, arrays, *rates)
    deact = mas.deactivation(ctx, arrays, pn)
    out = []
    for bi, meta in enumerate(ctx.bucket_meta):
        A, d = mas.bucket_systems(ctx, arrays, pn, deact, bi)
        Wp, n_cb = meta["Wp"], meta["n_cb"]
        sizes = ctx.arrays_np[f"b{bi}_member_valid"].reshape(
            n_cb, Wp).sum(axis=1)
        S = A.shape[0] // n_cb
        for n in np.unique(sizes):
            n = int(n)
            idx = torch.as_tensor(
                (np.arange(S)[:, None] * n_cb
                 + np.flatnonzero(sizes == n)[None, :]).ravel(),
                device=A.device)
            out.append((A[idx, :n, :n].contiguous(),
                        torch.diag_embed(d[idx, :n])))
        del A, d
    return out


def k8_line(mode, variant, nums, ms, plain_ms, b_ms, b_by, library_ms,
            held, **extra):
    """K8's kernels-line entry for one instantiation."""
    return dict(name=line_name("macro_chain", variant), route="cuda",
                source="tardis_torch/csrc/macro_chain.cu",
                replaces=REPLACES_K8, variant=variant,
                max_abs_err=nums.get("chain_max_abs", nums["emit_max_abs"]),
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, held=held,
                emit_max_abs=nums["emit_max_abs"],
                emit_bitwise_share=nums["emit_bitwise_share"],
                chain_bitwise_share=nums.get("chain_bitwise_share"), **extra)


def k8_ptxas():
    """Registers, spills and static shared bytes of each of K8's
    instantiations, from ptxas's report of the build."""
    from tardis_torch import cuda

    out, name = {}, None
    cuda.library("macro_chain")  # built, with its report, if it was not
    log = cuda.library_path("macro_chain").with_suffix(".log")
    for ln in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '.*?(workspace_kernel|"
                      r"chain_cluster_kernel|chain_large_kernel)"
                      r"(?:ILi(\d+)E)?", ln)
        if m:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
        elif name and ("registers" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.strip())
    return out


def k8_cycle_rates(device, n_shells=3, seed=SEED):
    """K8_CYCLE as a MacroAtomData and seeded (beta, j_blues, stim) (L, S)
    f64 tables on ``device``, with the line frequencies in NU_UNIT."""
    from tardis_torch.atomic.atom_data import MacroAtomData

    t = K8_CYCLE
    n = len(t["coef"])
    macro = MacroAtomData(
        coef=np.asarray(t["coef"], np.float64),
        transition_type=np.asarray(t["transition_type"], np.int8),
        destination_level_id=np.asarray(t["destination_level_id"],
                                        np.int32),
        transition_line_id=np.arange(n, dtype=np.int32),
        block_references=np.asarray(t["block_references"], np.int32),
        line2macro_level_upper=np.asarray(t["line2macro_level_upper"],
                                          np.int32))
    return macro, k8_random_rates(n, n_shells, device, seed), np.linspace(
        0.5, 1.2, n)


def k8_random_rates(n_lines, n_shells, device, seed=SEED):
    """Seeded (beta, j_blues, stim) (L, S) f64 tables on ``device``."""
    gen = np.random.default_rng(seed)
    return tuple(torch.as_tensor(gen.uniform(lo, hi, (n_lines, n_shells)),
                                 device=device)
                 for lo, hi in ((0.1, 1.0), (1e-6, 1e-4), (0.5, 1.0)))


def k8_mixed_macro(small, large):
    """The macro tables of two atoms side by side, ``large``'s levels,
    lines and transitions after ``small``'s, as one MacroAtomData, and
    their lines' frequencies in NU_UNIT."""
    from tardis_torch.atomic.atom_data import MacroAtomData
    from tardis_torch.transport.tables import NU_UNIT

    a, b = small.macro_atom, large.macro_atom
    levels = len(a.block_references) - 1
    dest = np.where(b.destination_level_id >= 0,
                    b.destination_level_id + levels, b.destination_level_id)
    macro = MacroAtomData(
        coef=np.concatenate([a.coef, b.coef]),
        transition_type=np.concatenate([a.transition_type,
                                        b.transition_type]),
        destination_level_id=np.concatenate(
            [a.destination_level_id, dest]).astype(np.int32),
        transition_line_id=np.concatenate(
            [a.transition_line_id,
             b.transition_line_id + small.n_lines]).astype(np.int32),
        block_references=np.concatenate(
            [a.block_references,
             b.block_references[1:] + a.block_references[-1]]).astype(
                 np.int32),
        line2macro_level_upper=np.concatenate(
            [a.line2macro_level_upper,
             b.line2macro_level_upper + levels]).astype(np.int32))
    return macro, np.concatenate([small.line_nu, large.line_nu]) / NU_UNIT


def chain_cases(atom, rates, large_atom, wide):
    """K8's check cases (what, mode, macro table, line frequencies, rates,
    shells): the bench problem in both modes at its shells and at
    K8_WIDE_SHELLS, the wide element's three 600-level components at
    K8_WIDE_LEVELS_SHELLS shells (12 systems), the large-ion problem at the
    bench's shells (360 systems) and the mixed build, each on seeded rates
    but the bench problem's (its plasma)."""
    from tardis_torch.transport.tables import NU_UNIT

    device = rates[0].device
    S = rates[0].shape[1]
    nu = atom.line_nu / NU_UNIT
    cases = [(f"bench {mode}", mode,
              atom.macro_atom if mode == "macroatom" else atom.downbranch,
              nu, rates if shells == S else shells_repeated(rates, shells),
              shells)
             for mode in ("macroatom", "downbranch")
             for shells in (S, K8_WIDE_SHELLS)]
    for what, at, shells in (("wide", wide, K8_WIDE_LEVELS_SHELLS),
                             ("large_ion", large_atom, S)):
        cases.append((what, "macroatom", at.macro_atom,
                      at.line_nu / NU_UNIT,
                      k8_random_rates(at.n_lines, shells, device), shells))
    macro, mixed_nu = k8_mixed_macro(atom, wide)
    cases.append(("mixed", "macroatom", macro, mixed_nu,
                  k8_random_rates(len(mixed_nu), K8_MIXED_SHELLS, device),
                  K8_MIXED_SHELLS))
    return cases


def check_chain_build(atom, ps, large_atom):
    """K8 (``macro_chain``) against its plain version on the card, each of
    its instantiations (``k8_plan``) on ``chain_cases``: the cluster one
    and downbranch at the bench shape and at K8_WIDE_SHELLS shells, the
    large-system one on the wide element's 12 systems and on the large-ion
    problem's 360, and the mixed build (both, one launch each); each within
    K8_CHAIN_ATOL / K8_EMIT_ATOL with the shares of entries equal bit for
    bit, the copied columns bit for bit, every row non-decreasing, and two
    K8 calls bit for bit equal; each timed as device time of queued calls
    (``ms``, with ``held``) beside the plain version (``plain_ms``, CUDA
    events around each call) and its bound, with its plans (blocks a
    system, panel, blocks, rounds and their fill, the work groups each
    takes) and one torch.linalg.solve a component size of the same
    systems at their real size (``library_ms``, summed, the yardstick; the
    port never calls it), and at the bench shape (macroatom) with CUDA
    events around ``solve_macro_chain`` as the main path calls it
    (``entry_ms``).  The large-system instantiation is also forced on the
    bench build (``large_on_bench``): bit for bit the cluster one's tables,
    since it takes the same products in the same order.  Then the singular
    component (K8_CYCLE): the cycle's rows the self-deactivation step and
    every row the plain version's, bit for bit.  Returns the main path's
    chain tables and K8's kernels-line entries by instantiation (the
    cluster one's at the bench shape, the large one's at the large-ion
    shape, downbranch's at the bench shape)."""
    from tardis_torch.atomic.synthetic import make_synthetic_atom_data
    from tardis_torch.opacities import macro_atom_solver as mas
    from tardis_torch.transport.tables import NU_UNIT

    nu = atom.line_nu / NU_UNIT
    device = ps.beta_sobolev.device
    rates = tuple(t.to(torch.float64).contiguous() for t in (
        ps.beta_sobolev, ps.j_blues, ps.stimulated_emission_factor))
    S = rates[0].shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wide = make_synthetic_atom_data(
        n_levels=K8_WIDE_LEVELS, max_level_jump=60).prepare(
            selected_atoms=[8], line_interaction_type="macroatom")
    entries, checks, chain = {}, {}, None
    say("k8_instantiations", ptxas=k8_ptxas())
    for what, mode, macro, line_nu, r, shells in chain_cases(
            atom, rates, large_atom, wide):
        ctx = mas.chain_context(macro, mode, line_nu)
        arrays = ctx.arrays(device)
        plans = mas.k8_plan(ctx, shells, sms,
                            mas.k8_active_clusters(device))
        variants = "+".join(p.variant for p in plans)
        what = f"{what} {variants} {shells} shells"
        k = mas.macro_chain(ctx, arrays, *r)
        if not chain_bitwise(k, mas.macro_chain(ctx, arrays, *r)):
            raise AssertionError(f"macro_chain {what}: two runs differ")
        plain_ms, p = cuda_ms(lambda: mas.chain_tables(
            ctx, arrays, mas.p_norm(ctx, arrays, *r)),
            1 if ctx.k8_n_max > 384 else 3)
        nums = compare_chain(ctx, k, p, what)
        del p
        ms, _, held = cuda_ms_queued(
            lambda: mas.macro_chain(ctx, arrays, *r), 20, report_hold=True)
        b_ms, b_by, gj_ops = k8_bound(ctx, arrays, r, k)
        nums.update(ms=ms, held=held, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, gj_ops=gj_ops,
                    plan=[plan._asdict() for plan in plans])
        library_ms = None
        if ctx.W:
            solves = chain_library_inputs(ctx, arrays, r)
            library_ms, _ = cuda_ms(
                lambda: [torch.linalg.solve(A, rhs) for A, rhs in solves],
                10)
            del solves
            nums.update(library_ms=library_ms)
        main = what.startswith("bench") and shells == S
        if main and mode == "macroatom":
            entry_ms, chain = cuda_ms(lambda: mas.solve_macro_chain(
                macro, *rates, mode=mode, line_nu_scaled=nu), 10)
            forced = mas.k8_launch(ctx, arrays, *r, shape="large")
            nums.update(entry_ms=entry_ms,
                        large_on_bench=dict(
                            plan=forced[2][0]._asdict(),
                            bitwise_to_cluster=chain_bitwise(k, forced[:2])))
            if not nums["large_on_bench"]["bitwise_to_cluster"]:
                raise AssertionError("macro_chain: the large-system "
                                     "instantiation on the bench build "
                                     "differs from the cluster one")
            del forced
        if (main or what.startswith("large_ion")) and len(plans) == 1:
            entries[plans[0].variant] = k8_line(
                mode, plans[0].variant, nums, ms, plain_ms, b_ms, b_by,
                library_ms, held, plan=plans[0]._asdict(),
                **({"entry_ms": nums["entry_ms"]} if "entry_ms" in nums
                   else {}))
        say("chain_build", what=what, mode=mode, shells=shells,
            states=ctx.M, chain_width=ctx.W, emit_width=ctx.We, **nums)
        checks[what] = {key: nums[key] for key in (
            "ms", "plain_ms", "bound_ms", "library_ms", "chain_max_abs",
            "emit_max_abs") if key in nums}
        checks[what]["plan"] = [(p.variant, p.cluster, p.blocks, p.rounds,
                                 p.fill) for p in plans]
        del k
        torch.cuda.empty_cache()
    # the singular component: a closed internal cycle without emission
    macro, r, cycle_nu = k8_cycle_rates(device)
    ctx = mas.chain_context(macro, "macroatom", cycle_nu)
    arrays = ctx.arrays(device)
    k = mas.macro_chain(ctx, arrays, *r)
    p = mas.chain_tables(ctx, arrays, mas.p_norm(ctx, arrays, *r))
    rows = k[0].reshape(-1, ctx.M, ctx.W + 1)[:, list(K8_CYCLE_LEVELS),
                                               :ctx.W]
    step = (torch.arange(ctx.W, device=device)[None, :]
            >= torch.arange(len(K8_CYCLE_LEVELS), device=device)[:, None])
    p_rows = p[0].reshape(-1, ctx.M, ctx.W + 1)[:, list(K8_CYCLE_LEVELS),
                                                 :ctx.W]
    nums = compare_chain(ctx, k, p, "singular component")
    if not (torch.equal(rows, p_rows)
            and torch.equal(rows, step.float().expand_as(rows))):
        raise AssertionError("macro_chain: the singular component's rows "
                             "are not the plain version's step")
    checks["singular"] = dict(
        variants=[p.variant for p in mas.k8_plan(ctx, 3, sms)],
        cycle_rows_bitwise=True, **nums)
    say("chain_build_singular", **checks["singular"])
    for entry in entries.values():
        entry["checks"] = checks
    return chain, entries


def events_numbers(events, stopped):
    """events_per_packet (mean, p99, max, stopped) and the lane efficiency
    of a warp of 32 consecutive packets."""
    return dict(events_per_packet=event_distribution(events, stopped),
                lane_efficiency=lane_efficiency(events))


def compare_transport_loop(tables, pool, run_key, cap, last_interaction=False,
                           tracker_length=0, line_estimators=True,
                           max_events=None):
    """K1 against its plain version on one pool (mu, nu, w; w None for the
    simple pool), with spawn-record capacity ``cap`` (0: none), the
    trackers and the line estimators as asked.  Both versions draw the
    same bits and take the same f32 steps (no FMA contraction), so every
    packet must end bitwise equal, with bitwise equal last-interaction and
    tracker rows, and write the same spawn records (in another order:
    compared as sorted multisets); the f64 sums differ only in the order of
    their atomic adds, hence rtol 1e-9; without line estimators neither
    side has a line difference array.  With ``max_events`` both sides stop
    a packet there and must leave the same packets unfinished (without it,
    none).  Timed as CUDA events around each call (``ms``) and as device
    time of queued calls (``device_ms``).  Returns the phase's numbers and
    both outputs."""
    from tardis_torch.transport.kernel import (
        transport_loop,
        transport_loop_plain,
    )

    mu, nu, w = pool
    n = mu.shape[0]
    kw = dict(vpacket_capacity=cap, pool_w=w,
              last_interaction=last_interaction,
              tracker_length=tracker_length, line_estimators=line_estimators)
    if max_events is not None:
        kw["max_events"] = max_events
    ms, k = cuda_ms(lambda: transport_loop(tables, mu, nu, run_key, **kw), 5)
    del k
    device_ms, k = cuda_ms_queued(
        lambda: transport_loop(tables, mu, nu, run_key, **kw), 5)
    # the plain version's lockstep loop refills PLAIN_LANES lanes from the
    # pool; per-packet results do not depend on the lane count
    plain_ms, p = cuda_ms(
        lambda: transport_loop_plain(tables, mu, nu, run_key,
                                     batch_size=PLAIN_LANES, **kw), 1,
        warmup=False)
    sk = torch.sign(k.out[:, 0])
    sp = torch.sign(p.out[:, 0])
    agree = (sk == sp).double().mean().item()
    bitwise = (k.out == p.out).all(dim=1).double().mean().item()
    rows_equal = bool(torch.equal(k.last_interaction, p.last_interaction)
                      and torch.equal(k.tracker, p.tracker))
    sums = ("est_j", "est_nubar") + (("line_diff",) if line_estimators
                                     else ())
    rels = {name: rel_err(getattr(k, name), getattr(p, name))
            for name in sums}
    rels["L_window"] = rel_err(k.summary[0:1], p.summary[0:1])
    rels["L_reabsorbed"] = rel_err(k.summary[1:2], p.summary[1:2])
    events = k.summary[2].item(), p.summary[2].item()
    immortal = int(k.summary[3].item()), int(p.summary[3].item())
    records = int(k.vp_count[0]), int(p.vp_count[0])
    line_diff_sizes = k.line_diff.numel(), p.line_diff.numel()
    want_size = 2 * (tables.n_lines + 1) * tables.n_shells * line_estimators
    n_rec = k.n_vp_records
    rows_k = sorted_rows(k.vp_records[:n_rec])
    rows_p = sorted_rows(p.vp_records[:n_rec])
    records_equal = (records[0] == records[1]
                     and k.n_vp_records == p.n_vp_records
                     and torch.equal(rows_k, rows_p))
    if not (bitwise == 1.0 and bool((sk != 0).all()) and rows_equal
            and all(r <= 1e-9 for r in rels.values())
            and events[0] == events[1] and immortal[0] == immortal[1]
            and (max_events is not None or immortal == (0, 0))
            and records_equal and records[0] <= cap
            and (cap == 0 or records[0] > n)
            and line_diff_sizes == (want_size, want_size)
            and int(p.events.sum()) == events[1]):
        raise AssertionError(
            f"transport_loop at {n} packets: bitwise packets {bitwise}, "
            f"status agreement {agree}, tracker rows equal {rows_equal}, "
            f"max rel {rels}, events {events}, immortal {immortal}, "
            f"records {records} of capacity {cap}, "
            f"records equal {records_equal}, line_diff sizes "
            f"{line_diff_sizes} (want {want_size})")
    max_abs = max([(getattr(k, name) - getattr(p, name)).abs().max().item()
                   for name in ("out", "summary") + sums]
                  + ([(rows_k - rows_p).abs().max().item()] if n_rec else []))
    extra = (0 if w is None else nbytes(w)) + nbytes(k.last_interaction,
                                                     k.tracker)
    tally = getattr(p, "walk_tally", None)
    b_ms, b_by = k1_bound(tables, n, events[0], RATES, n_rec, extra,
                          line_estimators,
                          walk_jumps=tally["jumps"] if tally else 0)
    numbers = dict(n=n, line_estimators=line_estimators, ms=ms,
                   device_ms=device_ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, events=events[0],
                   events_per_s=events[0] / (device_ms * 1e-3),
                   **events_numbers(p.events, immortal[1]),
                   records=records[0],
                   record_capacity=cap, status_agreement=agree,
                   bitwise_packets=bitwise, tracker_rows_bitwise=rows_equal,
                   records_bitwise_as_multiset=records_equal, max_rel=rels,
                   max_abs_err=max_abs,
                   search_fallbacks=int(k.search_fallbacks[0]))
    if tally:
        numbers["walk"] = walk_numbers(tally, tables.max_jumps)
    return numbers, k, p


def walk_numbers(tally, max_jumps):
    """What the plain version's walks did: walks, jumps a walk (mean,
    max) and the share that reached the last jump without emitting."""
    walks = max(tally.get("walks", 0), 1)
    return dict(walks=tally.get("walks", 0),
                jumps_per_walk_mean=tally.get("jumps", 0) / walks,
                jumps_per_walk_max=tally.get("max_jumps", 0),
                cap=max_jumps, capped_share=tally.get("capped", 0) / walks)


def k1_entry(name, replaces, numbers):
    entry = dict(name=name, route="cuda",
                 source="tardis_torch/csrc/transport_loop.cu",
                 replaces=replaces, max_abs_err=numbers["max_abs_err"],
                 ms=numbers["ms"], plain_ms=numbers["plain_ms"],
                 bound_ms=numbers["bound_ms"], bound_by=numbers["bound_by"],
                 library_ms=None)
    if "device_ms" in numbers:
        entry["device_ms"] = numbers["device_ms"]
    return entry


def main_tables(state, atom, ps, chain, **options):
    from tardis_torch.transport.tables import build_transport_tables

    return build_transport_tables(
        state.geometry, ps.electron_densities, ps.tau_prefix, atom,
        "macroatom", macro_chain=chain, **options)


REPLACES_K1 = {"main": "tardis_tpu/transport/kernel.py:425",
               "relativity": "tardis_tpu/transport/kernel.py:491",
               "options": "tardis_tpu/transport/kernel.py:798",
               "v_inner": "tardis_tpu/transport/kernel.py:969"}


def path_tables(state, atom, ps, chain):
    """Each path's transport tables (the main path's problem with that
    path's options)."""
    return {path: main_tables(state, atom, ps, chain, **opts["tables"])
            for path, opts in PATHS.items()}


def k1_variant(path, tables, pool, line_estimators=True):
    """The K1 instantiation ``path`` selects on these tables and pool, with
    or without line estimators (its convergence iterations run without,
    its final iteration with)."""
    from tardis_torch.transport.kernel import variant

    opts = PATHS[path]
    return variant(tables, pool[2], opts["last_interaction"],
                   opts["tracker_length"], line_estimators)


def build_variants(tables, pools, iip_tables=(), walk_tables=()):
    """Build, in parallel, the K1 and K4 instantiations the paths select
    on their own tables and pools, K1's continuum instantiations of
    ``iip_tables`` (with the weighted pool and last-interaction rows, as
    the IIP paths run them; the IIP path's also with spawn records), K1's walk instantiations of ``walk_tables``
    (with and without line estimators), K7's NONHOM_CASES and K6's
    GAMMA_OPTIONS; returns the wall seconds and the ptxas register
    lines."""
    from tardis_torch import cuda
    from tardis_torch.energy_input import gamma_kernel
    from tardis_torch.transport import kernel, nonhomologous, vpacket

    libs = [("transport_loop", kernel.library_defines(kernel.variant(
        t, pools["relativistic"][N_PACKETS][2], last_interaction=True,
        vpacket_capacity=records)))
        for t in iip_tables for records in (0, 1)
        if not records or not (t.continuum.two_photon
                               or t.continuum.adiabatic)]
    libs += [("nonhom_loop", nonhomologous.library_defines(flags))
             for flags in dict.fromkeys(f for _, f, _, _ in NONHOM_CASES)]
    libs += [("gamma_step", gamma_kernel.library_defines(
        gamma_kernel.variant(**opts))) for opts in GAMMA_OPTIONS.values()]
    libs += list(dict.fromkeys(
        ("transport_loop", kernel.library_defines(kernel.variant(
            t, line_estimators=line_estimators)))
        for t in walk_tables for line_estimators in (False, True)))
    for path, opts in PATHS.items():
        t = tables[path]
        for line_estimators in (False, True):
            flags = k1_variant(path, t, pools[opts["pool"]][N_PACKETS],
                               line_estimators)
            libs.append(("transport_loop", kernel.library_defines(flags)))
        if opts["records"]:
            libs.append(("vpacket_volley", vpacket.library_defines(t)))
    return cuda.build(libs), ptxas_lines(libs)


def tracker_counts(tables, k):
    """What K1's trackers show: last-interaction types, and packets
    reflected at the core within the r-packet tracker's events (a boundary
    event that leaves a packet in shell 0 moving outward); with an albedo,
    at least one packet must be reflected."""
    counts = {}
    if k.last_interaction.numel():
        li = k.last_interaction[:, 0]
        counts.update(line_interactions=int((li == 2).sum()),
                      escat_interactions=int((li == 1).sum()),
                      never_interacted=int((li == 0).sum()))
    if k.tracker.numel():
        tr = k.tracker
        counts.update(
            reflections_in_tracker=int(((tr[:, :, 4] == 3)
                                        & (tr[:, :, 3] == 0)
                                        & (tr[:, :, 5] > 0)).sum()),
            reabsorbed=int((k.out[:, 0] < 0).sum()))
        if (tables.inner_boundary_albedo > 0.0
                and counts["reflections_in_tracker"] == 0):
            raise AssertionError("transport_loop: no packet reflected")
    return counts


def check_transport_loop(path, tables, pools):
    """K1 as ``path`` runs it, each instantiation at its shape, on the pool
    drawn with that iteration's key: the convergence iterations' without
    line estimators (N_PACKETS, no records; four of the five launches of
    the main and relativity paths, two of the options path's three) and
    the final iteration's with them (FINAL_PACKETS and
    VPACKET_RECORDS_PER_PACKET records a packet where the path writes
    spawn records, else N_PACKETS with the last iteration's key).  Returns
    the two kernels-line entries by ``convergence`` and ``final``, and the
    final iteration's records (None without records)."""
    from tardis_torch.transport.kernel import variant_name
    from tardis_torch.transport.solver import (
        VPACKET_RECORDS_PER_PACKET,
        iteration_keys,
    )

    opts = PATHS[path]
    kw = dict(last_interaction=opts["last_interaction"],
              tracker_length=opts["tracker_length"])
    final_n = FINAL_PACKETS if opts["records"] else N_PACKETS
    final_key = ITERATIONS - 1 if opts["records"] else OPTIONS_ITERATIONS - 1
    cases = (("convergence", N_PACKETS, 0, 0, False),
             ("final", final_n, final_key,
              VPACKET_RECORDS_PER_PACKET * final_n if opts["records"] else 0,
              True))
    if path == "main":
        # the detailed_nlte path's convergence iterations: the final
        # instantiation (line estimators) at N_PACKETS without records
        cases += (("detailed_convergence", N_PACKETS, 0, 0, True),)
    entries, records = {}, None
    for role, n, iteration, cap, line_estimators in cases:
        name = line_name("transport_loop", variant_name(k1_variant(
            path, tables, pools[n], line_estimators)))
        _, run_key = iteration_keys(SEED, iteration)
        numbers, k, _ = compare_transport_loop(
            tables, pools[n], run_key, cap, line_estimators=line_estimators,
            **kw)
        numbers.update(tracker_counts(tables, k))
        say("check_transport_loop_records" if cap else
            "check_transport_loop", line=name, role=role, **numbers)
        if role == "detailed_convergence":
            entries["final"][role] = {
                key: numbers[key] for key in (
                    "n", "ms", "device_ms", "plain_ms", "bound_ms",
                    "bound_by", "max_abs_err")}
        else:
            entries[role] = k1_entry(name, REPLACES_K1[path], numbers)
        if cap:
            records = k.vp_records[:k.n_vp_records]
        del k
    return entries, records


def check_vpacket_volley(tables, records, device, config=BENCH_CONFIG):
    """K4 on K1's spawn records at a path's shapes (the main path's final
    iteration's records, or the full-relativity records of
    ``check_transport_loop_relativity`` through K4's full-relativity
    branch; 2 virtual packets, 10,000 bins), one launch over every ray as
    on the paths; the plain version takes them in chunks.  Per-ray
    frequencies and energies must be bitwise equal (same f32 steps, f64
    exp); the f64 histogram differs only in the order of its adds, hence
    rtol 1e-9.  Timed by CUDA events around each call (``ms``) and as
    device time of queued calls (``device_ms``); the floor is the record
    of the ray with the most segments alone (``floor_ms``, device time).
    The line list's bucket table (``vpacket.line_buckets``) is printed
    with its entries, bytes and lines a bucket."""
    from tardis_torch.config.reader import config_from_dict
    from tardis_torch.spectrum.base import frequency_grid
    from tardis_torch.transport.tables import NU_UNIT
    from tardis_torch.transport.vpacket import (
        line_buckets,
        trace_vpacket_records,
        trace_vpacket_records_plain,
        variant_name,
    )

    spec = config_from_dict(config).spectrum
    edges = torch.as_tensor(
        (frequency_grid(spec.start, spec.stop, spec.num) / NU_UNIT)
        .astype(np.float32), device=device)
    args = (tables, records, N_VPACKETS, edges)
    ms, k = cuda_ms(lambda: trace_vpacket_records(*args), 5)
    device_ms, k = cuda_ms_queued(lambda: trace_vpacket_records(*args), 5)
    plain_ms, p = cuda_ms(lambda: trace_vpacket_records_plain(*args), 1,
                          warmup=False)
    by = trace_vpacket_records.launches_by_variant
    before = sum(by.values())
    kr = trace_vpacket_records(*args, return_packets=True)
    launches = sum(by.values()) - before
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
    # the longest ray's record alone: the floor of any schedule
    longest = int(torch.argmax(pr.segments))
    rec = longest // N_VPACKETS
    floor_ms, _ = cuda_ms_queued(lambda: trace_vpacket_records(
        tables, records[rec:rec + 1], N_VPACKETS, edges), 20)
    buckets = line_buckets(tables)
    per_bucket = torch.diff(buckets.counts).float()
    bracket = float(per_bucket[per_bucket > 0].mean())
    # per segment: the bucket (two table reads, ~8 operations), a
    # bisection of its bracket (~4 operations a probe over the mean
    # occupied bucket) and ~30 operations of geometry and tau; per ray:
    # ~40 operations of direction, weight and Doppler factors, the f64 exp
    # and ~10 for the bin
    n_ops = segments[0] * 30 + n_rays * (40 + 10)
    n_int = segments[0] * (8 + 4 * math.ceil(math.log2(bracket + 1)))
    in_bytes = nbytes(records, tables.r_inner, tables.r_outer, tables.chi_e,
                      tables.line_nu, tables.prefix, buckets.counts, edges)
    b_ms, b_by = bound(in_bytes + nbytes(k.hist), n_ops, n_int, RATES)
    rel_branch = tables.full_relativity
    name = line_name("vpacket_volley", variant_name(tables))
    say("check_vpacket_volley", line=name, records=R,
        rays=n_rays, bins=M,
        segments=segments[0], segments_per_ray=segments[0] / n_rays,
        longest_ray_segments=int(pr.segments[longest]), ms=ms,
        device_ms=device_ms, floor_ms=floor_ms,
        segments_per_s=segments[0] / (device_ms * 1e-3),
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        kernel_launches=launches,
        plain_chunks=math.ceil(n_rays / 8_388_608),
        bucket_table=dict(entries=buckets.n_buckets,
                          bytes=nbytes(buckets.counts), shift=buckets.shift,
                          lines_per_bucket_mean=float(per_bucket.mean()),
                          lines_per_occupied_bucket_mean=bracket,
                          lines_per_bucket_max=int(per_bucket.max())),
        rays_bitwise=rays_bitwise, hist_max_rel=rel, max_abs_err=max_abs)
    return dict(
        name=name, route="cuda",
        source="tardis_torch/csrc/vpacket_volley.cu",
        replaces=("tardis_tpu/transport/vpacket.py:"
                  + ("260" if rel_branch else "224")),
        max_abs_err=max_abs, ms=ms, device_ms=device_ms, floor_ms=floor_ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )


def check_formal_integral(sim, device):
    """K5 on the main path's own source-function tables (1,000 frequencies
    x 80 impact parameters).  Same f32 steps in both versions, so I p must
    be bitwise equal, with equal event counts and no capped ray.  Timed by
    CUDA events around each call (``ms``) and as device time of queued
    calls (``device_ms``); the per-ray event distribution comes from the
    plain version, and the floor is the ray with the most events alone
    (``floor_ms``, device time; its I p must be the full call's)."""
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
    device_ms, k = cuda_ms_queued(lambda: integrate_rays(**a), 5)
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
    # the ray with the most events alone: the floor of any schedule
    f, j = divmod(int(torch.argmax(p.events)), P)
    one = dict(a, nu_grid=a["nu_grid"][f:f + 1], p_grid=a["p_grid"][j:j + 1],
               i_inner=a["i_inner"][f:f + 1])
    floor_ms, alone = cuda_ms_queued(lambda: integrate_rays(**one), 20)
    if not torch.equal(alone.i_p[0, 0], k.i_p[f, j]):
        raise AssertionError("formal_integral: the longest ray alone differs")
    # ~16 f32 operations per line event (zeta, J average, e-scatter source,
    # attenuation), ~20 per boundary event (two sqrt, the source), and the
    # start-line search
    n_ops = 16 * n_line + 20 * n_boundary
    b_ms, b_by = bound(nbytes(*a.values()) + nbytes(k.i_p), n_ops,
                       F * P * 4 * math.ceil(math.log2(L + 1)), RATES)
    say("check_formal_integral", frequencies=F, impact_parameters=P,
        lines=L, shells=S, line_events=n_line, boundary_events=n_boundary,
        capped=counts[0][COUNT_CAPPED],
        events_per_ray=event_distribution(p.events.reshape(-1), 0),
        lane_efficiency_thread_a_ray=lane_efficiency(p.events.reshape(-1)),
        longest_ray=dict(frequency=f, impact_parameter=j,
                         events=int(p.events[f, j])),
        ms=ms, device_ms=device_ms, floor_ms=floor_ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, bitwise=bitwise, max_abs_err=max_abs)
    return dict(
        name="formal_integral", route="cuda",
        source="tardis_torch/csrc/formal_integral.cu",
        replaces="tardis_tpu/spectrum/formal_integral.py:137",
        max_abs_err=max_abs, ms=ms, device_ms=device_ms, floor_ms=floor_ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )


def wrappers():
    from tardis_torch.benchmarks import probe2
    from tardis_torch.plasma.line_tables import line_tables
    from tardis_torch.spectrum.formal_integral import integrate_rays
    from tardis_torch.energy_input.gamma_kernel import gamma_step_transport
    from tardis_torch.opacities.macro_atom_solver import macro_chain
    from tardis_torch.transport.kernel import transport_loop
    from tardis_torch.transport.nonhomologous import nonhom_transport_loop
    from tardis_torch.transport.source import blackbody_source
    from tardis_torch.transport.vpacket import trace_vpacket_records

    return {"line_tables": line_tables, "blackbody_source": blackbody_source,
            "transport_loop": transport_loop,
            "vpacket_volley": trace_vpacket_records,
            "formal_integral": integrate_rays,
            "nonhom_loop": nonhom_transport_loop,
            "gamma_step": gamma_step_transport, "macro_chain": macro_chain,
            "scale2": probe2.scale2,
            "take_1d": probe2.take_1d,
            "take_along_rows": probe2.take_along_rows}


def reset_launches():
    for w in wrappers().values():
        if hasattr(w, "launches_by_variant"):
            w.launches_by_variant.clear()
        if hasattr(w, "launches"):
            w.launches = 0


def read_launches():
    """Launches by kernels-line name: K5, and every variant K1, K2, K3,
    K4, K6 and K7 launched under its own line
    (``transport_loop[full_relativity+last_interaction+weights]``,
    ``line_tables[estimators]``)."""
    out = {}
    for kernel, w in wrappers().items():
        if hasattr(w, "launches_by_variant"):
            out.update((line_name(kernel, v), n)
                       for v, n in w.launches_by_variant.items())
        else:
            out[kernel] = w.launches
    return out


def run_path(phase, config, atom, device, expected, bands=True,
             use_macro_chain=None, per_iteration=None, integrated=True):
    """run_tardis on ``config`` with the launch counts reset to 0 just
    before and read just after; every kernels line in ``expected`` must
    have launched exactly that often (None: at least once) and every other
    line, any variant of a wrapper included, never.  With ``bands``, the
    final iteration's luminosity ratios must lie in the bands of PERF.md
    section 2 (integrated / real only with ``integrated``: a run without
    the formal integral has no integrated spectrum).  With ``use_macro_chain``, the run is Simulation.from_config
    with ``sim.transport.use_macro_chain`` set to it before the run.
    ``per_iteration()``, where given, returns numbers for each iteration's
    line."""
    from tardis_torch.config.reader import config_from_dict
    from tardis_torch.simulation.base import Simulation, run_tardis

    marks = []

    def on_iteration(sim):
        torch.cuda.synchronize()
        now = time.perf_counter()
        res = sim.last_transport_result
        ratio = (res.emitted_luminosity(*sim._lum_nu_window())
                 / sim.state.luminosity_requested)
        say("iteration", path=phase, index=sim.iterations_executed - 1,
            packets=res.n_packets, wall_s=now - marks[-1],
            t_inner=sim.state.t_inner, L_emitted_over_requested=ratio,
            events=res.n_events, vp_records=res.vp_records,
            **(per_iteration() if per_iteration else {}))
        marks.append(now)

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks.append(t0)
    if use_macro_chain is None:
        sim = run_tardis(config, atom_data=atom, device=device,
                         callbacks=[on_iteration])
    else:
        with torch.no_grad():
            sim = Simulation.from_config(config_from_dict(config),
                                         atom_data=atom, device=device)
            sim.transport.use_macro_chain = use_macro_chain
            sim.add_callback(on_iteration)
            sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()

    res = sim.last_transport_result
    final_ratio = (res.emitted_luminosity(*sim._lum_nu_window())
                   / sim.state.luminosity_requested)
    spectra = {"real": sim.spectrum_real, "virtual": sim.spectrum_virtual,
               "integrated": sim.spectrum_integrated}
    spectra = {k: v for k, v in spectra.items() if v is not None}
    finite = bool(
        all(np.isfinite(s.luminosity_nu).all() for s in spectra.values())
        and np.isfinite(res.output_nu).all()
        and all(np.isfinite(h.t_radiative).all()
                and np.isfinite(h.dilution_factor).all()
                for h in sim.history))
    lum = {k: s.luminosity for k, s in spectra.items()}
    virt_ratio = lum.get("virtual", np.nan) / lum["real"]
    int_ratio = lum.get("integrated", np.nan) / lum["real"]
    n_total = (sim.no_of_packets * (sim.iterations - 1)
               + sim.last_no_of_packets)
    say(phase, wall_s=wall, packets=n_total, packets_per_s=n_total / wall,
        launches=launches, final_L_emitted_over_requested=final_ratio,
        spectrum_bins=int(sim.spectrum_real.luminosity_nu.size),
        luminosity=lum, virtual_over_real=virt_ratio,
        integrated_over_real=int_ratio, vp_records=res.vp_records,
        finite=finite, immortal=res.n_immortal)
    if not finite:
        raise AssertionError(f"{phase} produced non-finite values")
    if bands and not 0.8 <= final_ratio <= 1.2:
        raise AssertionError(f"{phase}: final L_emitted/L_requested "
                             f"{final_ratio}")
    if bands and not 0.85 <= virt_ratio <= 1.18:
        raise AssertionError(f"{phase}: virtual / real luminosity "
                             f"{virt_ratio}")
    if bands and integrated and not 0.7 <= int_ratio <= 1.4:
        raise AssertionError(f"{phase}: integrated / real luminosity "
                             f"{int_ratio}")
    check_launches(phase, launches, expected)
    return sim, launches, wall


def import_support(*names):
    """Whether every module of ``names`` imports here; returns (True, None)
    or (False, the import that failed)."""
    for name in names:
        try:
            importlib.import_module(name)
        except ImportError as err:
            return False, f"{name}: {err}"
    return True, None


def hdf_support():
    """Whether the carsus loader can run here: its imports, h5py and
    pandas; returns (True, None) or (False, the import that failed)."""
    return import_support("h5py", "pandas")


def walk_path_tables(state, atom, ps):
    """K1's walk tables on the bench problem in macroatom and downbranch
    mode (``solve_macro_state``, timed alone, and the transport tables
    that carry them); returns the tables by mode and the build numbers."""
    from tardis_torch.opacities.macro_atom_solver import solve_macro_state
    from tardis_torch.transport.tables import build_transport_tables

    tables, numbers = {}, {}
    for mode in ("macroatom", "downbranch"):
        macro = atom.downbranch if mode == "downbranch" else atom.macro_atom
        ms, walk = cuda_ms(lambda: solve_macro_state(
            macro, ps.beta_sobolev, ps.j_blues,
            ps.stimulated_emission_factor), 5)
        tables[mode] = build_transport_tables(
            state.geometry, ps.electron_densities, ps.tau_prefix, atom, mode,
            macro_walk=walk)
        numbers[mode] = dict(build_ms=ms, table_bytes=nbytes(*walk),
                             transitions=int(walk.dest.shape[0]),
                             levels=int(walk.block_start.shape[0] - 1),
                             max_jumps=tables[mode].max_jumps)
    return tables, numbers


def check_walk_loop(tables, build, pools):
    """K1's walk instantiations against their plain version (WALK_CASES:
    macroatom without line estimators at N_PACKETS, with them and 8
    spawn records a packet at FINAL_PACKETS, downbranch at N_PACKETS),
    held as compare_transport_loop holds the chain's: every packet and
    event count bitwise, the records as a multiset, the f64 sums within
    1e-9.  Prints each case and one ``walk`` line (jumps a macro-atom
    event, mean and max, and the share of walks at the cap, from the plain
    version's walks; the walk tables' bytes and build ms); returns the
    kernels-line entries by role (downbranch, the convergence
    instantiation with one jump, inside the convergence entry)."""
    from tardis_torch.transport.kernel import variant, variant_name
    from tardis_torch.transport.solver import (
        VPACKET_RECORDS_PER_PACKET,
        iteration_keys,
    )

    entries, walks = {}, {}
    for role, mode, n, line_estimators in WALK_CASES:
        t = tables[mode]
        cap = VPACKET_RECORDS_PER_PACKET * n if line_estimators else 0
        _, run_key = iteration_keys(SEED, ITERATIONS - 1 if cap else 0)
        numbers, k, _ = compare_transport_loop(
            t, pools[n], run_key, cap, line_estimators=line_estimators)
        name = line_name("transport_loop", variant_name(variant(
            t, line_estimators=line_estimators)))
        say("check_walk_loop", line=name, role=role, mode=mode, **numbers)
        walks[role] = numbers.pop("walk")
        del k
        torch.cuda.empty_cache()
        if role == "downbranch":
            conv = entries["convergence"]
            if name != conv["name"]:
                raise AssertionError(f"downbranch walks {name}, not "
                                     f"{conv['name']}")
            conv["max_abs_err"] = max(conv["max_abs_err"],
                                      numbers["max_abs_err"])
            conv["downbranch"] = {key: numbers[key] for key in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")}
        else:
            entries[role] = k1_entry(name, REPLACES_WALK, numbers)
    say("walk", jumps=walks, tables=build)
    return entries


REPLACES_WALK = "tardis_tpu/transport/kernel.py:281"

# tests/test_full_e2e.py's line list (105,948 lines of near-degenerate
# multiplets; shell 0's tau prefix 1.42e9, where an f32 ulp is 128), a
# pool at 5 t_inner as tests/test_torch_large_prefix.py draws it
LARGE_PREFIX_PACKETS = 65_536
LARGE_PREFIX_HOT = 5.0


def large_prefix_tables(device):
    """The large-prefix problem on the card: the port's generator
    (n_levels=55, fine_structure_split=3e-6) on the bench model, its LTE
    plasma (K3's prefix), and the transport tables with the macro-atom
    chain, with the walk, and with the chain under full relativity (whose
    search the margin guard checks on near-degenerate multiplets).  Returns
    (state, prefix, tables by sampler)."""
    from tardis_torch.atomic.synthetic import make_synthetic_atom_data
    from tardis_torch.config.reader import config_from_dict
    from tardis_torch.model.state import SimulationState
    from tardis_torch.opacities.macro_atom_solver import (
        solve_macro_chain,
        solve_macro_state,
    )
    from tardis_torch.plasma.solver import PlasmaSolver
    from tardis_torch.transport.tables import NU_UNIT, build_transport_tables

    atom = make_synthetic_atom_data(
        n_levels=55, fine_structure_split=3e-6).prepare(
        selected_atoms=[8, 12, 14, 16, 18, 20],
        line_interaction_type="macroatom")
    state = SimulationState.from_config(config_from_dict(BENCH_CONFIG))
    ps = PlasmaSolver(atom, state, device).update(state.t_radiative,
                                                  state.dilution_factor)
    rates = (ps.beta_sobolev, ps.j_blues, ps.stimulated_emission_factor)
    chain = solve_macro_chain(atom.macro_atom, *rates, mode="macroatom",
                              line_nu_scaled=atom.line_nu / NU_UNIT)
    walk = solve_macro_state(atom.macro_atom, *rates)
    tables = {"chain": main_tables(state, atom, ps, chain),
              "walk": build_transport_tables(
                  state.geometry, ps.electron_densities, ps.tau_prefix, atom,
                  "macroatom", macro_walk=walk),
              "relativity": main_tables(state, atom, ps, chain,
                                        full_relativity=True)}
    return state, ps.tau_prefix, tables


def check_large_prefix(device):
    """K1's chain and walk instantiations of the final iteration (line
    estimators, 8 spawn records a packet) on the large-prefix problem,
    LARGE_PREFIX_PACKETS packets, and the relativity path's final one (the
    relativistic pool, last-interaction rows), each against its plain
    version as compare_transport_loop holds them (both stopped at
    IIP_EVENT_CAP events a packet, as the continuum checks are; every
    packet bitwise), then K4 on each one's records against its plain
    version (check_vpacket_volley: every ray bitwise).  Prints one
    large_prefix line a sampler (the list, shell 0's prefix and its f32
    ulp, the event counts, the agreement, the searches the relativistic
    margin guard sent to the bisection); returns the checked kernels-line
    names."""
    from tardis_torch.transport.kernel import variant, variant_name
    from tardis_torch.transport.solver import (
        VPACKET_RECORDS_PER_PACKET,
        iteration_keys,
    )
    from tardis_torch.transport.source import blackbody_source

    state, prefix, tables = large_prefix_tables(device)
    top = float(prefix[0, -1])
    key, run_key = iteration_keys(SEED, ITERATIONS - 1)
    n = LARGE_PREFIX_PACKETS
    hot = LARGE_PREFIX_HOT * state.t_inner
    pools = {"simple": blackbody_source(key, n, hot, device),
             "relativistic": blackbody_source(key, n, hot, device,
                                              "relativistic",
                                              beta_inner(state))}
    checked = set()
    for sampler, t in tables.items():
        rel = sampler == "relativity"
        pool = pools["relativistic" if rel else "simple"]
        numbers, k, _ = compare_transport_loop(
            t, pool, run_key, VPACKET_RECORDS_PER_PACKET * n,
            last_interaction=rel, line_estimators=True,
            max_events=IIP_EVENT_CAP)
        name = line_name("transport_loop", variant_name(variant(
            t, pool[2], last_interaction=rel, line_estimators=True)))
        k4 = check_vpacket_volley(t, k.vp_records[:k.n_vp_records], device)
        say("large_prefix", sampler=sampler, line=name, k4_line=k4["name"],
            lines=t.n_lines, shell0_prefix=top,
            f32_ulp_at_prefix=float(np.spacing(np.float32(top))),
            hot=LARGE_PREFIX_HOT, event_cap=IIP_EVENT_CAP,
            **{key: numbers[key] for key in (
                "n", "events", "events_per_packet", "records",
                "bitwise_packets", "records_bitwise_as_multiset", "max_rel",
                "ms", "device_ms", "plain_ms", "search_fallbacks")})
        checked |= {name, k4["name"]}
        del k
        torch.cuda.empty_cache()
    return checked


def hdf_round_trip(source, loaded):
    """Every array ``atom_data_from_hdf`` read back must equal the written
    one: the file holds energies in eV and masses in u, and the loader
    orders the lines by pandas' sort of nu, descending (not stable: its
    own order of equal frequencies).  Returns the number of arrays."""
    import pandas as pd

    from tardis_torch.atomic.convert import atom_data_to_arrays
    from tardis_torch.atomic.hdf_loader import EV_TO_ERG
    from tardis_torch.constants import M_U

    order = pd.DataFrame({"nu": source.line_nu}).sort_values(
        "nu", ascending=False).index.to_numpy()
    want = atom_data_to_arrays(source)
    want["masses"] = (source.masses / M_U) * M_U
    for name in ("ionization_energy", "level_energy"):
        want[name] = (getattr(source, name) / EV_TO_ERG) * EV_TO_ERG
    for name in ("line_nu", "line_f_lu", "line_lower_idx", "line_upper_idx",
                 "line_z", "line_ion"):
        want[name] = want[name][order]
    got = atom_data_to_arrays(loaded)
    differ = sorted(set(want) ^ set(got)) + [
        k for k in want if k in got and not (
            want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]))]
    if differ:
        raise AssertionError(f"atom_data_from_hdf: arrays differ {differ}")
    return len(want)


def run_walk_path(device, expected, hdf):
    """The walk path: the bench problem's atomic data written with the
    port's carsus writer to a file in a temporary directory, read back
    with atom_data_from_hdf (every array equal to the written one), then
    Simulation.from_config with ``atom_data: <that file>`` and
    ``sim.transport.use_macro_chain = False`` (WALK_CONFIG: 2 convergence
    iterations of N_PACKETS, the final one of FINAL_PACKETS with 2
    virtual packets and the formal integral).  Where h5py or pandas is
    missing (``hdf`` false) the same data goes in through
    ``atom_data_from_arrays``."""
    import tempfile

    from tardis_torch.atomic.convert import (
        atom_data_from_arrays,
        atom_data_to_arrays,
    )
    from tardis_torch.atomic.synthetic import make_synthetic_atom_data

    source = make_synthetic_atom_data(n_levels=200, max_level_jump=60)
    config = copy.deepcopy(WALK_CONFIG)
    numbers = {}
    with tempfile.TemporaryDirectory() as tmp:
        atom = None
        if hdf:
            from tardis_torch.atomic.hdf_loader import (
                atom_data_from_hdf,
                write_atom_data_hdf,
            )

            path = os.path.join(tmp, "bench_atom_data.h5")
            t0 = time.perf_counter()
            write_atom_data_hdf(source, path)
            t1 = time.perf_counter()
            loaded = atom_data_from_hdf(path)
            t2 = time.perf_counter()
            numbers = dict(write_s=t1 - t0, read_s=t2 - t1,
                           file_bytes=os.path.getsize(path),
                           arrays_equal=hdf_round_trip(source, loaded))
            config["atom_data"] = path
        else:
            atom = atom_data_from_arrays(atom_data_to_arrays(source))
        say("walk_atom_data", loader="atom_data_from_hdf" if hdf else
            "atom_data_from_arrays", **numbers)
        sim, launches, _ = run_path("walk_path", config, atom, device,
                                    expected, use_macro_chain=False)
    if sim.transport.use_macro_chain is not False:
        raise AssertionError("walk path: the solver did not walk")
    return launches


def run_relativity_path(atom, device, expected):
    """The main path with full relativity and last-interaction tracking at
    its default; the final result must carry one last-interaction row per
    packet.  Prints the searches K1's margin guard sent to the bisection
    in each of the path's K1 launches."""
    from tardis_torch.transport import solver as solver_module

    with timed_launches(solver_module, "transport_loop",
                        lambda res: (res.search_fallbacks,
                                     res.summary[2:3])) as calls:
        sim, launches, _ = run_path("relativity_path", RELATIVITY_CONFIG,
                                    atom, device, expected)
    fallbacks = [int(c[2][0][0]) for c in calls]
    say("relativity_path_search_fallbacks", per_launch=fallbacks,
        events_per_launch=[int(c[2][1][0]) for c in calls],
        total=sum(fallbacks))
    li = sim.last_transport_result.last_interaction
    n_rows = None if li is None else len(li["type"])
    say("relativity_path_last_interaction", rows=n_rows,
        types={int(t): int(n) for t, n in
               zip(*np.unique(li["type"], return_counts=True))}
        if li is not None else None)
    if n_rows != FINAL_PACKETS:
        raise AssertionError(f"relativity path: last_interaction rows "
                             f"{n_rows}, expected {FINAL_PACKETS}")
    return launches


def run_options_path(atom, device, expected):
    """The weighted pool, the reflective inner boundary and the r-packet
    tracker through run_tardis at N_PACKETS; the tracker must hold
    TRACKER_LENGTH rows per packet.  The reflective boundary raises the
    emitted luminosity, so the luminosity bands are not applied.  Then
    the r-packet plot's data preparation on the card's tracker rows
    (``rpacket_plot``)."""
    sim, launches, _ = run_path("options_path", OPTIONS_CONFIG, atom,
                                device, expected, bands=False)
    tr = sim.last_transport_result.rpacket_tracker
    if tr is None or tr["type"].shape != (N_PACKETS, TRACKER_LENGTH):
        raise AssertionError("options path: no r-packet tracker rows")
    rpacket_plot(sim)
    return launches


def rpacket_plot(sim):
    """RPacketPlotter's coordinates of the first 15 tracked packets (torch
    on the tracker's device) padded to one length; prints an ``rpacket``
    line (packets, padded length m, the data-prep seconds on the host
    clock after a synchronize, the largest radius against the outer
    shell's velocity) and raises unless every coordinate is finite and
    within the outer shell's velocity (relative 1e-6).  Then the animated
    plotly figure where plotly imports, else the matplotlib one where
    matplotlib imports, else a skip line."""
    from tardis_torch.visualization.rpacket import RPacketPlotter

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plotter = RPacketPlotter(sim)
    xs, ys, tys = plotter.get_coordinates_multiple_packets()
    xs, ys, tys, m = plotter.get_equal_array_size(xs, ys, tys)
    prep_s = time.perf_counter() - t0
    v_outer = float(plotter._shell_velocities()[-1])
    finite = all(np.isfinite(x).all() and np.isfinite(y).all()
                 for x, y in zip(xs, ys))
    radius = max(float(np.hypot(x, y).max()) for x, y in zip(xs, ys))
    numbers = dict(packets=len(xs), m=m, data_prep_s=prep_s,
                   max_radius_km_s=radius, v_outer_km_s=v_outer,
                   finite=finite)
    if not (finite and len(xs) == plotter.no_of_packets and m >= 1
            and radius <= v_outer * (1.0 + 1e-6)):
        say("rpacket", **numbers)
        raise AssertionError(f"rpacket: {numbers}")
    plotly_ok, failed_plotly = import_support("plotly")
    mpl_ok, failed_mpl = import_support("matplotlib")
    if plotly_ok:
        fig = plotter.generate_plot()
        numbers["plotly"] = dict(traces=len(fig.data),
                                 frames=len(fig.frames))
    elif mpl_ok:
        import matplotlib.pyplot as plt

        plt.close(plotter.generate_plot_mpl())
        numbers["plot"] = "drawn"
    else:
        numbers["plot"] = f"skipped, {failed_plotly}; {failed_mpl}"
    say("rpacket", **numbers)


@contextlib.contextmanager
def host_seconds(*targets):
    """Swaps each ``(owner, attr, sync)`` of ``targets`` for a wrapper that
    adds its call's host seconds to ``spent[attr]`` (with ``sync``, the
    card is synchronized before the call, so a call that ends in a copy to
    the host is timed alone); yields ``spent`` and restores the
    attributes."""
    spent = {}
    saved = [(owner, attr, sync, getattr(owner, attr))
             for owner, attr, sync in targets]

    def timed(attr, sync, fn):
        def call(*args, **kw):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            spent[attr] = spent.get(attr, 0.0) + time.perf_counter() - t0
            return out
        return call

    for owner, attr, sync, fn in saved:
        setattr(owner, attr, timed(attr, sync, fn))
    try:
        yield spent
    finally:
        for owner, attr, _, fn in saved:
            setattr(owner, attr, fn)


def drain(spent, names):
    """``spent``'s entries under ``names`` since the last drain, reset."""
    return {name: spent.pop(key, 0.0) * scale
            for name, (key, scale) in names.items()}


def run_large_ion_path(large_atom, device, expected):
    """run_tardis on LARGE_ION_CONFIG with the large-ion problem's atomic
    data: K8's large-system instantiation once a build and never the
    cluster one, the final iteration's luminosity in [0.8, 1.2] of the
    requested and virtual / real in [0.85, 1.18]; prints K8's launches by
    instantiation beside the problem's size."""
    sim, launches, wall = run_path("large_ion_path", LARGE_ION_CONFIG,
                                   large_atom, device, expected,
                                   integrated=False)
    say("large_ion_path_k8", launches={
        k: v for k, v in launches.items() if k.startswith("macro_chain")},
        states=len(large_atom.macro_atom.block_references) - 1,
        lines=large_atom.n_lines, shells=sim.state.no_of_shells,
        wall_s=wall)
    return launches


def run_detailed_nlte_path(atom, device, expected):
    """The main path with ``detailed`` radiative rates and Si II in NLTE:
    every iteration accumulates K1's line estimators, reads them back
    (``read_line_estimators``, timed on the host after a synchronize: the
    scan and the copy) and feeds their j_blues into the next plasma solve
    (K3's estimators instantiation); each iteration line carries the NLTE
    solve's host seconds since the last line and the readback's ms.  The
    final plasma must keep the estimator j_blues (no re-solve)."""
    from tardis_torch.plasma import solver as plasma_solver
    from tardis_torch.transport import solver as transport_solver

    names = {"nlte_s": ("nlte_level_boltzmann_factor", 1.0),
             "estimator_readback_ms": ("read_line_estimators", 1e3)}
    with host_seconds(
            (plasma_solver, "nlte_level_boltzmann_factor", False),
            (transport_solver, "read_line_estimators", True)) as spent:
        sim, launches, wall = run_path(
            "detailed_nlte_path", DETAILED_CONFIG, atom, device, expected,
            per_iteration=lambda: drain(spent, names))
    ps = sim.plasma_state
    if not (sim.plasma_solver.nlte_species == [(14, 1)]
            and sim.last_transport_result.j_blue_estimator is not None
            and bool(torch.isfinite(ps.j_blues).all())):
        raise AssertionError("detailed_nlte path: no NLTE species or no "
                             "estimator j_blues")
    return launches


def helium_problem():
    """The helium path's atomic data: the bench problem's synthetic data
    with He added."""
    from tardis_torch.atomic.synthetic import make_synthetic_atom_data

    return make_synthetic_atom_data(
        atomic_numbers=HELIUM_ELEMENTS, n_levels=200,
        max_level_jump=60).prepare(selected_atoms=list(HELIUM_ELEMENTS),
                                   line_interaction_type="macroatom")


def helium_k1_lines(atom, n_shells, k1, k1_walk):
    """The K1 lines (convergence, final) the helium path launches: the
    chain's where its tables fit the device budget, else the walk's."""
    from tardis_torch.opacities.macro_atom_solver import chain_tables_fit
    from tardis_torch.transport.tables import NU_UNIT

    fits = chain_tables_fit(atom.macro_atom, n_shells,
                            line_nu_scaled=atom.line_nu / NU_UNIT)
    lines = ((k1["main"], k1["main_final"]) if fits else
             (k1_walk["convergence"], k1_walk["final"]))
    return tuple(k["name"] for k in lines), fits


def run_helium_path(device, k2_name, k1, k1_walk):
    """Both helium treatments on the helium problem: recomb-nlte through
    run_tardis (HELIUM_ITERATIONS - 1 convergence iterations and the final
    one), then numerical-nlte with a heating-rate file written here, one
    convergence iteration (Simulation.run_convergence); launch counts
    reset and read around each, each iteration line with the helium
    solve's host seconds.  He I's ground level must be empty under
    recomb-nlte, the helium populations finite and positive somewhere."""
    import tempfile

    from tardis_torch.config.reader import config_from_dict
    from tardis_torch.plasma import helium
    from tardis_torch.plasma.solver import PlasmaSolver
    from tardis_torch.simulation.base import Simulation

    t = time.perf_counter()
    atom = helium_problem()
    (conv, final), chain = helium_k1_lines(
        atom, HELIUM_CONFIG["model"]["structure"]["velocity"]["num"], k1,
        k1_walk)
    say("helium_problem", lines=atom.n_lines, levels=atom.n_levels,
        setup_s=time.perf_counter() - t, chain_tables=chain,
        k1_lines=[conv, final])
    names = {"helium_s": ("_recomb_helium", 1.0)}
    expected = {"line_tables": None, k2_name: HELIUM_ITERATIONS,
                conv: HELIUM_ITERATIONS - 1, final: 1,
                "macro_chain": HELIUM_ITERATIONS if chain else 0}
    with host_seconds((PlasmaSolver, "_recomb_helium", False)) as spent:
        sim, recomb, wall = run_path(
            "helium_path", HELIUM_CONFIG, atom, device, expected,
            bands=False, per_iteration=lambda: drain(spent, names))
    n_level = sim.plasma_state.level_number_density
    rows1 = helium.species_rows(atom, 0)
    if not (np.isfinite(n_level).all() and (n_level[rows1[0]] == 0.0).all()
            and (n_level[rows1[1:]] > 0).any()):
        raise AssertionError("helium path: recomb-nlte populations")
    del sim
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        heating = os.path.join(tmp, "heating_rates.dat")
        np.savetxt(heating, np.column_stack(
            [np.arange(20.0), np.geomspace(1e-8, 1e-6, 20)]))
        cfg = copy.deepcopy(NUMERICAL_HELIUM_CONFIG)
        cfg["plasma"]["heating_rate_data_file"] = heating
        expected = {"line_tables": None, k2_name: 1, conv: 1,
                    "macro_chain": 1 if chain else 0}
        with host_seconds((helium, "helium_numerical_nlte", False)) as spent:
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                sim = Simulation.from_config(config_from_dict(cfg),
                                             atom_data=atom, device=device)
                sim.run_convergence()
            torch.cuda.synchronize()
            n_wall = time.perf_counter() - t0
            numerical = read_launches()
    n_level = sim.plasma_state.level_number_density
    he_rows = np.concatenate([helium.species_rows(atom, j)
                              for j in range(3)])
    finite = bool(np.isfinite(n_level).all()
                  and np.isfinite(sim.history[0].t_radiative).all())
    say("numerical_helium_path", wall_s=n_wall, launches=numerical,
        helium_s=spent.get("helium_numerical_nlte", 0.0),
        heating_rate_rows=sim.plasma_solver.heating_rate_data.shape[1],
        t_inner=sim.state.t_inner, finite=finite)
    if not (finite and (n_level[he_rows] > 0).any()):
        raise AssertionError("helium path: numerical-nlte populations")
    check_launches("numerical_helium_path", numerical, expected)
    return recomb, numerical


def model_edges_kms(n_shells):
    """The bench problem's shell edges [km/s]."""
    return np.linspace(1.1e4, 2.0e4, n_shells + 1)


def model_file_columns(n_shells):
    """Per shell, the model file's mass-fraction columns: Ni56 0.6 in the
    inner 5 shells, falling to 0 by shell 10, Co56 a thirtieth of it, and
    the rest O / Mg weighted outward, Si / S / Ar / Ca inward."""
    s = np.arange(n_shells, dtype=np.float64)
    ni = 0.6 * np.clip((10.0 - s) / 5.0, 0.0, 1.0)
    co = ni / 30.0
    out = (s / (n_shells - 1)) ** 2
    weights = {"O": 0.1 + 0.6 * out, "Mg": 0.02 + 0.08 * out,
               "Si": 0.55 - 0.5 * out, "S": 0.22 - 0.2 * out,
               "Ar": 0.045 - 0.04 * out, "Ca": 0.045 - 0.04 * out}
    total = sum(weights.values())
    cols = {k: (1.0 - ni - co) * w / total for k, w in weights.items()}
    return {**cols, "Ni56": ni, "Co56": co}


def write_model_csvy(path, n_shells):
    """The model-file path's csvy: one row an edge, the first row's
    density and fractions placeholders (the reader drops them)."""
    from tardis_torch.constants import DAY
    from tardis_torch.model.density import calculate_density

    edges = model_edges_kms(n_shells)
    mid = 0.5 * (edges[:-1] + edges[1:]) * 1e5
    density = calculate_density({"type": "branch85_w7"}, mid, DAY)
    cols = model_file_columns(n_shells)
    rows = [",".join(["velocity", "density", *cols])]
    for i, v in enumerate(edges):
        j = max(i - 1, 0)
        rows.append(",".join(repr(float(x)) for x in (
            v, density[j], *(c[j] for c in cols.values()))))
    with open(path, "w") as fh:
        fh.write("---\nname: model_file_path\nmodel_density_time_0: 1 day\n"
                 "model_isotope_time_0: 0 day\ndatatype:\n  fields:\n"
                 "    - {name: velocity, unit: km/s}\n"
                 "    - {name: density, unit: g/cm^3}\n"
                 + "".join(f"    - {{name: {c}}}\n" for c in cols)
                 + "---\n" + "\n".join(rows) + "\n")


def write_yaml(path, config):
    import yaml

    with open(path, "w") as fh:
        yaml.safe_dump(config, fh)



def run_model_file_path(device, k1, k1_walk, k2_name, k4_name):
    """run_tardis on a YAML whose csvy_model is the csvy written here, on
    the bench problem's synthetic data with Fe / Co / Ni (200 levels,
    jumps up to 60); shell 0's decayed Ni / Co / Fe fractions printed, Ni
    held to the Bateman solution (0.6 exp(-ln 2 t / t_half)); K1-K5 must
    launch and the bands of PERF.md section 2 hold."""
    import tempfile

    from tardis_torch.atomic.synthetic import make_synthetic_atom_data
    from tardis_torch.config.reader import config_from_yaml
    from tardis_torch.model.decay import _HALF_LIVES, LN2
    from tardis_torch.model.state import SimulationState

    t = time.perf_counter()
    atom = make_synthetic_atom_data(
        atomic_numbers=MODEL_FILE_ELEMENTS, n_levels=200,
        max_level_jump=60).prepare(selected_atoms=list(MODEL_FILE_ELEMENTS),
                                   line_interaction_type="macroatom")
    (conv, final), chain = helium_k1_lines(atom, MODEL_FILE_SHELLS, k1,
                                           k1_walk)
    with tempfile.TemporaryDirectory() as tmp:
        csvy = os.path.join(tmp, "model.csvy")
        write_model_csvy(csvy, MODEL_FILE_SHELLS)
        config = dict(MODEL_FILE_CONFIG, csvy_model=csvy)
        path = os.path.join(tmp, "model_file.yml")
        write_yaml(path, config)
        state = SimulationState.from_config(config_from_yaml(path))
        zs = [int(z) for z in state.composition.atomic_numbers]
        shell0 = {sym: float(state.composition.mass_fractions[zs.index(z), 0])
                  for sym, z in (("Ni", 28), ("Co", 27), ("Fe", 26))}
        t_exp = state.time_explosion
        ni_bateman = 0.6 * math.exp(-LN2 / _HALF_LIVES["Ni56"][0] * t_exp)
        say("model_file_problem", lines=atom.n_lines, levels=atom.n_levels,
            shells=state.no_of_shells, elements=zs,
            setup_s=time.perf_counter() - t, chain_tables=chain,
            k1_lines=[conv, final], shell0_mass_fractions=shell0,
            ni_bateman=ni_bateman)
        if (zs != list(MODEL_FILE_ELEMENTS)
                or state.no_of_shells != MODEL_FILE_SHELLS
                or abs(shell0["Ni"] / ni_bateman - 1.0) > 1e-12
                or not shell0["Co"] > shell0["Fe"] > 0.0):
            raise AssertionError(f"model file path: decayed composition "
                                 f"{zs} {shell0} (Ni {ni_bateman})")
        expected = {"line_tables": None, k2_name: MODEL_FILE_ITERATIONS,
                    conv: MODEL_FILE_ITERATIONS - 1, final: 1, k4_name: 1,
                    "formal_integral": 1,
                    "macro_chain": MODEL_FILE_ITERATIONS if chain else 0}
        sim, launches, _ = run_path("model_file_path", path, atom, device,
                                    expected)
    if sim.state.no_of_shells != MODEL_FILE_SHELLS:
        raise AssertionError("model file path: shells")
    return launches


def write_cmfgen_model(path, n_shells):
    """The command-line path's CMFGEN model (t0 = 1 day): O-Ca only,
    branch85_w7 densities at 1 day, stratified as the model-file path's
    without the iron group."""
    from tardis_torch.constants import DAY
    from tardis_torch.model.density import calculate_density

    edges = model_edges_kms(n_shells)
    mid = 0.5 * (edges[:-1] + edges[1:]) * 1e5
    density = calculate_density({"type": "branch85_w7"}, mid, DAY)
    cols = {k: v for k, v in model_file_columns(n_shells).items()
            if not k[-1].isdigit()}
    total = sum(cols.values())
    lines = ["t0: 1.0 day",
             "Index velocity temperature densities electron_densities "
             + " ".join(cols),
             "- km/s K g/cm^3 /cm^3" + " 1" * len(cols)]
    for i, v in enumerate(edges):
        j = max(i - 1, 0)
        lines.append(" ".join(str(x) for x in (
            i, repr(float(v)), 11000.0 - 150.0 * j, repr(float(density[j])),
            1e9, *(repr(float(c[j] / total[j])) for c in cols.values()))))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


@contextlib.contextmanager
def captured_runs():
    """The simulations run_tardis returns inside the block (the command
    line calls it)."""
    from tardis_torch.simulation import base

    runs, run = [], base.run_tardis

    def recording(*args, **kw):
        runs.append(run(*args, **kw))
        return runs[-1]

    base.run_tardis = recording
    try:
        yield runs
    finally:
        base.run_tardis = run


@contextlib.contextmanager
def kept_logger(name="tardis_torch"):
    """The logger tree as it was before the block (the command line
    configures it)."""
    import logging

    lg = logging.getLogger(name)
    handlers, level, propagate = list(lg.handlers), lg.level, lg.propagate
    try:
        yield
    finally:
        lg.handlers[:] = handlers
        lg.setLevel(level)
        lg.propagate = propagate


def run_cli_path(device, expected, hdf, failed_import):
    """tardis_torch.cli.main on a YAML naming the CMFGEN model written here
    (structure type file, v_inner_boundary inside shell 1), in this
    process and with no --device, so on the card by default; launch
    counts reset just before and read just after.  The spectrum file must
    be finite and equal, row for row, to the run's virtual spectrum, and
    the window must leave MODEL_FILE_SHELLS - 1 shells.  Where h5py
    imports, the same call writes --hdf (read back), then a run
    checkpointed every iteration stops after its first iteration, resumes
    from the file and must end within RESUME_RTOL of the uninterrupted
    run; else one line says the HDF step was skipped and why."""
    import tempfile

    from tardis_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        model = os.path.join(tmp, "model.cmfgen.csv")
        write_cmfgen_model(model, MODEL_FILE_SHELLS)
        config = copy.deepcopy(CLI_CONFIG)
        config["model"]["structure"] = {
            "type": "file", "filetype": "cmfgen", "filename": model,
            "v_inner_boundary": f"{CLI_V_INNER_KMS} km/s"}
        path = os.path.join(tmp, "cli.yml")
        write_yaml(path, config)
        spectrum = os.path.join(tmp, "spectrum.dat")
        argv = [path, spectrum, "--spectrum-kind", "virtual",
                "--log-level", "WARNING"]
        if hdf:
            argv += ["--hdf", os.path.join(tmp, "cli.h5")]
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with captured_runs() as runs, kept_logger():
            rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        sim = runs[0]
        rows = np.loadtxt(spectrum)
        spec = sim.spectrum_virtual
        wl = spec.wavelength * 1e8
        order = np.argsort(wl)
        want = np.column_stack([wl[order], spec.luminosity_lambda[order]])
        equal = bool(rows.shape == want.shape
                     and np.array_equal(rows, want))
        say("cli_path", rc=rc, wall_s=wall, launches=launches,
            device=str(sim.plasma_solver.device),
            shells=sim.state.no_of_shells,
            v_inner_kms=float(sim.state.geometry.v_inner[0]) / 1e5,
            spectrum_rows=int(rows.shape[0]),
            spectrum_finite=bool(np.isfinite(rows).all()),
            spectrum_equal=equal)
        if rc != 0 or sim.plasma_solver.device.type != "cuda":
            raise AssertionError(f"cli path: rc {rc} on "
                                 f"{sim.plasma_solver.device}")
        if not (equal and np.isfinite(rows).all()):
            raise AssertionError("cli path: the spectrum file is not the "
                                 "run's virtual spectrum")
        if (sim.state.no_of_shells != MODEL_FILE_SHELLS - 1
                or sim.state.geometry.v_inner[0] != CLI_V_INNER_KMS * 1e5):
            raise AssertionError("cli path: the velocity window")
        check_launches("cli_path", launches, expected)
        if not hdf:
            print(f"hdf: skipped, {failed_import}", flush=True)
            return launches
        check_cli_hdf(argv[-1], sim, path, device, tmp)
    return launches


def check_cli_hdf(hdf_path, sim, config_path, device, tmp):
    """The --hdf file holds the run's state, and a run checkpointed every
    iteration, stopped after its first and resumed from the file, ends
    where the uninterrupted run does."""
    from tardis_torch.config.reader import config_from_yaml
    from tardis_torch.io.hdf import load_simulation_state, resume_simulation
    from tardis_torch.simulation.base import Simulation

    state = load_simulation_state(hdf_path)
    if not np.array_equal(state["t_radiative"], sim.state.t_radiative):
        raise AssertionError("cli path: the --hdf file's t_rad")
    config = config_from_yaml(config_path)
    config.montecarlo.iterations = 3

    def simulation():
        return Simulation.from_config(config, atom_data=sim.atom_data,
                                      device=device)

    class Stop(Exception):
        pass

    def crash(s):
        if s.iterations_executed == 1:
            raise Stop

    checkpoint = os.path.join(tmp, "run.ckpt.h5")
    with torch.no_grad():
        full = simulation().run_convergence()
        first = simulation()
        first.add_callback(crash)
        try:
            first.run_convergence(checkpoint_path=checkpoint)
        except Stop:
            pass
        resumed = simulation()
        resume_simulation(resumed, checkpoint)
        resumed.run_convergence(checkpoint_path=checkpoint)
    rels = {name: max_rel(getattr(resumed.state, name),
                          getattr(full.state, name))
            for name in ("t_radiative", "dilution_factor", "t_inner")}
    say("cli_resume", iterations=resumed.iterations_executed,
        max_rel=rels, bar=RESUME_RTOL)
    if (resumed.iterations_executed != full.iterations_executed
            or max(rels.values()) > RESUME_RTOL):
        raise AssertionError(f"cli path: resume {rels}")


def build_iip_problem():
    """The IIP path's state and atom data: the JAX package's IIP problem
    (H I continua, 10 levels per ion, L = 135 lines, C = 10 continua)."""
    from tardis_torch.atomic.synthetic import make_synthetic_atom_data
    from tardis_torch.config.reader import config_from_dict
    from tardis_torch.model.state import SimulationState

    state = SimulationState.from_config(config_from_dict(IIP_CONFIG))
    atom = make_synthetic_atom_data(
        atomic_numbers=(1, 2), max_ion_stage=2, n_levels=10,
        continuum_species=((1, 0),),
    ).prepare(line_interaction_type="macroatom")
    return state, atom


def iip_tables(state, atom, device, channels=False):
    """K1's tables of the IIP path's first iteration: its first plasma
    solve (link W^0.25, as the workflow starts), continuum state and
    Markov macro atom.  With ``channels`` the two-photon and
    adiabatic-cooling channels are added, boosted as the JAX package's own
    tests boost them (tests/test_continuum.py:238,327: A_2ph 1e12 / s, the
    adiabatic rate at t_exp / 1e8) so that both fire."""
    from tardis_torch.opacities.continuum_macro import (
        solve_continuum_macro_state,
    )
    from tardis_torch.plasma.continuum import ContinuumSolver
    from tardis_torch.plasma.solver import PlasmaSolver
    from tardis_torch.transport.tables import (
        build_continuum_tables,
        build_transport_tables,
    )

    pl = PlasmaSolver(atom, state, device)
    pl.link_t_rad_t_electron = state.dilution_factor**0.25
    ps = pl.update(state.t_radiative, state.dilution_factor)
    cont = ContinuumSolver(atom, pl).update(ps)
    kw = {}
    if channels:
        atom = copy.deepcopy(atom)
        atom.two_photon.A_ul[:] = 1e12
        kw = dict(enable_two_photon=True, enable_adiabatic_cooling=True,
                  time_explosion=state.time_explosion / 1e8)
    macro = solve_continuum_macro_state(atom, ps, cont, ps.j_blues, **kw)
    ct = build_continuum_tables(state.geometry, atom, cont, macro, device)
    return build_transport_tables(
        state.geometry, ps.electron_densities, ps.tau_prefix, atom,
        "macroatom", full_relativity=True, continuum=ct)


def event_distribution(events, stopped):
    """Mean, p99 and largest of K1's per-packet event counts, and the
    packets the event cap stopped."""
    ev = events.double()
    return dict(mean=ev.mean().item(),
                p99=torch.quantile(ev, 0.99).item(),
                max=int(events.max().item()), stopped=int(stopped))


CONTINUUM_LIMITS = dict(est_j=1e-12, est_nubar=1e-12, line_diff=1e-9,
                        L_window=1e-9, L_reabsorbed=1e-9)
UNIT_ROUNDOFF = 2.0 ** -53  # f64


def summation_bound(n, a, b):
    """The largest difference that two orders of summing the same ``n``
    non-negative f64 terms can leave between their sums ``a`` and ``b``
    (elementwise).  Any order of the n - 1 additions keeps a sum within
    gamma = (n-1) u / (1 - (n-1) u) of the exact sum S, relative (u =
    2^-53, round to nearest; Higham, Accuracy and Stability of Numerical
    Algorithms, 2nd ed., eq. (4.4) for any order), and S <= a / (1 -
    gamma); so |a - b| <= 2 gamma / (1 - gamma) max(a, b), which is
    2 (n-1) u |sum| to first order.  It depends on the terms' count and
    sign alone, not on any measured spread."""
    m = torch.clamp(n.double() - 1.0, min=0.0) * UNIT_ROUNDOFF
    gamma = m / (1.0 - m)
    return 2.0 * gamma / (1.0 - gamma) * torch.maximum(a.abs(), b.abs())


def over_bound(a, b, bound):
    """max |a - b| / bound, where a difference over a zero bound counts as
    infinitely over it (and no difference as 0)."""
    diff = (a - b).abs()
    ratio = torch.where(bound > 0, diff / bound.clamp_min(1e-300),
                        torch.where(diff > 0, math.inf, 0.0))
    return ratio.max().item() if ratio.numel() else 0.0


def continuum_sum_bounds(k, p):
    """The racing continuum sums against summation_bound, row by row.
    Every term is non-negative: a moment [w, w/nu, w nu, wb, wb/nu, wb nu]
    of an event's path weight w >= 0 at nu > 0 and b = exp(-h nu / k T)
    in (0, 1], and w chi_ff with chi_ff = ff_coef (1 - b) / nu^3 >= 0 (the
    caller checks ff_coef >= 0).  A moment row counts its terms in column
    6 (each event adds 1, an exact f64 integer below 2^53; both sides must
    count the same), a shell's free-free heating the terms of its rows.
    Returns (counts equal, numbers: the largest difference over its bound
    of each sum, the largest bound relative to its sum, and the plain
    max_rel reading beside them)."""
    S = k.est_ff_heat.shape[0]
    n_row = k.cont_moments[:, 6]
    counts_equal = bool(torch.equal(n_row, p.cont_moments[:, 6]))
    out = {}
    n_shell = n_row.view(-1, S).sum(dim=0)
    for name, a, b, n in (
            ("cont_moments", k.cont_moments, p.cont_moments, n_row[:, None]),
            ("est_ff_heat", k.est_ff_heat, p.est_ff_heat, n_shell)):
        bnd = summation_bound(n.expand_as(a), a, b)
        scale = torch.maximum(a.abs(), b.abs())
        out[name] = dict(
            max_rel=rel_err(a, b), over_bound=over_bound(a, b, bnd),
            bound_rel_max=(bnd / scale.clamp_min(1e-300)).max().item(),
            terms_max=int(n.max().item()))
    return counts_equal, out


def compare_continuum(k, p):
    """Two continuum K1 outputs that must agree: every packet's row, event
    count and last-interaction row bitwise, the event and stopped totals
    equal, est_j / est_nubar within CONTINUUM_LIMITS (f64 atomics in racing
    order, ~1e4-1e5 terms a shell), the line difference array and
    luminosity sums, with cancelling terms, within 1e-9 as for the classic
    K1; the moments and the free-free heating, ~1e5 terms a row on average
    summed in racing order, within summation_bound of their own term
    counts, row by row (continuum_sum_bounds: no bar from a reading).
    Returns (ok, numbers)."""
    bitwise = (k.out == p.out).all(dim=1).double().mean().item()
    events_equal = bool(torch.equal(k.events, p.events))
    rows_equal = bool(torch.equal(k.last_interaction, p.last_interaction))
    rels = {name: rel_err(getattr(k, name), getattr(p, name))
            for name in ("est_j", "est_nubar", "line_diff")}
    rels["L_window"] = rel_err(k.summary[0:1], p.summary[0:1])
    rels["L_reabsorbed"] = rel_err(k.summary[1:2], p.summary[1:2])
    counts_equal, sums = continuum_sum_bounds(k, p)
    totals = (k.summary[2].item(), p.summary[2].item(),
              int(k.summary[3].item()), int(p.summary[3].item()))
    ok = (bitwise == 1.0 and events_equal and rows_equal
          and totals[0] == totals[1] and totals[2] == totals[3]
          and all(r <= CONTINUUM_LIMITS[name] for name, r in rels.items())
          and counts_equal and all(v["over_bound"] <= 1.0
                                   for v in sums.values()))
    max_abs = max((getattr(k, name) - getattr(p, name)).abs().max().item()
                  for name in ("out", "est_j", "est_nubar", "est_ff_heat",
                               "cont_moments", "line_diff", "summary"))
    return ok, dict(bitwise_packets=bitwise, events_bitwise=events_equal,
                    last_interaction_bitwise=rows_equal, events=totals[0],
                    stopped=totals[2], max_rel=rels, term_counts_equal=
                    counts_equal, summation_bound=sums, max_abs_err=max_abs)


def check_continuum_loop(tables, pool, run_key, replaces, plain_out=None):
    """A continuum K1 instantiation at the IIP path's width, in both of its
    table placements (shared memory, the one its size picks at the IIP
    problem, and device memory).  Each is timed uncapped as the path runs
    it (``ms``, one launch of the persistent grid), held against the
    path's own run (the size's pick, its first timed run) uncapped, every
    packet bitwise, and runs the longest packet alone (a one-packet slice
    of the pool at pid_offset = its id draws the same bits), the floor of
    any schedule; then both placements against the plain version, all
    stopped at IIP_EVENT_CAP events a packet (the plain lockstep loop runs
    as many steps as its longest packet).  Every comparison: each packet's
    row, event count and last-interaction row bitwise (a stopped packet's
    row is zero in both), the sums within CONTINUUM_LIMITS.  With a
    ``plain_out`` dict, the plain version also writes the spawn records of
    the records instantiation's capacity (VPACKET_RECORDS_PER_PACKET a
    packet; the records change nothing else), and its result is left there
    under "plain" for ``check_continuum_records``.  Returns the
    kernels-line entry."""
    from tardis_torch.transport.kernel import (
        library_defines,
        smem_tables_fit,
        transport_loop,
        transport_loop_plain,
        variant,
        variant_name,
    )
    from tardis_torch.transport.solver import VPACKET_RECORDS_PER_PACKET

    mu, nu, w = pool
    n = mu.shape[0]
    if not bool((tables.continuum.ff_coef >= 0).all()):
        raise AssertionError("continuum tables: a negative free-free "
                             "coefficient (summation_bound needs terms >= 0)")
    kw = dict(pool_w=w, last_interaction=True)
    flags = variant(tables, w, last_interaction=True)
    picked = smem_tables_fit(tables, library_defines(flags))
    placements = (picked, not picked) if picked else (False,)
    runs = {}
    full = None
    for smem in placements:
        def run_full():
            return transport_loop(tables, mu, nu, run_key, smem_tables=smem,
                                  **kw)

        if full is None:
            ms, full = cuda_ms(run_full, 2)
            res, numbers = full, {}
        else:
            ms, res = cuda_ms(run_full, 1, warmup=False)
            ok, numbers = compare_continuum(res, full)
            if not ok:
                raise AssertionError(
                    f"continuum transport_loop, tables in "
                    f"{'shared' if smem else 'device'} memory, against the "
                    f"path's placement: {numbers}")
        # the floor: the longest packet alone
        i = int(torch.argmax(full.events))
        one = slice(i, i + 1)
        floor_ms, alone = cuda_ms(lambda: transport_loop(
            tables, mu[one], nu[one], run_key, pool_w=w[one],
            last_interaction=True, pid_offset=i, smem_tables=smem), 3)
        if not (torch.equal(alone.out, full.out[one])
                and torch.equal(alone.events, full.events[one])
                and torch.equal(alone.last_interaction,
                                full.last_interaction[one])):
            raise AssertionError(f"continuum transport_loop: packet {i} "
                                 f"alone differs from its run in the pool")
        events = res.summary[2].item()
        runs[smem] = dict(ms=ms, events_per_s=events / (ms * 1e-3),
                          against_path=numbers,
                          floor=dict(packet=i, events=int(full.events[i]),
                                     ms=floor_ms,
                                     us_per_event=floor_ms * 1e3
                                     / int(full.events[i])))
        del res, alone
    dist = event_distribution(full.events, full.summary[3].item())
    events_full = full.summary[2].item()
    li = full.last_interaction[:, 0]
    kinds = {"line": int((li == 2).sum()), "continuum": int((li == 3).sum()),
             "escat": int((li == 1).sum()),
             "adiabatic": int(((full.out[:, 0] < 0)
                               & (full.out[:, 1] == 0)).sum())}
    del full

    cap = 0 if plain_out is None else VPACKET_RECORDS_PER_PACKET * n
    plain_ms, p = cuda_ms(lambda: transport_loop_plain(
        tables, mu, nu, run_key, batch_size=n, max_events=IIP_EVENT_CAP,
        vpacket_capacity=cap, **kw), 1, warmup=False)
    if plain_out is not None:
        plain_out.update(plain=p, plain_ms=plain_ms)
    capped = {}
    for smem in placements:
        capped_ms, k = cuda_ms(lambda: transport_loop(
            tables, mu, nu, run_key, max_events=IIP_EVENT_CAP,
            smem_tables=smem, **kw), 3)
        ok, numbers = compare_continuum(k, p)
        if not ok:
            raise AssertionError(
                f"continuum transport_loop at {n} packets against its plain "
                f"version, capped at {IIP_EVENT_CAP}, smem_tables={smem}: "
                f"{numbers}")
        capped[smem] = dict(numbers, ms=capped_ms)
        last_interaction = k.last_interaction
        del k
    b_ms, b_by = k1_bound(tables, n, events_full, RATES,
                          extra_bytes=nbytes(w, last_interaction))
    name = line_name("transport_loop", variant_name(flags))
    path = runs[picked]
    numbers = dict(line=name, n=n, smem_tables=picked, ms=path["ms"],
                   events=events_full, events_per_packet=dist,
                   interactions=kinds, placements={
                       ("shared" if smem else "device"): runs[smem]
                       for smem in placements},
                   plain_ms=plain_ms, event_cap=IIP_EVENT_CAP, capped={
                       ("shared" if smem else "device"): capped[smem]
                       for smem in placements},
                   bound_ms=b_ms, bound_by=b_by)
    say("check_continuum_loop", **numbers)
    entry = k1_entry(name, replaces, dict(
        numbers, max_abs_err=max(
            [c["max_abs_err"] for c in capped.values()]
            + [r["against_path"].get("max_abs_err", 0.0)
               for r in runs.values()])))
    entry.update(smem_tables=picked, floor_ms=path["floor"]["ms"],
                 **({"device_tables_ms": runs[False]["ms"]}
                    if picked else {}))
    return entry


def record_kinds(records):
    """Kept spawn records by li_type: births (-1), e-scatters (1), lines (2)
    and continuum processes (3)."""
    kinds = records[:, 6]
    return {name: int((kinds == k).sum()) for name, k in (
        ("birth", -1.0), ("escat", 1.0), ("line", 2.0), ("continuum", 3.0))}


def ptxas_numbers(name, defines):
    """Registers and spill bytes ptxas reported for a library's kernels
    (the lines of its build log)."""
    lines = ptxas_lines([(name, defines)]).get(" ".join((name, *defines)),
                                                [])
    regs = [int(m) for ln in lines
            for m in re.findall(r"Used (\d+) registers", ln)]
    spills = [int(m) for ln in lines
              for m in re.findall(r"(\d+) bytes spill stores", ln)]
    return dict(registers=max(regs, default=None),
                spill_store_bytes=max(spills, default=None), ptxas=lines)


def records_problem(device):
    """The continuum-records problem of tests/test_torch_continuum_vpackets
    .py (the IIP problem at 1.6e4-2.6e4 km/s and 14 days, the first
    iteration's plasma): K1's tables with the relativistic pool at
    IIP_PACKETS and the first iteration's keys."""
    from tardis_torch.config.reader import config_from_dict
    from tardis_torch.model.state import SimulationState
    from tardis_torch.transport.solver import iteration_keys
    from tardis_torch.transport.source import blackbody_source

    state = SimulationState.from_config(config_from_dict(RECORDS_CONFIG))
    _, atom = build_iip_problem()
    src_key, run_key = iteration_keys(SEED, 0)
    pool = blackbody_source(src_key, IIP_PACKETS, state.t_inner, device,
                            "relativistic", beta_inner(state))
    return iip_tables(state, atom, device), pool, run_key


def check_continuum_records(device, tables, pool, run_key, plain):
    """K1's continuum instantiation with spawn records (TL_RECORDS), as the
    iip_vpacket path runs it (relativistic pool, last-interaction rows,
    VPACKET_RECORDS_PER_PACKET records a packet), and K4 on its records.

    On the IIP problem (``tables``, ``pool``) it is timed uncapped, one
    launch as the path runs it: nearly every attempt is past the capacity
    there (packets random-walk ~2,400 events), so which rows are kept
    depends on the schedule of the atomic claims and no plain version can
    hold them; the kept rows by li_type are printed.  Stopped at
    IIP_EVENT_CAP events a packet it is held against the plain version's
    run of check_continuum_loop (``plain``, the same cap, with records):
    every packet bitwise (compare_continuum), the attempts ``vp_count``
    exactly and exactly ``capacity`` rows kept.  On the records problem
    (records_problem, with RECORDS_PROBLEM_PER_PACKET rows a packet so
    that every record fits, births and continuum processes included)
    both are stopped at RECORDS_EVENT_CAP and the records compared as
    multisets, bitwise; the uncapped run keeps every attempt.  K4
    (full relativity) on the IIP run's kept records: check_vpacket_volley
    with the IIP configuration's 1,000 bins; on the records problem's
    uncapped records the histogram within 1e-9 of the plain version's and
    the rays bitwise.  Returns the K1 and K4 kernels-line entries."""
    from tardis_torch.transport.kernel import (
        library_defines,
        transport_loop,
        transport_loop_plain,
        variant,
        variant_name,
    )
    from tardis_torch.transport.solver import VPACKET_RECORDS_PER_PACKET
    from tardis_torch.transport.vpacket import (
        trace_vpacket_records,
        trace_vpacket_records_plain,
    )

    mu, nu, w = pool
    n = mu.shape[0]
    cap = VPACKET_RECORDS_PER_PACKET * n
    kw = dict(pool_w=w, last_interaction=True, vpacket_capacity=cap)
    flags = variant(tables, w, last_interaction=True, vpacket_capacity=cap)
    name = line_name("transport_loop", variant_name(flags))
    plain_ms = plain["plain_ms"]
    ms, k = cuda_ms(lambda: transport_loop(tables, mu, nu, run_key, **kw), 1,
                    warmup=False)
    attempts = int(k.vp_count[0])
    kinds = record_kinds(k.vp_records)
    events = k.summary[2].item()
    if not (attempts > cap and k.n_vp_records == cap
            and kinds["birth"] >= 1 and kinds["continuum"] >= 1):
        raise AssertionError(f"{name} uncapped: {attempts} attempts, "
                             f"{k.n_vp_records} kept of {cap}, {kinds}")
    k4 = check_vpacket_volley(tables, k.vp_records, device,
                              config=IIP_CONFIG)
    del k
    p = plain["plain"]
    kc = transport_loop(tables, mu, nu, run_key, max_events=IIP_EVENT_CAP,
                        **kw)
    ok, capped = compare_continuum(kc, p)
    capped.update(attempts=int(kc.vp_count[0]),
                  plain_attempts=int(p.vp_count[0]),
                  kept=kc.n_vp_records, plain_kept=p.n_vp_records)
    if not (ok and capped["attempts"] == capped["plain_attempts"] > cap
            and capped["kept"] == capped["plain_kept"] == cap):
        raise AssertionError(f"{name} capped at {IIP_EVENT_CAP} against its "
                             f"plain version: {capped}")
    last_interaction = kc.last_interaction
    del kc, p
    plain.clear()
    torch.cuda.empty_cache()

    # the records problem: every record fits RECORDS_PROBLEM_PER_PACKET
    # rows a packet
    tables_b, (mu_b, nu_b, w_b), key_b = records_problem(device)
    cap_b = RECORDS_PROBLEM_PER_PACKET * n
    kw_b = dict(pool_w=w_b, last_interaction=True, vpacket_capacity=cap_b)
    kb = transport_loop(tables_b, mu_b, nu_b, key_b, **kw_b)
    rows_b = kb.vp_records[:kb.n_vp_records]
    fits = dict(attempts=int(kb.vp_count[0]), capacity=cap_b,
                records=record_kinds(rows_b),
                events_per_packet=event_distribution(
                    kb.events, kb.summary[3].item()))
    edges = iip_edges(device)
    vk = trace_vpacket_records(tables_b, rows_b, N_VPACKETS, edges,
                               return_packets=True)
    vp = trace_vpacket_records_plain(tables_b, rows_b, N_VPACKETS, edges,
                                     return_packets=True)
    fits.update(k4_hist_max_rel=rel_err(vk.hist, vp.hist),
                k4_rays_bitwise=bool(torch.equal(vk.nu, vp.nu)
                                     and torch.equal(vk.energy, vp.energy)))
    if not (fits["attempts"] <= cap_b and fits["records"]["continuum"] >= 1
            and fits["k4_hist_max_rel"] <= 1e-9 and fits["k4_rays_bitwise"]):
        raise AssertionError(f"{name} on the records problem: {fits}")
    del kb, rows_b, vk, vp
    plain_b_ms, pb = cuda_ms(lambda: transport_loop_plain(
        tables_b, mu_b, nu_b, key_b, batch_size=PLAIN_LANES,
        max_events=RECORDS_EVENT_CAP, **kw_b), 1, warmup=False)
    kb = transport_loop(tables_b, mu_b, nu_b, key_b,
                        max_events=RECORDS_EVENT_CAP, **kw_b)
    ok_b, numbers_b = compare_continuum(kb, pb)
    rows_k = sorted_rows(kb.vp_records[:kb.n_vp_records])
    rows_p = sorted_rows(pb.vp_records[:pb.n_vp_records])
    records_equal = (int(kb.vp_count[0]) == int(pb.vp_count[0]) <= cap_b
                     and torch.equal(rows_k, rows_p))
    fits.update(capped=dict(numbers_b, records_bitwise_as_multiset=
                            records_equal, plain_ms=plain_b_ms,
                            event_cap=RECORDS_EVENT_CAP))
    if not (ok_b and records_equal):
        raise AssertionError(f"{name} on the records problem, capped at "
                             f"{RECORDS_EVENT_CAP}: {fits['capped']}")
    max_abs = max(capped["max_abs_err"], numbers_b["max_abs_err"])
    del kb, pb, rows_k, rows_p, tables_b
    torch.cuda.empty_cache()

    b_ms, b_by = k1_bound(tables, n, events, RATES, n_records=cap,
                          extra_bytes=nbytes(w, last_interaction))
    regs = ptxas_numbers("transport_loop", library_defines(flags))
    numbers = dict(line=name, n=n, ms=ms, events=events, attempts=attempts,
                   kept=cap, records=kinds, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, event_cap=IIP_EVENT_CAP, capped=capped,
                   records_problem=fits, max_abs_err=max_abs, **regs)
    say("check_continuum_records", **numbers)
    entry = k1_entry(name, "tardis_tpu/transport/kernel.py:987", numbers)
    entry.update(registers=regs["registers"],
                 spill_store_bytes=regs["spill_store_bytes"], records=kinds)
    k4["name"] = K4_CONTINUUM_LINE
    k4["counted_as"] = line_name("vpacket_volley", "full_relativity")
    return entry, k4


def iip_edges(device):
    """The IIP configuration's spectrum bin edges in NU_UNIT, f32."""
    from tardis_torch.config.reader import config_from_dict
    from tardis_torch.spectrum.base import frequency_grid
    from tardis_torch.transport.tables import NU_UNIT

    spec = config_from_dict(IIP_CONFIG).spectrum
    return torch.as_tensor(
        (frequency_grid(spec.start, spec.stop, spec.num) / NU_UNIT)
        .astype(np.float32), device=device)


def run_iip_vpacket_path(atom, device, expected, plots, failed_plot_import):
    """Continuum transport with virtual packets, through the entry points a
    user calls, with the launch counts reset to 0 just before and read just
    after: TypeIIPWorkflow(IIP_CONFIG, one iteration).run(), then its
    TransportSolver.run_iteration with the workflow's continuum state and
    Markov macro atom and N_VPACKETS virtual packets a record (K2, K1's
    continuum records instantiation, K4 under full relativity); then
    run_tardis on CONTINUUM_SPECIES_CONFIG (continuum species through the
    classic loop, 2 iterations at IIP_PACKETS with virtual packets and
    their logging: the v_inner path's K1 instantiations, the main path's
    K4).  Prints the records run's attempts, the kept rows by li_type, its
    virtual luminosity, the run_tardis wall time, and the visualization
    modules' data preparation on the card's results (the plots themselves
    where matplotlib imports)."""
    from tardis_torch.opacities.continuum_macro import (
        solve_continuum_macro_state,
    )
    from tardis_torch.simulation.base import run_tardis
    from tardis_torch.transport.solver import VPACKET_RECORDS_PER_PACKET
    from tardis_torch.workflows.type_iip import TypeIIPWorkflow

    config = copy.deepcopy(IIP_CONFIG)
    config["montecarlo"]["iterations"] = 1
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wf = TypeIIPWorkflow(config, atom_data=atom, device=device).run()
    sim = wf.sim
    macro = solve_continuum_macro_state(
        sim.atom_data, sim.plasma_state, wf.cont_state,
        sim.plasma_state.j_blues, enable_two_photon=wf.enable_two_photon,
        enable_adiabatic_cooling=wf.enable_adiabatic_cooling,
        time_explosion=sim.state.time_explosion)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = sim.transport.run_iteration(
        sim.state, sim.plasma_state, sim.atom_data, n_packets=IIP_PACKETS,
        seed=sim.seed, iteration=1, n_vpackets=N_VPACKETS,
        spectrum_nu_edges=sim.spectrum_nu_edges, need_line_estimators=False,
        lum_nu_window=sim._lum_nu_window(), continuum_state=wf.cont_state,
        continuum_macro=macro)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    sim_a = run_tardis(copy.deepcopy(CONTINUUM_SPECIES_CONFIG), atom_data=atom,
                       device=device)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = read_launches()
    cap = VPACKET_RECORDS_PER_PACKET * IIP_PACKETS
    virtual = float(res.virt_energy_hist.sum() / res.time_of_simulation)
    real = res.emitted_luminosity(*sim._lum_nu_window())
    spectra = {k: getattr(sim_a, f"spectrum_{k}") for k in ("real",
                                                            "virtual")}
    finite = bool(np.isfinite(res.virt_energy_hist).all()
                  and all(np.isfinite(s.luminosity_nu).all()
                          for s in spectra.values()))
    numbers = dict(
        wall_s=t3 - t0, workflow_s=t1 - t0, records_run_s=t2 - t1,
        run_tardis_s=t3 - t2, launches=launches, attempts=res.vp_records,
        capacity=cap, virtual_luminosity=virtual, real_luminosity=real,
        virtual_over_real=virtual / real, run_tardis=dict(
            device_line=sim_a._device_line_ok(),
            luminosity={k: s.luminosity for k, s in spectra.items()},
            t_inner=sim_a.state.t_inner, iterations=len(sim_a.history) + 1),
        finite=finite)
    numbers.update(viz=viz_data_prep(sim_a, plots, failed_plot_import))
    say("iip_vpacket_path", **numbers)
    if not (finite and res.vp_records > cap and virtual > 0
            and not sim_a._device_line_ok()
            and spectra["virtual"].luminosity > 0):
        raise AssertionError(f"iip_vpacket_path: {numbers}")
    check_launches("iip_vpacket_path", launches, expected)
    return launches


def viz_data_prep(sim, plots, failed_plot_import):
    """The visualization modules' data preparation on a finished run on
    the card (torch on its device): the SDEC decomposition in both modes
    (the real components summing to the emitted luminosity in range within
    1e-6), the LIV groups, the Grotrian ladder and transitions; then the
    figures where matplotlib imports, else ``plots: skipped``, and the
    plotly figures (SDEC of the virtual packets, LIV, Grotrian) with their
    trace counts where plotly and matplotlib import, else ``plotly:
    skipped``."""
    from tardis_torch.visualization.grotrian import GrotrianPlot
    from tardis_torch.visualization.liv import LIVPlotter
    from tardis_torch.visualization.sdec import SDECPlotter

    t0 = time.perf_counter()
    edges = sim.spectrum_nu_edges
    p = SDECPlotter(sim)
    out = {}
    for mode in ("real", "virtual"):
        em, ab = p._decompose(edges, mode)
        total = float((sum(em.values()) * np.abs(np.diff(edges))).sum())
        out[f"sdec_{mode}"] = dict(emission=len(em), absorption=len(ab),
                                   luminosity=total)
    res = sim.last_transport_result
    in_rng = ((res.output_nu >= edges.min()) & (res.output_nu < edges.max())
              & res.emitted_mask)
    want = res.output_energy[in_rng].sum() / res.time_of_simulation
    out["sdec_real"]["rel_err"] = abs(out["sdec_real"]["luminosity"]
                                      - want) / want
    liv = LIVPlotter(sim)
    liv._prepare("real", None, None, None, 10)
    out["liv_groups"] = liv._species_name
    out["liv_packets"] = int(sum(len(d) for d in liv.plot_data))
    g = GrotrianPlot(sim)
    g._compute_level_data()
    g._compute_transitions()
    out["grotrian"] = dict(levels=len(g.merged_energies),
                           excite=len(g.excite_lines),
                           deexcite=len(g.deexcite_lines))
    torch.cuda.synchronize()
    out["data_prep_s"] = time.perf_counter() - t0
    if not (out["sdec_real"]["rel_err"] <= 1e-6 and out["liv_packets"] > 0
            and out["sdec_virtual"]["luminosity"] > 0):
        raise AssertionError(f"visualization data preparation: {out}")
    if plots:
        import matplotlib.pyplot as plt

        plt.close(p.generate_plot_mpl(packets_mode="virtual"))
        plt.close(liv.generate_plot_mpl(num_bins=10).figure)
        plt.close(g.display().figure)
        out["plots"] = "drawn"
    else:
        print(f"plots: skipped, {failed_plot_import}", flush=True)
    plotly_ok, failed_plotly = import_support("plotly", "matplotlib")
    if plotly_ok:
        figs = dict(sdec=p.generate_plot_ply(packets_mode="virtual"),
                    liv=liv.generate_plot_ply(num_bins=10),
                    grotrian=g.display_ply())
        out["plotly_traces"] = {k: len(f.data) for k, f in figs.items()}
        out["plotly_grotrian_arrows"] = len(figs["grotrian"].layout
                                            .annotations)
    else:
        print(f"plotly: skipped, {failed_plotly}", flush=True)
    return out


@contextlib.contextmanager
def timed_launches(module, attr, keep):
    """Swaps ``module.attr`` (a kernel wrapper as a path calls it) for one
    that records a CUDA event just before and just after each call; yields
    the list of (start, end, keep(result)) and restores the attribute on
    exit.  ``keep`` takes only what the caller reads: holding a path's
    whole results would keep the card's allocator from reusing them."""
    launch = getattr(module, attr)
    calls = []

    def timed(*args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        res = launch(*args, **kw)
        b.record()
        calls.append((a, b, keep(res)))
        return res

    setattr(module, attr, timed)
    try:
        yield calls
    finally:
        setattr(module, attr, launch)


def path_end():
    """The end of a path: the host clock after the card has finished, and
    an event recorded when the card reaches it."""
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    return time.perf_counter(), end


def launch_periods(calls, end):
    """Per launch of ``timed_launches``: its milliseconds, and the
    milliseconds from its start to the next launch's start (the last: to
    ``end``), both on the card's clock.  The period is an iteration's (or a
    time step's) wall time, host work between the launches included, taken
    without a host synchronization inside the path."""
    starts = [a for a, _, _ in calls[1:]] + [end]
    return [(a.elapsed_time(b), a.elapsed_time(nxt))
            for (a, b, _), nxt in zip(calls, starts)]


def run_iip_path(phase, config, atom, device, expected):
    """TypeIIPWorkflow(config).run() on the card with the launch counts
    reset to 0 just before and read just after (every line in
    ``expected`` exactly that often, None: at least once; no other).  One
    line per iteration: wall seconds (``launch_periods``; the thermal
    balance, host time, also on its own), K1's CUDA-event milliseconds,
    its events and their
    per-packet distribution (mean, p99, largest, stopped by the cap), and
    L_emitted / L_requested.  Every value
    must be finite, link_t_rad_t_electron in (0, 1.5], n_e > 0 and the
    photoionization estimator sum > 0."""
    from tardis_torch.transport import solver as solver_module
    from tardis_torch.workflows.type_iip import TypeIIPWorkflow

    balance_s, events = [], []

    class Timed(TypeIIPWorkflow):
        """Keeps each iteration's event counts and thermal balance time."""

        def solve_montecarlo(self, n_packets, iteration):
            res = super().solve_montecarlo(n_packets, iteration)
            events.append(dict(events=res.n_events,
                               per_packet=event_distribution(
                                   res.events, res.n_immortal)))
            return res

        def solve_thermal_balance(self):
            t0 = time.perf_counter()
            out = super().solve_thermal_balance()
            balance_s.append((time.perf_counter() - t0, int(out.nfev)))
            return out

    with timed_launches(solver_module, "transport_loop",
                        lambda res: None) as k1_calls:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wf = Timed(copy.deepcopy(config), atom_data=atom, device=device)
        wf.run()
        end = path_end()
    launches = read_launches()
    sim = wf.sim
    res = sim.last_transport_result
    ratios = [h.emitted_luminosity / sim.state.luminosity_requested
              for h in sim.history]
    ratios.append(res.emitted_luminosity(*sim._lum_nu_window())
                  / sim.state.luminosity_requested)
    for i, (k1_ms, period_ms) in enumerate(launch_periods(k1_calls, end[1])):
        say("iip_iteration", path=phase, index=i, wall_s=period_ms / 1e3,
            thermal_balance_s=balance_s[i][0] if i < len(balance_s)
            else None,
            thermal_balance_nfev=balance_s[i][1] if i < len(balance_s)
            else None,
            k1_ms=k1_ms, **events[i],
            L_emitted_over_requested=ratios[i])
    last = events[-1]["per_packet"]
    link = np.asarray(sim.plasma_solver.link_t_rad_t_electron, float)
    n_e = sim.plasma_state.electron_densities
    est = wf.cont_estimators
    pion = float(est.photo_ion.sum())
    finite = bool(
        np.isfinite(link).all() and np.isfinite(n_e).all()
        and np.isfinite(sim.state.t_radiative).all()
        and np.isfinite(sim.state.dilution_factor).all()
        and np.isfinite(sim.spectrum_real.luminosity_nu).all()
        and all(np.isfinite(getattr(est, f)).all()
                for f in ("photo_ion", "stim_recomb", "bf_heating",
                          "stim_recomb_cooling", "ff_heating")))
    say(phase, wall_s=end[0] - t0, packets=IIP_PACKETS * len(k1_calls),
        launches=launches, final_L_emitted_over_requested=ratios[-1],
        final_events=res.n_events, final_events_per_packet=last,
        link_range=[float(link.min()), float(link.max())],
        n_e_range=[float(n_e.min()), float(n_e.max())],
        t_inner=sim.state.t_inner, photo_ion_estimator_sum=pion,
        finite=finite)
    if not (finite and (link > 0).all() and (link <= 1.5).all()
            and (n_e > 0).all() and pion > 0):
        raise AssertionError(f"{phase}: finite {finite}, link "
                             f"{link.min()}..{link.max()}, n_e min "
                             f"{n_e.min()}, photoionization sum {pion}")
    check_launches(phase, launches, expected)
    return launches


def profile_main_path(atom, device, config=BENCH_CONFIG, phase="profile"):
    """Where the time goes in a short run of the main path (one convergence
    iteration and the final one), or of another path's ``config`` on its
    ``atom``: device time by kernel, host time by tardis.* span, and the
    device's busy share, on a ``phase`` line."""
    from torch.profiler import ProfilerActivity, profile

    from tardis_torch.simulation.base import run_tardis

    config = copy.deepcopy(config)
    config["montecarlo"]["iterations"] = PROFILE_ITERATIONS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_tardis(config, atom_data=atom, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    say_profile(phase, prof, wall, iterations=PROFILE_ITERATIONS)


def profile_walk_path(device):
    """profile_main_path's breakdown of the walk path (one convergence
    iteration and the final one, K1 walking the macro atom), its atomic
    data given in memory (the loader's host time is not in it)."""
    from torch.profiler import ProfilerActivity, profile

    from tardis_torch.atomic.synthetic import make_synthetic_atom_data
    from tardis_torch.config.reader import config_from_dict
    from tardis_torch.simulation.base import Simulation

    config = copy.deepcopy(WALK_CONFIG)
    config["montecarlo"]["iterations"] = PROFILE_ITERATIONS
    atom = make_synthetic_atom_data(n_levels=200, max_level_jump=60)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, torch.no_grad():
        t0 = time.perf_counter()
        sim = Simulation.from_config(config_from_dict(config),
                                     atom_data=atom, device=device)
        sim.transport.use_macro_chain = False
        sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    say_profile("profile_walk", prof, wall, iterations=PROFILE_ITERATIONS)


def ptxas_lines(libs):
    """ptxas's register and spill lines of each built library."""
    from tardis_torch import cuda

    out = {}
    for name, defines in libs:
        log = cuda.library_path(name, defines).with_suffix(".log")
        if log.exists():
            out[" ".join((name, *defines))] = [
                ln.strip() for ln in log.read_text().splitlines()
                if "registers" in ln or "spill" in ln]
    return out


def check_pools(state, device):
    """Every K2 pool at each of K2_SHAPES (1,048,576: the IIP paths;
    2,097,152: the convergence iterations; 4,194,304: the final one), with
    the first iteration's key and, at the final shape, the last one's,
    after a k2_sass line (the hashes and instructions a packet).  Returns
    the pools by name and packet count, and one kernels line per pool (its
    numbers at N_PACKETS, each shape's under ``shapes``, the largest error
    of its shapes)."""
    from tardis_torch import cuda

    sass = k2_sass(cuda.library_path("blackbody_source"))
    say("k2_sass", pools=sass)
    pools, lines = {}, {}
    for pool in REPLACES_K2:
        pools[pool], shapes = {}, {}
        for n in K2_SHAPES:
            iteration = ITERATIONS - 1 if n == FINAL_PACKETS else 0
            pools[pool][n], shapes[n] = check_blackbody_source(
                state, device, n, iteration, sass, pool)
        lines[pool] = dict(shapes[N_PACKETS])
        lines[pool]["max_abs_err"] = max(s["max_abs_err"]
                                         for s in shapes.values())
        lines[pool]["shapes"] = {
            str(n): {k: v for k, v in s.items() if k in (
                "ms", "kernel_ms", "device_ms", "held", "host_us",
                "plain_ms", "bound_ms", "share", "hash_bound_ms",
                "hash_share")}
            for n, s in shapes.items()}
    return pools, lines


def check_iip_kernels(device, state, atom, tables, k3):
    """The IIP paths' kernels at their shapes: K3 on the IIP problem's
    line tables (kept under its existing line, with the larger error),
    K2's relativistic pool at IIP_PACKETS with the IIP path's first key
    (bitwise against its plain version), then K1's two continuum instantiations on ``tables`` (the IIP
    path's, and the IIP options path's with the two-photon and adiabatic
    channels), and the IIP path's with spawn records with K4 on them
    (check_continuum_records, on the plain run of the IIP path's check).
    Returns the K1 lines by path ("iip_records" the records
    instantiation's, "iip_records_k4" K4's on its records)."""
    from tardis_torch.transport.solver import iteration_keys
    from tardis_torch.transport.source import (
        blackbody_source,
        blackbody_source_plain,
    )

    _, k3_iip, _ = check_line_tables(state, atom, device)
    k3["max_abs_err"] = max(k3["max_abs_err"], k3_iip["max_abs_err"])
    k3["iip_shape"] = {key: k3_iip[key] for key in (
        "ms", "host_ms", "plain_ms", "bound_ms", "library_ms",
        "library_host_ms")}
    key, run_key = iteration_keys(SEED, 0)
    # the IIP problem's pool (check_pools times K2 at this shape), bit for
    # bit against its plain version
    args = (key, IIP_PACKETS, state.t_inner, device, "relativistic",
            beta_inner(state))
    pool = blackbody_source(*args)
    if not all(torch.equal(a, b) for a, b in zip(
            pool, blackbody_source_plain(*args))):
        raise AssertionError("blackbody_source[relativistic]: the IIP "
                             "pool differs from its plain version")
    lines, plain = {}, {}
    for path, replaces in (("iip", "tardis_tpu/transport/kernel.py:366"),
                           ("iip_options",
                            "tardis_tpu/transport/kernel.py:864")):
        lines[path] = check_continuum_loop(
            tables[path], pool, run_key, replaces,
            plain_out=plain if path == "iip" else None)
        torch.cuda.empty_cache()
    lines["iip_records"], lines["iip_records_k4"] = check_continuum_records(
        device, tables["iip"], pool, run_key, plain)
    torch.cuda.empty_cache()
    return lines


def profile_iip_path(atom, device):
    """Where the time goes in a short IIP run (one convergence iteration
    with its thermal balance, and the final one) at IIP_PACKETS."""
    from torch.profiler import ProfilerActivity, profile

    from tardis_torch.workflows.type_iip import TypeIIPWorkflow

    config = copy.deepcopy(IIP_CONFIG)
    config["montecarlo"]["iterations"] = PROFILE_ITERATIONS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        TypeIIPWorkflow(config, atom_data=atom, device=device).run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    say_profile("profile_iip", prof, wall, iterations=PROFILE_ITERATIONS)


def profile_gamma_path(state, device):
    """Where the time goes on the gamma path (GAMMA_RUN): device time by
    kernel, the decay pool's host span and the device's busy share; K6's
    device time over the steps is the sum of its kernels' records
    (gamma_compact, gamma_walk), with no host time in it.  Returns that
    sum in milliseconds."""
    from torch.profiler import ProfilerActivity, profile

    from tardis_torch.constants import DAY
    from tardis_torch.workflows.high_energy import TARDISHEWorkflow

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        TARDISHEWorkflow(state, isotope_mass_fractions=gamma_fractions(state),
                         seed=SEED, device=device).run(
            t_start=GAMMA_DAYS[0] * DAY, t_end=GAMMA_DAYS[1] * DAY,
            **GAMMA_RUN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = say_profile("profile_gamma", prof, wall,
                          time_steps=GAMMA_STEPS)
    k6 = [(ms, n) for k, ms, n in kernels
          if "gamma_compact" in k or "gamma_walk" in k]
    say("profile_gamma_k6", device_ms=sum(ms for ms, _ in k6),
        launches=sum(n for _, n in k6))
    return sum(ms for ms, _ in k6)


def say_profile(phase, prof, wall, **kw):
    """Device time by kernel, host time by tardis.* span and the device's
    busy share of ``wall`` seconds, from a torch.profiler run (``kw``: the
    run's size, printed with it); returns the device rows (name, ms,
    count)."""
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
    say(phase, **kw, wall_ms=wall * 1e3,
        device_busy_ms=device_ms, device_busy_share=device_ms / (wall * 1e3),
        device_ms_by_kernel=[[k[:80], ms, n] for k, ms, n in kernels[:24]],
        host_ms_by_span=[[k, ms, n] for k, ms, n in spans])
    return kernels


def perturbed_geometry(geometry):
    """The JAX package's end-to-end perturbation of a homologous law
    (tests/test_nonhomologous.py:252-257): radii kept, v_inner and v_outer
    scaled by 1 + 0.1 sin(i) and 1 + 0.1 sin(i + 1)."""
    from tardis_torch.model.geometry import NonhomologousRadial1DGeometry

    geom = NonhomologousRadial1DGeometry.from_homologous(geometry)
    i = np.arange(geom.no_of_shells)
    geom.v_inner = geom.v_inner * (1.0 + 0.1 * np.sin(i))
    geom.v_outer = geom.v_outer * (1.0 + 0.1 * np.sin(i + 1.0))
    return geom


# K7's checks: (mode, instantiation flags in nonhomologous.OPTIONS order,
# packets, iteration); last-interaction rows as the nonhomologous path
# tracks, which runs macroatom without line estimators in its convergence
# iterations and with them in its final one
NONHOM_CASES = (("scatter", (False, True, False, False, False), N_PACKETS, 0),
                ("macroatom", (True, True, False, False, False), N_PACKETS, 0),
                ("macroatom", (True, True, False, False, True), FINAL_PACKETS,
                 NONHOM_ITERATIONS - 1))


def nonhom_tables(state, atom, ps, geometry, mode):
    """K7's tables on the bench problem's plasma state under ``geometry``
    (the walk tables in macroatom mode, built as the solver builds them)."""
    from tardis_torch.opacities.macro_atom_solver import solve_macro_state
    from tardis_torch.transport.nonhomologous import (
        build_nonhom_tables,
        nonhomologous_plasma_state,
    )

    ps_nh = nonhomologous_plasma_state(ps, geometry)
    walk = None
    if mode == "macroatom":
        walk = solve_macro_state(atom.macro_atom, ps_nh.beta_sobolev,
                                 ps_nh.j_blues,
                                 ps_nh.stimulated_emission_factor)
    return build_nonhom_tables(geometry, ps_nh, atom, mode, walk=walk)


def k7_bound(t, n_packets, n_events, extra_bytes=0, line_estimators=True):
    """Least time for K7: the tables read once (both prefixes, the walk
    tables), the outputs written once (the line difference array only with
    ``line_estimators``), against the events' two hashes and
    their line search (~8 operations a probe) and ~60 operations of the
    event; the bisection, the walk and the window searches, which only
    some events run, are not counted, so the bound stays a lower bound."""
    in_bytes = 8 * n_packets + nbytes(t.r_inner, t.r_outer, t.beta_in,
                                      t.m_grad, t.chi_e, t.line_nu, t.prefix,
                                      t.rev_prefix)
    if t.walk is not None:
        in_bytes += nbytes(*t.walk)
    line_diff = 2 * (t.n_lines + 1) * t.n_shells if line_estimators else 0
    out_bytes = 8 * n_packets + 8 * (line_diff + 2 * t.n_shells + 4)
    int_per_event = (2 * THREEFRY_OPS
                     + 8 * math.ceil(math.log2(t.n_lines + 1)))
    return bound(in_bytes + out_bytes + extra_bytes, n_events * 60,
                 n_events * int_per_event, RATES)


def check_nonhom_loop(state, atom, ps, pools):
    """K7 on the bench problem under the perturbed law against its plain
    version at NONHOM_PLAIN_LANES lanes, in each of NONHOM_CASES: scatter
    and macroatom mode without line estimators at N_PACKETS on the simple
    pool of the first iteration (the nonhomologous path's convergence
    instantiation), and macroatom mode with them at FINAL_PACKETS on the
    final iteration's pool with its key (``pools`` by packet count).  The
    walk tables' sizes (the rows of ``solve_macro_state``'s dense layout
    among them) and the macroatom tables' build time go on a line of their
    own.  Every packet, every last-interaction row and the event totals
    bitwise equal; est_j and est_nubar within 1e-12 relative (f64 atomics
    in racing order), the line difference array (where asked for; empty on
    both sides otherwise) and the luminosity sums within 1e-9 (their terms
    cancel, as for K1).  Timed as CUDA events around each call (``ms``) and
    as device time of queued calls (``device_ms``); the per-packet event
    distribution, the lane efficiency of one thread a packet and the events
    whose line the count search took (where the predicate is not proven
    monotone over the window; both versions take the same branch) come
    from the plain version's counts.  Then K7 in scatter mode under the
    homologous law against K1's classic instantiation on the same pool:
    status agreement at least 0.999 (the JAX package's own bar,
    tests/test_nonhomologous.py:85).  Returns the kernels-line entries of
    the macroatom instantiations (the nonhomologous path's) by
    ``convergence`` and ``final``."""
    from tardis_torch.model.geometry import NonhomologousRadial1DGeometry
    from tardis_torch.transport.kernel import transport_loop
    from tardis_torch.transport.nonhomologous import (
        OPTIONS,
        nonhom_transport_loop,
        nonhom_transport_loop_plain,
        variant,
        variant_name,
    )
    from tardis_torch.transport.solver import iteration_keys
    from tardis_torch.transport.tables import build_transport_tables

    geom = perturbed_geometry(state.geometry)
    entries = {}
    tables = {mode: nonhom_tables(state, atom, ps, geom, mode)
              for mode in ("scatter", "macroatom")}
    sizes = torch.diff(tables["macroatom"].walk.block_start).cpu().numpy()
    group = np.ceil(np.log2(np.maximum(sizes, 1)))
    build_ms, _ = cuda_ms(lambda: nonhom_tables(state, atom, ps, geom,
                                                "macroatom"), 3)
    say("walk_tables", transitions=int(sizes.sum()), blocks=sizes.size,
        widest_block=int(sizes.max()),
        dense_rows=sum(int((group == g).sum() * sizes[group == g].max())
                       for g in np.unique(group)),
        tables_ms=build_ms)
    for mode, flags, n, iteration in NONHOM_CASES:
        t = tables[mode]
        mu, nu, _ = pools[n]
        _, run_key = iteration_keys(SEED, iteration)
        line_estimators = flags[OPTIONS.index("line_estimators")]
        if flags != variant(t, True, 0, line_estimators):
            raise AssertionError(f"nonhom_loop: case flags {flags}")
        kw = dict(last_interaction=True, line_estimators=line_estimators)
        ms, k = cuda_ms(lambda: nonhom_transport_loop(t, mu, nu, run_key,
                                                      **kw), 3)
        del k
        device_ms, k = cuda_ms_queued(lambda: nonhom_transport_loop(
            t, mu, nu, run_key, **kw), 3)
        plain_ms, p = cuda_ms(lambda: nonhom_transport_loop_plain(
            t, mu, nu, run_key, batch_size=NONHOM_PLAIN_LANES, **kw), 1,
            warmup=False)
        bitwise = (k.out == p.out).all(dim=1).double().mean().item()
        rows_equal = bool(torch.equal(k.last_interaction,
                                      p.last_interaction))
        sums = ("est_j", "est_nubar") + (("line_diff",) if line_estimators
                                         else ())
        rels = {name: rel_err(getattr(k, name), getattr(p, name))
                for name in sums}
        rels["L_window"] = rel_err(k.summary[0:1], p.summary[0:1])
        rels["L_reabsorbed"] = rel_err(k.summary[1:2], p.summary[1:2])
        limits = dict(est_j=1e-12, est_nubar=1e-12, line_diff=1e-9,
                      L_window=1e-9, L_reabsorbed=1e-9)
        events = k.summary[2].item(), p.summary[2].item()
        stopped = int(k.summary[3].item()), int(p.summary[3].item())
        want_size = 2 * (t.n_lines + 1) * t.n_shells * line_estimators
        sizes = k.line_diff.numel(), p.line_diff.numel()
        if not (bitwise == 1.0 and rows_equal and events[0] == events[1]
                and stopped == (0, 0) and bool((k.out[:, 0] != 0).all())
                and all(r <= limits[name] for name, r in rels.items())
                and sizes == (want_size, want_size)
                and int(p.events.sum()) == events[1]):
            raise AssertionError(
                f"nonhom_loop[{mode}] at {n} packets: bitwise packets "
                f"{bitwise}, last-interaction rows equal {rows_equal}, "
                f"events {events}, stopped {stopped}, max rel {rels}, "
                f"line_diff sizes {sizes} (want {want_size})")
        abs_err = max((getattr(k, name) - getattr(p, name)).abs().max().item()
                      for name in ("out", "summary") + sums)
        li = k.last_interaction[:, 0]
        b_ms, b_by = k7_bound(t, n, events[0],
                              extra_bytes=nbytes(k.last_interaction),
                              line_estimators=line_estimators)
        name = line_name("nonhom_loop", variant_name(flags))
        numbers = dict(line=name, mode=mode, n=n,
                       line_estimators=line_estimators, ms=ms,
                       device_ms=device_ms, plain_ms=plain_ms,
                       plain_lanes=NONHOM_PLAIN_LANES, bound_ms=b_ms,
                       bound_by=b_by, events=events[0],
                       events_per_s=events[0] / (device_ms * 1e-3),
                       **events_numbers(p.events, stopped[1]),
                       count_search_events=p.count_search_events,
                       count_search_share=p.count_search_events / events[1],
                       line_interactions=int((li == 2).sum()),
                       escat_interactions=int((li == 1).sum()),
                       emitted=int((k.out[:, 0] > 0).sum()),
                       bitwise_packets=bitwise,
                       last_interaction_bitwise=rows_equal, max_rel=rels,
                       max_abs_err=abs_err)
        say("check_nonhom_loop", **numbers)
        if mode == "macroatom":
            entries["final" if line_estimators else "convergence"] = dict(
                name=name, route="cuda",
                source="tardis_torch/csrc/nonhom_loop.cu",
                replaces="tardis_tpu/transport/nonhomologous.py:198",
                max_abs_err=abs_err, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)
        del k, p
        torch.cuda.empty_cache()
    del tables

    # the homologous law: K7 against K1 on the same pool and key
    mu, nu, _ = pools[N_PACKETS]
    n = N_PACKETS
    _, run_key = iteration_keys(SEED, 0)
    geom_h = NonhomologousRadial1DGeometry.from_homologous(state.geometry)
    t7 = nonhom_tables(state, atom, ps, geom_h, "scatter")
    t1 = build_transport_tables(state.geometry, ps.electron_densities,
                                ps.tau_prefix, atom, "scatter")
    k7 = nonhom_transport_loop(t7, mu, nu, run_key, last_interaction=True)
    k1 = transport_loop(t1, mu, nu, run_key)
    torch.cuda.synchronize()
    agree = (torch.sign(k7.out[:, 0]) == torch.sign(k1.out[:, 0])
             ).double().mean().item()
    same = ((torch.sign(k7.out[:, 0]) == torch.sign(k1.out[:, 0]))
            & ((k7.out[:, 0] - k1.out[:, 0]).abs()
               <= 5e-6 * k1.out[:, 0].abs())).double().mean().item()
    say("check_nonhom_homologous", n=n, status_agreement=agree,
        nu_within_5e_6=same, events_k7=k7.summary[2].item(),
        events_k1=k1.summary[2].item(),
        est_j_max_rel=rel_err(k7.est_j, k1.est_j))
    if not agree >= 0.999:
        raise AssertionError(f"nonhom_loop under the homologous law: status "
                             f"agreement with K1 {agree}")
    return entries


def gamma_step_inputs(state, device, n_packets):
    """K6's inputs at the gamma path's widths with every packet in flight:
    the path's pool (Ni56 0.6 inner, 0.05 outer, GAMMA_DAYS), each packet
    placed at its birth position at GAMMA_CHECK_DAY with a budget of
    GAMMA_CHECK_STEP_DAYS of flight, and the shells' opacities at that
    epoch."""
    from tardis_torch.constants import C, DAY, M_U
    from tardis_torch.energy_input.decay import sample_gamma_packets
    from tardis_torch.energy_input.gamma_kernel import build_kn_table
    from tardis_torch.workflows.high_energy import TARDISHEWorkflow

    wf = TARDISHEWorkflow(state, isotope_mass_fractions=gamma_fractions(state),
                          seed=SEED, device=device)
    pool = sample_gamma_packets(n_packets, wf.isotope_numbers,
                                GAMMA_DAYS[0] * DAY, GAMMA_DAYS[1] * DAY,
                                seed=SEED)
    iron, z_over_a, z4_over_a = wf._composition_sums()
    t = GAMMA_CHECK_DAY * DAY
    scale = (t / state.time_explosion) ** -3
    g = state.geometry
    v_pos = g.v_inner[pool.shell] + pool.radius_frac * (
        g.v_outer[pool.shell] - g.v_inner[pool.shell])
    rho = state.composition.density

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device).to(
            torch.float32)

    kn_log_e, kn_table = build_kn_table(device=device)
    packets = (f32(v_pos * t), f32(pool.mu), f32(pool.energy_kev),
               f32(np.ones(n_packets)),
               torch.as_tensor(pool.shell, dtype=torch.int32, device=device),
               torch.zeros(n_packets, dtype=torch.int32, device=device),
               f32(np.full(n_packets, C * GAMMA_CHECK_STEP_DAYS * DAY)))
    shells = (f32(g.v_inner * t), f32(g.v_outer * t),
              f32(rho * z_over_a / M_U * scale), f32(rho * scale), f32(iron))
    ebins = f32(np.logspace(1.0, np.log10(4000.0), GAMMA_BINS + 1))
    return (packets + ((0, SEED),) + shells + (kn_log_e, kn_table, ebins),
            f32(rho * z4_over_a / M_U * scale))


def gamma_fractions(state):
    """Ni56 mass fractions of the gamma path: 0.6 in the inner 10 shells,
    0.05 outside."""
    S = state.no_of_shells
    return {"Ni56": np.where(np.arange(S) < 10, 0.6, 0.05)}


def gamma_case(args, fraction):
    """K6's inputs with ``fraction`` of the pool in flight: the packets
    chosen by a seeded generator over the whole pool, the others of status
    1, 2 or 3 (escaped, absorbed, waiting) drawn the same way."""
    if fraction == 1.0:
        return args
    status = args[5]
    n = status.shape[0]
    g = np.random.default_rng(SEED)
    st = g.integers(1, 4, n).astype(np.int32)
    st[g.choice(n, int(round(fraction * n)), replace=False)] = 0
    return args[:5] + (torch.as_tensor(st, device=status.device),) + args[6:]


def check_gamma_step(state, device):
    """K6 at GAMMA_PACKETS packets for one step (gamma_step_inputs), in each
    instantiation of GAMMA_OPTIONS and each case of GAMMA_CASES (every
    packet in flight, the gamma path's first- and last-step shares in
    flight, none), against its plain version: every packet's r, mu,
    energy, weight, shell, status and event count bitwise equal;
    deposition, escape histogram and estimators within 1e-12 relative (f64
    atomics in racing order).  Each case is timed by CUDA events around
    each call (``ms``, ``cuda_ms``, as before the queue of moving packets)
    and as device time of queued calls (``device_ms``,
    ``cuda_ms_queued``: a sparse call takes a few tenths of a millisecond,
    and the events around one call also time the host's wrapper work while
    the card waits for it); the two sparse cases also give their floor
    (``gamma_floor``).  The bound counts the energy changes that the plain
    version tallies.  Returns the kernels-line entry of the estimators
    instantiation (the gamma path's), dense, with its other cases' times
    under ``cases`` and the largest error of all."""
    from tardis_torch.energy_input.gamma_kernel import (
        gamma_step_transport,
        gamma_step_transport_plain,
        variant,
        variant_name,
    )

    dense, kasen_z4 = gamma_step_inputs(state, device, GAMMA_PACKETS)
    n = GAMMA_PACKETS
    table_bytes = k6_table_bytes(state.no_of_shells, GAMMA_BINS, dense[14])
    entry, max_abs = None, 0.0
    for label, opts in GAMMA_OPTIONS.items():
        kw = dict(kasen_z4=kasen_z4, **opts)
        name = line_name("gamma_step", variant_name(variant(**opts)))
        cases = {}
        for case, fraction in GAMMA_CASES.items():
            args = gamma_case(dense, fraction)

            def call():
                return gamma_step_transport(*args, **kw)

            ms, k = cuda_ms(call, 3)
            device_ms, k = cuda_ms_queued(call, 20)
            tally = {}
            plain_ms, p = cuda_ms(
                lambda: gamma_step_transport_plain(*args, tally=tally, **kw),
                1, warmup=False)
            fields = ("r", "mu", "energy_kev", "weight", "shell", "status",
                      "events")
            bitwise = {f: bool(torch.equal(getattr(k, f), getattr(p, f)))
                       for f in fields}
            rels = {f: rel_err(getattr(k, f), getattr(p, f))
                    for f in ("deposition", "escape_hist", "estimators")
                    if getattr(k, f).numel()}
            if not (all(bitwise.values())
                    and all(r <= 1e-12 for r in rels.values())):
                raise AssertionError(f"gamma_step[{label}, {case}]: bitwise "
                                     f"{bitwise}, max rel {rels}")
            abs_err = max((getattr(k, f) - getattr(p, f)).abs().max().item()
                          for f in rels)
            max_abs = max(max_abs, abs_err)
            n_events = k.events.double().sum().item()
            moved = int((k.events > 0).sum().item())
            changes = int(tally["energy_changes"].item())
            b_ms, b_by = k6_bound(
                n, moved, n_events, table_bytes,
                moved + changes if opts.get("collect_estimators") else 0)
            floor = gamma_floor(args, k.events, kw) if case in (
                "step0", "step49") else {}
            say("check_gamma_step", line=name, case=case, n=n,
                in_flight=int((args[5] == 0).sum().item()), moved=moved,
                ms=ms, device_ms=device_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, events=n_events, energy_changes=changes,
                events_per_s=(n_events / device_ms * 1e3 if n_events
                              else 0.0),
                events_per_moved_packet=dict(
                    mean=n_events / moved if moved else 0.0,
                    max=int(k.events.max().item())),
                status_counts=torch.bincount(k.status, minlength=4).tolist(),
                bitwise=bitwise, max_rel=rels, max_abs_err=abs_err, **floor)
            cases[case] = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                               bound_ms=b_ms, bound_by=b_by, events=n_events)
            del k, p
        if label == "estimators":
            d = cases.pop("dense")
            entry = dict(name=name, route="cuda",
                         source="tardis_torch/csrc/gamma_step.cu",
                         replaces=("tardis_tpu/energy_input/"
                                   "gamma_kernel.py:249"),
                         ms=d["ms"], device_ms=d["device_ms"],
                         plain_ms=d["plain_ms"],
                         bound_ms=d["bound_ms"], bound_by=d["bound_by"],
                         library_ms=None, cases=cases)
        torch.cuda.empty_cache()
    entry["max_abs_err"] = max_abs
    return entry


def gamma_floor(args, events, kw):
    """The floor of a sparse K6 case: the device time (``cuda_ms_queued``)
    of the same call with only its longest packet in flight, and with only
    its 32 longest, which one warp then walks together (a warp's lanes
    take consecutive list entries)."""
    from tardis_torch.energy_input.gamma_kernel import gamma_step_transport

    top = torch.topk(events, 32).indices
    out = dict(longest_events=int(events[top[0]].item()))
    for n, key in ((1, "longest_device_ms"), (32, "longest32_device_ms")):
        status = torch.full_like(args[5], 1)
        status[top[:n]] = 0
        alone = args[:5] + (status,) + args[6:]
        out[key] = cuda_ms_queued(
            lambda: gamma_step_transport(*alone, **kw), 20)[0]
    return out


def k6_table_bytes(n_shells, n_bins, kn_table):
    """Bytes of the tables one K6 call reads: six per-shell tables, the
    energy edges, the Klein-Nishina table with its energy grid and the 100
    quadrature points."""
    n_e, n_q = kn_table.shape
    return 4 * (6 * n_shells + n_bins + 1 + n_e * n_q + n_e + 100)


def k6_bound(n_packets, n_moved, n_events, table_bytes, n_quadratures):
    """Least time for one K6 call: every packet's state passed through (six
    words read, six and the event count written), the budget read of each
    packet that moves and the tables read once, against each event's two
    hashes (its key and the optical-depth draw) and ~80 operations of
    opacities, distances and the move, plus ~1,000 operations for each of
    the estimators' 100-point quadratures of the mean Compton fraction,
    which depends on the energy alone: ``n_quadratures``, one for each
    packet that moves and each event that changed an energy (0 without
    estimators).  Interactions hash more and some events take the KN
    lookup: not counted, so the bound stays a lower bound."""
    return bound(52 * n_packets + 4 * n_moved + table_bytes,
                 n_events * 80 + 1000 * n_quadratures,
                 n_events * 2 * THREEFRY_OPS, RATES)


def run_nonhom_path(atom, device, expected):
    """NonhomologousTARDISWorkflow on NONHOM_CONFIG under the perturbed law,
    launch counts reset to 0 just before and read just after (each line in
    ``expected`` exactly that often, None: at least once; no other).  One
    line per iteration: wall seconds, K7's CUDA-event milliseconds and
    events, L_emitted / L_requested.  t_rad must stay finite and above
    1,000 K and the real spectrum finite and positive (the JAX package's
    bars, tests/test_nonhomologous.py:259-264).  Wall seconds per
    iteration come from ``launch_periods``."""
    from tardis_torch.transport import solver as solver_module
    from tardis_torch.workflows.nonhomologous import (
        NonhomologousTARDISWorkflow,
    )

    with timed_launches(solver_module, "nonhom_transport_loop",
                        lambda res: res.summary) as k7_calls:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wf = NonhomologousTARDISWorkflow(
            copy.deepcopy(NONHOM_CONFIG), atom_data=atom,
            show_progress_bars=False, device=device)
        geom = perturbed_geometry(wf.geometry)
        wf.geometry.v_inner, wf.geometry.v_outer = geom.v_inner, geom.v_outer
        wf.run()
        end = path_end()
    launches = read_launches()
    sim = wf.sim
    res = sim.last_transport_result
    ratios = [h.emitted_luminosity / sim.state.luminosity_requested
              for h in sim.history]
    ratios.append(res.emitted_luminosity(*sim._lum_nu_window())
                  / sim.state.luminosity_requested)
    k7_ms = []
    for i, ((ms, period_ms), (_, _, summary)) in enumerate(
            zip(launch_periods(k7_calls, end[1]), k7_calls)):
        k7_ms.append(ms)
        say("nonhom_iteration", index=i, wall_s=period_ms / 1e3, k7_ms=ms,
            events=summary[2].item(), L_emitted_over_requested=ratios[i])
    t_rad = sim.state.t_radiative
    lum = np.asarray(sim.spectrum_real.luminosity_nu)
    finite = bool(np.isfinite(t_rad).all() and np.isfinite(lum).all()
                  and all(np.isfinite(h.t_radiative).all()
                          and np.isfinite(h.dilution_factor).all()
                          for h in sim.history))
    say("nonhom_path", wall_s=end[0] - t0,
        packets=N_PACKETS * (NONHOM_ITERATIONS - 1) + FINAL_PACKETS,
        launches=launches, k7_ms=k7_ms,
        final_L_emitted_over_requested=ratios[-1],
        t_rad_range=[float(t_rad.min()), float(t_rad.max())],
        t_inner=sim.state.t_inner, spectrum_luminosity=float(lum.sum()),
        immortal=res.n_immortal, finite=finite)
    if not (finite and (t_rad > 1000).all() and lum.sum() > 0
            and (lum >= 0).all()):
        raise AssertionError(f"nonhom path: finite {finite}, t_rad "
                             f"{t_rad.min()}..{t_rad.max()}, spectrum sum "
                             f"{lum.sum()}")
    check_launches("nonhom_path", launches, expected)
    return launches


def run_gamma_path(state, device, expected):
    """TARDISHEWorkflow at GAMMA_RUN on the bench model (gamma_fractions),
    launch counts reset to 0 just before and read just after.  Per step:
    wall seconds (``launch_periods``: no host synchronization between the
    steps), K6's CUDA-event milliseconds, its bound (``k6_bound`` at the
    step's events; with estimators each packet that moves and each packet
    whose energy changed is charged one quadrature, a lower count of the
    energy changes, which K6 does not report) and the per-packet event
    distribution; total_escaped +
    total_deposited must lie in [0.3, 1.02] x total_emitted
    (tests/test_gamma.py:71-72).  Returns the launches and K6's totals
    over the steps (ms, bound ms) and median ms."""
    from tardis_torch.constants import DAY
    from tardis_torch.energy_input.gamma_kernel import build_kn_table
    from tardis_torch.workflows import high_energy

    events = torch.zeros(GAMMA_PACKETS, dtype=torch.int32, device=device)
    statuses = torch.arange(4, dtype=torch.int32, device=device)

    def keep(out):
        """A step's events, movers, longest packet and status counts,
        reduced on the card (keeping its (B,) outputs would make the
        allocator reserve new blocks inside the next step's K6 call)."""
        events.add_(out.events)
        return (torch.stack([out.events.sum(dtype=torch.int64),
                             (out.events > 0).sum(),
                             out.events.max().long()]),
                (out.status.unsqueeze(1) == statuses).sum(0))

    changed = []
    with timed_launches(high_energy, "gamma_step_transport",
                        keep) as k6_calls:
        timed = high_energy.gamma_step_transport

        def counted(r, mu, energy_kev, *args, **kw):
            """The timed call, then its packets whose energy changed,
            counted on the card outside the call's events."""
            out = timed(r, mu, energy_kev, *args, **kw)
            changed.append((out.energy_kev != energy_kev).sum())
            return out

        high_energy.gamma_step_transport = counted
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wf = high_energy.TARDISHEWorkflow(
            state, isotope_mass_fractions=gamma_fractions(state), seed=SEED,
            device=device)
        res = wf.run(t_start=GAMMA_DAYS[0] * DAY, t_end=GAMMA_DAYS[1] * DAY,
                     **GAMMA_RUN)
        end = path_end()
    launches = read_launches()
    table_bytes = k6_table_bytes(state.no_of_shells, GAMMA_BINS,
                                 build_kn_table()[1])
    periods = launch_periods(k6_calls, end[1])
    k6_ms, bounds, steps = [], [], []
    for i, ((ms, period_ms), (_, _, (stats, status_counts)), n_changed) in (
            enumerate(zip(periods, k6_calls, changed))):
        k6_ms.append(ms)
        n_events, moved, longest = stats.tolist()
        n_changed = int(n_changed.item())
        b_ms, b_by = k6_bound(
            GAMMA_PACKETS, moved, n_events, table_bytes,
            moved + n_changed if GAMMA_RUN["collect_estimators"] else 0)
        bounds.append(b_ms)
        steps.append(dict(
            index=i, wall_s=period_ms / 1e3, k6_ms=ms, bound_ms=b_ms,
            bound_by=b_by, events=float(n_events), packets_moved=moved,
            packets_energy_changed=n_changed,
            events_per_moved_packet=dict(
                mean=n_events / moved if moved else 0.0, max=longest),
            status_counts=status_counts.tolist()))
    all_events = events.double()
    accounted = (res.total_escaped + res.total_deposited) / res.total_emitted
    finite = bool(np.isfinite(res.deposition).all()
                  and np.isfinite(res.escape_spectrum).all()
                  and all(np.isfinite(v).all()
                          for v in res.estimators.values()))
    totals = dict(path_ms_total=sum(k6_ms), path_bound_ms_total=sum(bounds),
                  path_ms_median=statistics.median(k6_ms))
    say("gamma_steps", steps=steps)
    say("gamma_path", wall_s=end[0] - t0, packets=GAMMA_PACKETS,
        time_steps=GAMMA_STEPS, energy_bins=GAMMA_BINS, launches=launches,
        k6_ms_total=totals["path_ms_total"],
        k6_bound_ms_total=totals["path_bound_ms_total"],
        k6_ms_median=totals["path_ms_median"],
        steps_wall_s=sum(period for _, period in periods) / 1e3,
        events_per_packet=dict(mean=all_events.mean().item(),
                               p99=torch.quantile(all_events, 0.99).item(),
                               max=int(all_events.max().item())),
        total_emitted=res.total_emitted, total_escaped=res.total_escaped,
        total_deposited=res.total_deposited,
        accounted_over_emitted=accounted, finite=finite)
    if not (finite and 0.3 <= accounted <= 1.02
            and res.total_deposited > 0 and res.total_escaped > 0):
        raise AssertionError(f"gamma path: finite {finite}, accounted / "
                             f"emitted {accounted}")
    check_launches("gamma_path", launches, expected)
    return launches, totals


# K1's sharded path (parallel/transport.py): shard counts held against one
# device, a world of one included; the continuum check takes two
SHARDS = (1, 2, 4)
# the sums of a sharded run against one device (f64 atomics in racing
# order on both sides), relative (rel_err)
SHARD_LIMITS = dict(est_j=1e-12, est_nubar=1e-12, summary=1e-12,
                    line_diff=1e-12, cont_moments=1e-12, est_ff_heat=1e-12)


def compare_sharded(tables, pool, run_key, devices, one, cap=0, **kw):
    """K1 over ``devices`` (one shard each) against ``one``, the same pool
    on one device: every packet, last-interaction, tracker row and
    per-packet event count bitwise, the spawn records equal as a multiset
    with the same attempts, the sums within SHARD_LIMITS.  Returns the
    phase's numbers."""
    from tardis_torch.parallel.transport import run_transport_sharded

    mu, nu, w = pool
    ms, s = cuda_ms(lambda: run_transport_sharded(
        tables, mu, nu, run_key, devices, vpacket_capacity=cap, pool_w=w,
        **kw), 3)
    if s.line_diff.numel() != one.line_diff.numel():
        raise AssertionError("sharded transport_loop: line_diff sizes "
                             f"{s.line_diff.numel()}, {one.line_diff.numel()}")
    rows = {name: bool(torch.equal(getattr(s, name), getattr(one, name)))
            for name in ("out", "last_interaction", "tracker", "events")}
    rels = {name: rel_err(getattr(s, name), getattr(one, name))
            for name in SHARD_LIMITS if getattr(one, name).numel()}
    records = (int(s.vp_count[0]), int(one.vp_count[0]),
               s.n_vp_records, one.n_vp_records)
    records_equal = records[0] == records[1] and records[2] == records[3]
    if cap and records_equal:
        records_equal = bool(torch.equal(
            sorted_rows(s.vp_records[:s.n_vp_records]),
            sorted_rows(one.vp_records[:one.n_vp_records])))
    numbers = dict(shards=len(devices), n=mu.shape[0], ms=ms,
                   rows_bitwise=rows, max_rel=rels,
                   records=records[0], records_kept=records[2],
                   records_equal_as_multiset=records_equal)
    if not (all(rows.values()) and records_equal
            and all(r <= SHARD_LIMITS[name] for name, r in rels.items())):
        say("check_sharded_transport", failed=True, **numbers)
        raise AssertionError(f"sharded transport_loop: {numbers}")
    return numbers


def reduce_bound(parts, out):
    """Least time of _final_reduce: every shard's partials and rows read
    once and the result written once."""
    from tardis_torch.parallel.transport import CAT_FIELDS, SUM_FIELDS

    fields = SUM_FIELDS + CAT_FIELDS + ("vp_records",)
    read = sum(nbytes(getattr(p, f)) for p in parts for f in fields)
    adds = sum(getattr(out, f).numel() for f in SUM_FIELDS) * (len(parts) - 1)
    return bound(read + sum(nbytes(getattr(out, f)) for f in fields), adds,
                 0, RATES)


def check_sharded_transport(tables, pools, device):
    """K1's classic macroatom instantiations (the main path's) on the bench
    problem: the convergence one, without line estimators, at N_PACKETS
    over 1, 2 and 4 shards on this one card, against one device (the
    sharding: the packet-id offsets, the pool's slices, the gather and the
    fixed-order sums); the final iteration's, with line estimators and
    records, at FINAL_PACKETS over 2 shards; _final_reduce timed alone on
    the 2-shard partials of the convergence instantiation (no line
    difference array to add)."""
    from tardis_torch.parallel.transport import _final_reduce
    from tardis_torch.transport.kernel import transport_loop
    from tardis_torch.transport.solver import (
        VPACKET_RECORDS_PER_PACKET,
        iteration_keys,
    )

    _, run_key = iteration_keys(SEED, 0)
    mu, nu, _ = pools[N_PACKETS]
    conv = dict(line_estimators=False)
    one_ms, one = cuda_ms(lambda: transport_loop(tables, mu, nu, run_key,
                                                 **conv), 3)
    for n_dev in SHARDS:
        say("check_sharded_transport", one_device_ms=one_ms,
            events=one.summary[2].item(), **compare_sharded(
                tables, pools[N_PACKETS], run_key, [device] * n_dev, one,
                **conv))
    half = N_PACKETS // 2
    parts = [transport_loop(tables, mu[d * half:(d + 1) * half],
                            nu[d * half:(d + 1) * half], run_key,
                            pid_offset=d * half, **conv) for d in range(2)]
    reduce_ms, out = cuda_ms(lambda: _final_reduce(parts, device), 10)
    r_ms, r_by = reduce_bound(parts, out)
    del one, parts, out
    _, run_key = iteration_keys(SEED, ITERATIONS - 1)
    mu, nu, _ = pools[FINAL_PACKETS]
    cap = VPACKET_RECORDS_PER_PACKET * FINAL_PACKETS
    one = transport_loop(tables, mu, nu, run_key, vpacket_capacity=cap)
    records = compare_sharded(tables, pools[FINAL_PACKETS], run_key,
                              [device] * 2, one, cap)
    say("check_sharded_transport_records", **records)
    say("final_reduce", shards=2, n=N_PACKETS, ms=reduce_ms,
        bound_ms=r_ms, bound_by=r_by)


def check_sharded_continuum(tables, state, device):
    """K1's continuum instantiation of the IIP path (relativistic pool,
    last-interaction rows) at IIP_PACKETS, both sides stopped at
    IIP_EVENT_CAP events a packet, over 2 shards against one device."""
    from tardis_torch.transport.kernel import transport_loop
    from tardis_torch.transport.solver import iteration_keys
    from tardis_torch.transport.source import blackbody_source

    src_key, run_key = iteration_keys(SEED, 0)
    pool = blackbody_source(src_key, IIP_PACKETS, state.t_inner, device,
                            "relativistic", beta_inner(state))
    kw = dict(last_interaction=True, max_events=IIP_EVENT_CAP)
    one = transport_loop(tables, pool[0], pool[1], run_key, pool_w=pool[2],
                         **kw)
    numbers = compare_sharded(tables, pool, run_key, [device] * 2, one, **kw)
    say("check_sharded_continuum", event_cap=IIP_EVENT_CAP,
        events=one.summary[2].item(), **numbers)


PROBE_REPLACES = {
    "scale2": "tardis_tpu/benchmarks/probe2.py:128",
    "take_1d": "tardis_tpu/benchmarks/probe2.py:146",
    "take_along_rows": "tardis_tpu/benchmarks/probe2.py:167"}


# the L2 flush before a cold call: a write of more than twice the 50 MB L2
L2_FLUSH_BYTES = 128 * 1024 * 1024
COLD_REPS = 20
SCALE2_ROUNDS = 3


def cuda_ms_cold(fn, reps, device, hold_cycles=4_000_000):
    """CUDA-event milliseconds of one call of ``fn`` with the L2 flushed
    before it: each of ``reps`` calls follows a write of L2_FLUSH_BYTES,
    both queued behind a hold of the card, so the events around the call
    see the call alone (not the host's launch).  Returns (median, min,
    max, last result)."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold_cycles)
        flush.fill_(1.0)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    del flush
    return statistics.median(times), min(times), max(times), out


def launch_floor(device, reps=COLD_REPS):
    """An empty kernel (``torch.cuda._sleep(0)``) timed as a cold call
    (``cuda_ms_cold``: events around one launch on a held card) and as
    calls queued back to back (``cuda_ms_queued``): what a launch costs
    the card with no work."""
    median, lo, hi, _ = cuda_ms_cold(lambda: torch.cuda._sleep(0), reps,
                                     device)
    queued, _ = cuda_ms_queued(lambda: torch.cuda._sleep(0), 50)
    return dict(event_ms=median, event_ms_min=lo, event_ms_max=hi,
                queued_ms=queued)


def in_turns(calls, rounds, reps=50):
    """Each of ``calls`` (name -> fn) timed by ``cuda_ms_queued`` in the
    order a, b, b, a for ``rounds`` rounds; returns per name the readings
    in order, their mean and their spread (min, max)."""
    (a, fa), (b, fb) = calls.items()
    got = {a: [], b: []}
    for _ in range(rounds):
        for name, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
            got[name].append(cuda_ms_queued(fn, reps)[0])
    return {name: dict(ms=v, mean=statistics.fmean(v), min=min(v),
                       max=max(v)) for name, v in got.items()}


def check_probe2(device):
    """The probe kernels against their plain versions, bitwise, at the
    probe's shapes (scale2 at each VMEM_MB size; take_1d on a (4,096,)
    table with 1,024 indices; take_along_rows at (1,024, 128)), at shapes
    that take the scalar tails (a length not a multiple of 4, a view not
    16-byte aligned) and at one large shape each (scale2 at 120 MB;
    take_1d on the probe's scalar gather, a 12,000,000-entry table with
    1,048,576 indices; take_along_rows at (131,072, 128)).  Timed at the
    large shape (cuda_ms_queued, warm: the probe calls each kernel again
    and again, as the JAX probe takes the least of five) beside the plain
    version, one library call (``torch.mul``, ``torch.index_select``,
    ``torch.gather`` on int64 indices made before the timing) and the
    bound: bytes over 3.35 TB/s, the indices and the output each moved
    once, and for take_1d each 32-byte sector of the table that the
    indices touch (``probe2.take_1d_bytes``; the earlier bound's 4 B a
    distinct entry is printed beside it, as ``bound_ms_4b_entries``).
    take_1d and index_select are also timed cold (``cuda_ms_cold``: the
    L2 flushed before each call), beside the launch floor (``launch_floor``,
    not inside the bound); scale2 and torch.mul in turns (``in_turns``:
    kernel, library, library, kernel, SCALE2_ROUNDS rounds).  Returns the
    kernels lines by name."""
    from tardis_torch.benchmarks import probe2

    gen = torch.Generator(device=device).manual_seed(SEED)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def indices(high, *shape):
        return torch.randint(0, high, shape, generator=gen, device=device,
                             dtype=torch.int32)

    def rows_touched(idx):
        hit = torch.zeros(idx.shape, dtype=torch.bool, device=device)
        return int(hit.scatter_(1, idx.long(), True).sum())

    cases = {
        "scale2": ([(uniform(1_000_003),), (uniform(1_000_003)[1:],)]
                   + [(uniform(mb * 1024 * 1024 // 4 // probe2.ROW,
                               probe2.ROW),) for mb in probe2.VMEM_MB],
                   lambda x: torch.mul(x, 2.0),
                   lambda x: 8 * x.numel()),
        "take_1d": ([(uniform(4096), indices(4096, 1024)),
                     (uniform(4096), indices(4096, 1027)),
                     (uniform(4096), indices(4096, 1027)[1:]),
                     (uniform(4097)[1:], indices(4096, 1024)),
                     (uniform(12_000_000), indices(12_000_000, 1_048_576))],
                    lambda t, i: torch.index_select(t, 0, i),
                    probe2.take_1d_bytes),
        "take_along_rows": (
            [(uniform(1024, probe2.ROW), indices(probe2.ROW, 1024,
                                                 probe2.ROW)),
             (uniform(131_072, probe2.ROW), indices(probe2.ROW, 131_072,
                                                    probe2.ROW))],
            lambda t, i: torch.gather(t, 1, i),
            lambda t, i: 4 * rows_touched(i) + 8 * i.numel()),
    }
    lines = {}
    for name, (shapes, library, n_bytes) in cases.items():
        kernel = getattr(probe2, name)
        plain = getattr(probe2, f"{name}_plain")
        bitwise = [bool(torch.equal(kernel(*a), plain(*a))) for a in shapes]
        args = shapes[-1]
        ms, k = cuda_ms_queued(lambda: kernel(*args), 50)
        plain_ms, p = cuda_ms_queued(lambda: plain(*args), 50)
        lib_args = args if name != "take_along_rows" else (
            args[0], args[1].long())
        library_ms, _ = cuda_ms_queued(lambda: library(*lib_args), 50)
        b_ms, b_by = bound(n_bytes(*args), 0, 0, RATES)
        max_abs = (k - p).abs().max().item()
        extra = {}
        if name == "take_1d":
            tab, idx = args
            old_ms, _ = bound(4 * torch.unique(idx).numel()
                              + 8 * idx.numel(), 0, 0, RATES)
            cold = cuda_ms_cold(lambda: kernel(*args), COLD_REPS, device)
            lib_cold = cuda_ms_cold(lambda: library(*args), COLD_REPS,
                                    device)
            extra = dict(
                sectors=probe2.table_sectors(tab, idx),
                distinct_entries=int(torch.unique(idx).numel()),
                bound_ms_4b_entries=old_ms, cold_ms=cold[0],
                cold_ms_spread=list(cold[1:3]), library_cold_ms=lib_cold[0],
                library_cold_ms_spread=list(lib_cold[1:3]),
                share_of_bound_warm=b_ms / ms, share_of_bound_cold=b_ms
                / cold[0], share_of_4b_bound_warm=old_ms / ms,
                launch_floor=launch_floor(device))
            bitwise.append(bool(torch.equal(cold[3], p)))
        if name == "scale2":
            turns = in_turns({"scale2": lambda: kernel(*args),
                              "torch_mul": lambda: library(*args)},
                             SCALE2_ROUNDS)
            extra = dict(turns=turns, slower_than_mul_by=turns["scale2"][
                "mean"] / turns["torch_mul"]["mean"])
        say("check_probe2", kernel=name,
            shapes=[[list(t.shape) for t in a] for a in shapes],
            bitwise=bitwise, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
            max_abs_err=max_abs, **extra)
        if not all(bitwise):
            raise AssertionError(f"{name}: bitwise {bitwise}")
        lines[name] = dict(
            name=name, route="cuda", source="tardis_torch/csrc/probe2.cu",
            replaces=PROBE_REPLACES[name], max_abs_err=max_abs, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=library_ms)
        if name == "take_1d":
            lines[name].update(cold_ms=extra["cold_ms"],
                               bound_ms_4b_entries=old_ms)
    return lines


def run_probe_path(device, expected):
    """tardis_torch.benchmarks.probe2.main() on the card with the launch
    counts reset to 0 just before and read just after: each probe kernel
    must launch and report its bitwise check "ok"."""
    from tardis_torch.benchmarks import probe2

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = probe2.main(device)
    torch.cuda.synchronize()
    launches = read_launches()
    say("probe_path", wall_s=time.perf_counter() - t0, launches=launches)
    if not (results["vmem_roundtrip_ok_mb"] == max(probe2.VMEM_MB)
            and results["pallas_take_1d"] == "ok"
            and results["pallas_take_along_lanes"] == "ok"):
        raise AssertionError(f"probe path: {results}")
    check_launches("probe_path", launches, expected)
    return launches


@contextlib.contextmanager
def recorded_iterations():
    """Keeps, for every TransportSolver.run_iteration call while open,
    what a replay needs: the solver, its arguments, the state's t_inner
    (which advance_state moves afterwards) and the result."""
    from tardis_torch.transport.solver import TransportSolver

    run = TransportSolver.run_iteration
    calls = []

    def recording(self, sim_state, plasma_state, atom_data, **kw):
        res = run(self, sim_state, plasma_state, atom_data, **kw)
        calls.append((self, (sim_state, plasma_state, atom_data), kw,
                      sim_state.t_inner, res))
        return res

    TransportSolver.run_iteration = recording
    try:
        yield calls
    finally:
        TransportSolver.run_iteration = run


def max_rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def run_sharded_path(atom, device, expected, main):
    """The main path with its packets split over two shards on this card
    (run_tardis(device=[card, card])); K1 must launch twice per
    iteration.  After the path, every iteration runs again on one device
    from the inputs the path gave it: every packet's output must be
    bitwise equal, the estimators and the two luminosities within 1e-12,
    the event and spawn-record counts equal and the virtual histogram
    within 1e-12.  Against the main path (``main``), a separate run: K1's
    f64 atomics sum in another order in every run, so t_rad differs in
    its last bits after the first iteration, and where that moves an f32
    rounding in K1 a packet parts from its twin; the runs agree far
    beyond the Monte Carlo noise (~1e-3) but not to 1e-9 (t_rad 1.2e-10,
    the integrated spectrum 1.9e-8 a bin and the virtual one 9.4e-7 a bin
    apart in my third run), so t_inner, t_rad and the three luminosities
    are held within 1e-5 and the spectra bin by bin are reported."""
    from tardis_torch.transport.solver import TransportSolver

    with recorded_iterations() as calls:
        sim, launches, wall = run_path("sharded_path", BENCH_CONFIG, atom,
                                       [device, device], expected)
    replays = []
    for solver, args, kw, t_inner, res in calls:
        state = args[0]
        t_now, state.t_inner = state.t_inner, t_inner
        solver.mesh = None
        one = TransportSolver.run_iteration(solver, *args, **kw)
        state.t_inner = t_now
        replay = dict(
            packets=res.n_packets,
            out_bitwise=bool(torch.equal(res._out, one._out)),
            j=max_rel(res.j_estimator, one.j_estimator),
            nu_bar=max_rel(res.nu_bar_estimator, one.nu_bar_estimator),
            luminosities=max_rel(res._lum_cache[2:], one._lum_cache[2:]),
            events=(res.n_events, one.n_events),
            vp_records=(res.vp_records, one.vp_records))
        if res.virt_energy_hist is not None:
            replay["virtual_bins"] = max_rel(res.virt_energy_hist,
                                             one.virt_energy_hist)
        replays.append(replay)
        del one
    got = path_numbers(sim)
    rels = {k: max_rel(got[k], main[k]) for k in main if k != "wall_s"}
    n_total = N_PACKETS * (ITERATIONS - 1) + FINAL_PACKETS
    say("sharded_path_against_main", max_rel=rels,
        iterations_on_one_device=replays, wall_s=wall,
        packets_per_s=n_total / wall, main_wall_s=main["wall_s"],
        main_packets_per_s=n_total / main["wall_s"])
    exact = all(
        r["out_bitwise"] and r["events"][0] == r["events"][1]
        and r["vp_records"][0] == r["vp_records"][1]
        and max(r["j"], r["nu_bar"], r["luminosities"],
                r.get("virtual_bins", 0.0)) <= 1e-12 for r in replays)
    if not (exact and len(replays) == ITERATIONS
            and all(rels[k] <= 1e-5 for k in MAIN_HELD)):
        raise AssertionError(f"sharded path: against one device {replays}, "
                             f"against the main path {rels}")
    return launches


def run_v_inner_path(atom, expected, plots, failed_plot_import):
    """InnerVelocitySolverWorkflow on the bench problem with no device
    argument (so on the card), the target tau the first solve's Rosseland
    profile at V_INNER_TAU_SHELL (printed); launch counts reset just before
    the run and read just after.  One line per convergence iteration: the
    moved v_inner (km/s), t_inner, get_tau_integ's CUDA-event ms and the
    iteration's wall (synchronised at each line), and, where matplotlib
    imports, a ConvergencePlots frame drawn before the move (its seconds
    apart, plot_s).  Held: the boundary moved outward and stayed inside the
    grid, the launch counts, finite outputs and the virtual / real band of
    PERF.md section 2; L_emitted / L_requested printed.  Returns (the
    final simulation, the launches)."""
    import tempfile

    from tardis_torch.workflows import v_inner_solver
    from tardis_torch.workflows.util import get_tau_integ

    workflow = v_inner_solver.InnerVelocitySolverWorkflow
    probe = workflow(copy.deepcopy(V_INNER_CONFIG), atom_data=atom)
    probe.solve_plasma()
    rosseland = get_tau_integ(probe.sim.plasma_state, atom,
                              probe.sim.state)["rosseland"]
    tau = float(rosseland[V_INNER_TAU_SHELL])
    v0 = float(probe.sim.state.geometry.v_inner[0])
    v_edge = float(probe.sim.state.geometry.v_outer[-1])
    say("v_inner_target", tau=tau, shell=V_INNER_TAU_SHELL,
        rosseland=[float(x) for x in rosseland], v_inner_kms=v0 / 1e5)
    del probe
    torch.cuda.empty_cache()

    tau_ms = []

    def timed_tau_integ(*args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = get_tau_integ(*args, **kw)
        b.record()
        torch.cuda.synchronize()
        tau_ms.append(a.elapsed_time(b))
        return out

    frames = tempfile.TemporaryDirectory() if plots else None
    marks = []

    class Traced(workflow):
        """The workflow with one line per boundary move."""

        def advance_v_inner(self):
            plot_s = None
            if self.plots is not None:
                t = time.perf_counter()
                self.plots.update(self.sim)
                plot_s = time.perf_counter() - t
            super().advance_v_inner()
            torch.cuda.synchronize()
            now = time.perf_counter()
            sim = self.sim
            res = sim.last_transport_result
            say("v_inner_iteration", index=len(self.v_inner_history) - 1,
                packets=res.n_packets, wall_s=now - marks[-1],
                v_inner_kms=self.v_inner_history[-1] / 1e5,
                t_inner=sim.state.t_inner, tau_integ_ms=tau_ms[-1],
                L_emitted_over_requested=sim.history[-1].emitted_luminosity
                / sim.state.luminosity_requested, plot_s=plot_s)
            marks.append(time.perf_counter())

    v_inner_solver.get_tau_integ = timed_tau_integ
    try:
        with torch.no_grad():
            wf = Traced(copy.deepcopy(V_INNER_CONFIG), atom_data=atom,
                        tau=tau)
            wf.plots = None
            if plots:
                from tardis_torch.visualization.convergence import (
                    ConvergencePlots,
                )

                wf.plots = ConvergencePlots(frame_dir=frames.name)
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            marks.append(t0)
            wf.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        v_inner_solver.get_tau_integ = get_tau_integ
    sim = wf.sim
    res = sim.last_transport_result
    history = wf.v_inner_history
    real = sim.spectrum_real.luminosity
    virt_ratio = sim.spectrum_virtual.luminosity / real
    final_ratio = (res.emitted_luminosity(*sim._lum_nu_window())
                   / sim.state.luminosity_requested)
    finite = bool(
        np.isfinite(sim.spectrum_real.luminosity_nu).all()
        and np.isfinite(sim.spectrum_virtual.luminosity_nu).all()
        and np.isfinite(res.output_nu).all()
        and all(np.isfinite(h.t_radiative).all()
                and np.isfinite(h.dilution_factor).all()
                for h in sim.history))
    n_total = (sim.no_of_packets * (V_INNER_ITERATIONS - 1)
               + sim.last_no_of_packets)
    say("v_inner_path", wall_s=wall, packets=n_total,
        packets_per_s=n_total / wall, launches=launches,
        v_inner_history_kms=[v / 1e5 for v in history],
        tau_integ_ms=tau_ms, final_L_emitted_over_requested=final_ratio,
        virtual_over_real=virt_ratio, vp_records=res.vp_records,
        finite=finite, immortal=res.n_immortal, card=card_line())
    if not finite:
        raise AssertionError("v_inner path produced non-finite values")
    if not (len(history) == V_INNER_ITERATIONS - 1
            and history[-1] > v0 and all(v0 <= v < v_edge for v in history)
            and sim.state.geometry.v_inner[0] == history[-1]):
        raise AssertionError(f"v_inner path: the boundary {history} did "
                             f"not move inside [{v0}, {v_edge})")
    if not 0.85 <= virt_ratio <= 1.18:
        raise AssertionError(f"v_inner path: virtual / real luminosity "
                             f"{virt_ratio}")
    check_launches("v_inner_path", launches, expected)
    if plots:
        names = sorted(os.listdir(frames.name))
        frames.cleanup()
        print(f"plots: {len(names)} frames, {names[-1]}", flush=True)
        if len(names) != V_INNER_ITERATIONS - 1:
            raise AssertionError(f"convergence plots: frames {names}")
    else:
        print(f"plots: skipped, {failed_plot_import}", flush=True)
    return sim, launches


def host_rel_err(a, b):
    """rel_err of two host arrays."""
    return rel_err(*(torch.as_tensor(np.ascontiguousarray(x)) for x in (a, b)))


def tau_integ_host(tau, line_nu, t_rad, n_e, dr, t_exp, bin_size=10):
    """get_tau_integ's profiles in host numpy f64 on copied tables: the
    lines in ascending frequency, bins of ``bin_size`` after zero padding,
    Planck and Rosseland weights, the reversed cumulative sum."""
    from tardis_torch.constants import C, H, K_B, SIGMA_THOMSON

    order = np.argsort(line_nu)
    extra = bin_size - len(line_nu) % bin_size
    freqs = np.hstack((np.arange(extra + 1) + 1.0, line_nu[order]))
    taus = np.vstack((np.zeros((extra + 1, tau.shape[1])), tau[order]))
    low = freqs[:-bin_size:bin_size]
    dnu = freqs[bin_size::bin_size] - low
    n_bins = len(dnu)
    dnu = np.where(dnu == 0, 1.0, dnu)
    summed = (-np.expm1(-taus[1:n_bins * bin_size + 1]
                        .reshape(n_bins, bin_size, -1))).sum(axis=1)
    nu, t = low[:, None], t_rad[None, :]
    b = 2.0 * H * nu**3 / C**2 / np.expm1(np.minimum(H * nu / (K_B * t),
                                                      500.0))
    u = b**2 * (C / nu) ** 2 / (2.0 * K_B * t**2)
    kappa_exp = (low / dnu)[:, None] / (t_exp * C) * summed
    kappa_thom = n_e * SIGMA_THOMSON
    w_b, w_u = b * dnu[:, None], u * dnu[:, None]
    planck = kappa_thom + (w_b * kappa_exp).sum(0) / w_b.sum(0)
    rosseland = w_u.sum(0) / (w_u / (kappa_thom + kappa_exp)).sum(0)
    return {"rosseland": np.cumsum((rosseland * dr)[::-1])[::-1],
            "planck": np.cumsum((planck * dr)[::-1])[::-1]}


def kappa_exp_host(tau, line_nu, edges, t_exp):
    """OpacityCalculator.kappa_exp in host numpy f64 on the copied table,
    with the bar of a card reading: 1 - exp(-tau), the JAX package's form,
    cancels for small tau, so the card's f64 exp and the host's, which may
    part by an ulp, give terms that part by up to 2^-52 each; a bin of n
    lines is held to ANALYSIS_RTOL |kappa| + 2 n 2^-52 times its scale
    (nu / dnu / (c t)).  Returns (kappa_exp, the bar)."""
    from tardis_torch.constants import C

    n_bins = len(edges) - 1
    binned = np.zeros((n_bins, tau.shape[1]))
    idx = np.searchsorted(edges, line_nu, side="left") - 1
    ok = (idx >= 0) & (idx < n_bins)
    np.add.at(binned, idx[ok], 1.0 - np.exp(-tau[ok]))
    scale = edges[:-1] / np.diff(edges) / (C * t_exp)
    kappa = binned * scale[:, None]
    lines = np.bincount(idx[ok], minlength=n_bins)
    bar = (ANALYSIS_RTOL * np.abs(kappa)
           + (2 * lines * 2.0**-52 * scale)[:, None])
    return kappa, bar


def over_bar(a, b, bar):
    """max |a - b| / bar; an entry whose bar is 0 counts 0 where equal,
    inf where not."""
    diff = np.abs(a - b)
    safe = np.where(bar > 0, bar, 1.0)
    return float(np.where(bar > 0, diff / safe,
                          np.where(diff > 0, np.inf, 0.0)).max())


def last_line_host(li, out, window, filter_mode):
    """The last-interaction mask of LastLineInteraction on copied rows, in
    host numpy f64."""
    from tardis_torch.constants import C
    from tardis_torch.transport.tables import NU_UNIT

    nu = (np.abs(out[:, 0]) if filter_mode == "packet_out_nu"
          else li[:, 4]) * NU_UNIT
    lo, hi = C / (window[1] * 1e-8), C / (window[0] * 1e-8)
    return (out[:, 0] > 0) & (li[:, 0] == 2) & (nu > lo) & (nu < hi)


def check_analysis(sim, pandas_ok):
    """The analysis of the v_inner path's final simulation on the card:
    get_tau_integ and OpacityCalculator (OPACITY_BINS bins) against host
    numpy f64 evaluations of the same tables, copied once for the check
    (ANALYSIS_RTOL; kappa_exp's bins also within the cancellation bar of
    kappa_exp_host); LastLineInteraction's line counts and distinct (in,
    out) pairs, both filter modes and ANALYSIS_WINDOWS, equal to a host
    numpy count over the rows copied once; where pandas imports
    (``pandas_ok``), the DataFrames of LastLineInteraction and LineInfo held
    to the same counts, and shell_info_table / ion_fraction_table finite
    with each shell's ion fractions summing to 1.  Each call's ms by CUDA
    events (median of 5 after a warm-up)."""
    from tardis_torch.analysis.last_interaction import LastLineInteraction
    from tardis_torch.analysis.opacities import OpacityCalculator
    from tardis_torch.workflows.util import get_tau_integ

    ps, state, atom = sim.plasma_state, sim.state, sim.atom_data
    g = state.geometry
    t0 = time.perf_counter()
    tau = ps.tau_sobolev.cpu().numpy()
    copy_s = time.perf_counter() - t0
    numbers = {"tau_table_bytes": tau.nbytes, "tau_copy_s": copy_s}
    ms, prof = cuda_ms(lambda: get_tau_integ(ps, atom, state), 5)
    ref = tau_integ_host(tau, atom.line_nu, ps.t_rad, ps.electron_densities,
                         g.r_outer - g.r_inner, state.time_explosion)
    numbers["tau_integ"] = dict(
        ms=ms, max_rel=max(host_rel_err(prof[k], ref[k]) for k in ref),
        rosseland_shell0=float(prof["rosseland"][0]))
    def opacities():
        calc = OpacityCalculator(sim, nbins=OPACITY_BINS)
        calc.kappa_exp
        return calc

    ms, calc = cuda_ms(opacities, 5)
    ref, bar = kappa_exp_host(tau, atom.line_nu, calc.nu_bins,
                              state.time_explosion)
    numbers["kappa_exp"] = dict(
        ms=ms, shape=list(calc.kappa_exp.shape),
        max_rel=host_rel_err(calc.kappa_exp, ref),
        over_bar=over_bar(calc.kappa_exp, ref, bar),
        planck_tau_shell0=float(calc.planck_tau[0]),
        finite=bool(np.isfinite(calc.planck_tau).all()))
    del tau
    res = sim.last_transport_result
    li = res._li.cpu().numpy().astype(np.float64)
    out = res._out.cpu().numpy().astype(np.float64)
    counts = []
    for window in ANALYSIS_WINDOWS:
        for filter_mode in ("packet_out_nu", "packet_in_nu"):
            lli = LastLineInteraction.from_simulation(
                sim, packet_filter_mode=filter_mode).set_wavelength_range(
                    window[0] * 1e-8, window[1] * 1e-8)
            mask = last_line_host(li, out, window, filter_mode)
            entry = dict(window=window, filter_mode=filter_mode,
                         packets=int(mask.sum()))
            for which, column in (("in", 1), ("out", 2)):
                ms, (ids, n) = cuda_ms(lambda: lli.line_counts(which), 5)
                ids_h, n_h = np.unique(
                    li[mask, column][li[mask, column] >= 0].astype(np.int64),
                    return_counts=True)
                entry[f"line_counts_{which}_ms"] = ms
                entry[f"lines_{which}"] = int(len(ids))
                if not (np.array_equal(ids, ids_h)
                        and np.array_equal(n, n_h)):
                    raise AssertionError(f"line counts ({which}) differ "
                                         f"from the host count: {entry}")
            ms, (p_in, p_out, p_n) = cuda_ms(lli.line_pairs, 5)
            pairs_h, n_h = np.unique(li[mask][:, 1:3].astype(np.int64),
                                     axis=0, return_counts=True)
            order = np.lexsort((p_out, p_in))
            entry.update(line_pairs_ms=ms, pairs=int(len(p_n)))
            if not (np.array_equal(np.stack((p_in, p_out), 1)[order],
                                   pairs_h)
                    and np.array_equal(p_n[order], n_h)
                    and int(p_n.sum()) == entry["packets"]):
                raise AssertionError(f"line pairs differ from the host "
                                     f"count: {entry}")
            if pandas_ok:
                entry.update(check_analysis_tables(sim, lli, li, mask,
                                                   window, filter_mode))
            counts.append(entry)
    numbers["last_line_interaction"] = counts
    if pandas_ok:
        numbers["shell_info"] = check_shell_info(sim)
    say("analysis", card=card_line(), tables=pandas_ok, **numbers)
    if not (numbers["tau_integ"]["max_rel"] <= ANALYSIS_RTOL
            and numbers["kappa_exp"]["over_bar"] <= 1.0
            and numbers["kappa_exp"]["finite"]):
        raise AssertionError("get_tau_integ / OpacityCalculator differ from "
                             "the host evaluation")


def check_analysis_tables(sim, lli, li, mask, window, filter_mode):
    """The DataFrames over the same window: LastLineInteraction's tables
    hold line_counts' numbers, LineInfo's species fractions the host count
    of the emitted lines' species, and its last-line counts of the
    leading species every masked packet whose absorbed line is of that
    species."""
    from tardis_torch.analysis.line_info import LineInfo
    from tardis_torch.utils.base import species_tuple_to_string

    atom = sim.atom_data
    out = {}
    for which in ("in", "out"):
        t = time.perf_counter()
        table = getattr(lli, f"last_line_{which}")
        out[f"last_line_{which}_s"] = time.perf_counter() - t
        ids, n = lli.line_counts(which)
        order = np.argsort(table["line_id"].to_numpy())
        if not (np.array_equal(table["line_id"].to_numpy()[order], ids)
                and np.array_equal(table["count"].to_numpy()[order], n)):
            raise AssertionError(f"last_line_{which} differs from its "
                                 "line counts")
    info = LineInfo.from_simulation(sim)
    t = time.perf_counter()
    species = info.get_species_interactions(window, filter_mode=filter_mode)
    out["species_interactions_s"] = time.perf_counter() - t
    emitted = li[mask, 2][li[mask, 2] >= 0].astype(np.int64)
    names = np.array([species_tuple_to_string((z, i)) for z, i in zip(
        atom.line_z[emitted], atom.line_ion[emitted])])
    host, n_host = np.unique(names, return_counts=True)
    fractions = dict(zip(host, n_host / n_host.sum()))
    got = species["Fraction of packets interacting"]
    if set(got.index) != set(fractions) or any(
            abs(got[k] - fractions[k]) > 1e-12 for k in fractions):
        raise AssertionError(f"species fractions {dict(got)} against the "
                             f"host count {fractions}")
    top = species.index[0]
    t = time.perf_counter()
    counts = info.get_last_line_counts(top, wavelength_range=window,
                                       filter_mode=filter_mode)
    out["last_line_counts_s"] = time.perf_counter() - t
    absorbed = np.clip(li[mask, 1].astype(np.int64), 0, atom.n_lines - 1)
    n_top = sum(species_tuple_to_string((z, i)) == top for z, i in zip(
        atom.line_z[absorbed], atom.line_ion[absorbed]))
    out.update(species=len(species), leading_species=top,
               leading_species_packets=int(n_top))
    if int(counts["No. of packets"].sum()) != n_top:
        raise AssertionError(f"last-line counts of {top}: "
                             f"{int(counts['No. of packets'].sum())} packets "
                             f"against {n_top} on the host")
    return out


def check_shell_info(sim):
    """shell_info_table and ion_fraction_table of every element: finite,
    one row a shell, each shell's ion fractions summing to 1."""
    from tardis_torch.analysis.shell_info import (
        ion_fraction_table,
        shell_info_table,
    )

    t = time.perf_counter()
    table = shell_info_table(sim)
    fractions = [ion_fraction_table(sim, int(z))
                 for z in sim.plasma_solver.element_z]
    wall = time.perf_counter() - t
    S = sim.state.no_of_shells
    ok = (table.shape[0] == S and np.isfinite(table.to_numpy()).all()
          and all(f.shape[0] == S and np.allclose(f.sum(axis=1), 1.0,
                                                  rtol=1e-12)
                  for f in fractions))
    if not ok:
        raise AssertionError("shell_info_table / ion_fraction_table")
    return dict(wall_s=wall, columns=list(table.columns),
                elements=len(fractions))


def run_grid_path(atom, expected):
    """TardisGrid.from_axes over GRID_AXES on the bench data with no device
    (so on the card); each row's simulation runs 1 + 1 iterations of
    GRID_PACKETS with the launch counts reset and the peak memory
    statistics cleared just before and read just after.  One line a row:
    its wall, t_inner, launches and torch.cuda.max_memory_allocated.
    Held: every row on the card, its shell count, finite outputs and the
    launch counts."""
    from tardis_torch.grid.base import TardisGrid

    grid = TardisGrid.from_axes(copy.deepcopy(GRID_CONFIG), GRID_AXES,
                                atom_data=atom)
    t0 = time.perf_counter()
    for i in range(len(grid.grid)):
        row = {k: (v.item() if hasattr(v, "item") else v)
               for k, v in grid.grid.iloc[i].items()}
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.no_grad():
            sim = grid.run_sim_from_grid(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = read_launches()
        res = sim.last_transport_result
        finite = bool(np.isfinite(sim.spectrum_real.luminosity_nu).all()
                      and np.isfinite(res.output_nu).all()
                      and np.isfinite(sim.state.t_radiative).all())
        say("grid_row", index=i, overrides=row, wall_s=wall,
            shells=sim.state.no_of_shells, t_inner=sim.state.t_inner,
            launches=launches,
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            L_emitted_over_requested=res.emitted_luminosity(
                *sim._lum_nu_window()) / sim.state.luminosity_requested,
            finite=finite, card=card_line())
        if not (finite and sim.plasma_solver.device.type == "cuda"
                and sim.state.no_of_shells
                == row["model.structure.velocity.num"]):
            raise AssertionError(f"grid row {i}: {row}")
        check_launches(f"grid_row {i}", launches, expected)
        grid.results[i] = None
        del sim, res
        torch.cuda.empty_cache()
    say("grid_path", rows=len(grid.grid), wall_s=time.perf_counter() - t0)


# the harness phase: each benchmark harness with the arguments a user
# passes for the bench workload (bench.py's, less the TPU's --batch and
# --chunk), production_run at its defaults, scaling_bench over shards of
# this one card
HARNESS_RUNS = {
    "transport_bench": ["--packets", str(N_PACKETS), "--levels", "200",
                        "--jump", "60", "--mode", "macroatom",
                        "--e2e-iters", "5", "--final-vpackets", "2",
                        "--iip", "--roofline"],
    "production_run": [],
    "scaling_bench": ["--one-card", "--devices", "1", "2", "4"],
}
HARNESS_TIMEOUT_S = 420  # a harness's subprocess
# what each harness's line must hold (dotted paths)
HARNESS_KEYS = {
    "transport_bench": ("packets_per_s", "device_ms", "e2e.e2e_packets_per_s",
                        "final_iteration.time_s", "iip.events_per_s",
                        "roofline.fraction_of_bound"),
    "production_run": ("e2e_packets_per_s", "s_per_iteration",
                       "final_iteration_s", "emitted_over_requested",
                       "spectra_finite"),
    "scaling_bench": ("scaling", "shards_of_one_card"),
}
EMITTED_BAND = (0.8, 1.2)


def numbers_in(x):
    """Every number (bools aside) in a JSON value, however nested."""
    if isinstance(x, dict):
        for v in x.values():
            yield from numbers_in(v)
    elif isinstance(x, list):
        for v in x:
            yield from numbers_in(v)
    elif isinstance(x, (int, float)) and not isinstance(x, bool):
        yield x


def dotted(line, key):
    for part in key.split("."):
        if not isinstance(line, dict) or part not in line:
            return None
        line = line[part]
    return line


def check_harness_line(name, line, device="cuda"):
    """Raise unless a harness's line ran on ``device``, holds only finite
    numbers and the keys HARNESS_KEYS names, every emitted / requested
    luminosity in EMITTED_BAND, every spectra_finite true, and (the
    scaling harness) rows of 1, 2 and 4 shards of one card."""
    faults = []
    if line.get("device") != device:
        faults.append(f"device {line.get('device')!r}")
    if not all(math.isfinite(v) for v in numbers_in(line)):
        faults.append("a number that is not finite")
    faults += [f"no {key}" for key in HARNESS_KEYS[name]
               if dotted(line, key) is None]
    ratio = line.get("emitted_over_requested")
    if ratio is not None and not EMITTED_BAND[0] <= ratio <= EMITTED_BAND[1]:
        faults.append(f"emitted_over_requested {ratio}")
    if line.get("spectra_finite") is False:
        faults.append("spectra not finite")
    if name == "scaling_bench" and not (
            line.get("shards_of_one_card") is True
            and [r.get("devices") for r in line.get("scaling", [])]
            == [1, 2, 4]):
        faults.append("not 1, 2 and 4 shards of one card")
    if faults:
        raise AssertionError(f"harness {name}: {', '.join(faults)}")


def run_harness(k1_smoke):
    """Each of HARNESS_RUNS as a user runs it: ``python -m
    tardis_torch.benchmarks.<name> <args>`` in a subprocess from this
    repository's root, its JSON line (the last of its output) echoed and
    held by check_harness_line.  ``k1_smoke`` is phase 2's device ms of
    the instantiation and shape the transport harness times."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    lines = {}
    for name, args in HARNESS_RUNS.items():
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"tardis_torch.benchmarks.{name}", *args],
            cwd=root, capture_output=True, text=True,
            timeout=HARNESS_TIMEOUT_S)
        wall = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(f"harness {name} exited with "
                                 f"{proc.returncode}:\n{proc.stderr[-3000:]}")
        lines[name] = json.loads(proc.stdout.strip().splitlines()[-1])
        say("harness", harness=name, args=args, wall_s=wall,
            line=lines[name])
        check_harness_line(name, lines[name])
    k1_ms = lines["transport_bench"]["device_ms"]
    say("harness_phase", wall_s=time.perf_counter() - t0,
        k1_device_ms_harness=k1_ms, k1_device_ms_smoke=k1_smoke,
        k1_harness_over_smoke=k1_ms / k1_smoke if k1_ms else None,
        card=card_line())
    return lines


# what the sharded path holds against the main path's separate run
MAIN_HELD = ("t_inner", "t_rad", "real_luminosity", "virtual_luminosity",
             "integrated_luminosity")


def path_numbers(sim):
    """What the sharded path compares with the main path."""
    out = dict(t_inner=np.array([sim.state.t_inner]),
               t_rad=np.asarray(sim.state.t_radiative, float))
    for name in ("real", "virtual", "integrated"):
        spectrum = getattr(sim, f"spectrum_{name}")
        out[name] = np.asarray(spectrum.luminosity_nu)
        out[f"{name}_luminosity"] = np.array([spectrum.luminosity])
    return out


def check_launches(phase, launches, expected):
    """Every line in ``expected`` launched exactly that often (None: at
    least once) and no other line at all."""
    def off(line):
        n, want = launches.get(line, 0), expected.get(line, 0)
        return n < 1 if want is None else n != want

    if any(off(line) for line in set(launches) | set(expected)):
        raise AssertionError(f"{phase}: kernel launches {launches}, "
                             f"expected {expected}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tardis_torch import cuda
    from tardis_torch.transport import vpacket

    hdf, failed_import = hdf_support()
    say("hdf_loader", available=hdf, failed_import=failed_import,
        walk_path_atom_data="atom_data_from_hdf" if hdf
        else "atom_data_from_arrays")
    # the analysis tables and the grid need pandas, the plots matplotlib,
    # their interactive figures plotly
    pandas_ok, failed_pandas_import = import_support("pandas")
    plots, failed_plot_import = import_support("matplotlib")
    plotly_ok, failed_plotly_import = import_support("plotly")
    say("analysis_imports", pandas=pandas_ok, matplotlib=plots,
        plotly=plotly_ok,
        failed_imports=[m for m in (failed_pandas_import,
                                    failed_plot_import,
                                    failed_plotly_import) if m])
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    global RATES
    RATES = card_rates()
    rates = RATES.summary()
    libs = [(name, ()) for name in cuda.KERNELS if name not in WITH_OPTIONS]
    build_s = cuda.build(libs)
    say("header", card=card, torch=torch.__version__,
        cuda=torch.version.cuda, build_s=build_s, ptxas=ptxas_lines(libs),
        rates=rates)

    t = time.perf_counter()
    config, state, atom = build_problem(device)
    say("problem", lines=atom.n_lines, levels=atom.n_levels,
        shells=state.no_of_shells, setup_s=time.perf_counter() - t)
    t = time.perf_counter()
    large_atom = build_large_ion_atom()
    say("large_ion_problem", lines=large_atom.n_lines,
        levels=large_atom.n_levels,
        macro_levels=len(large_atom.macro_atom.block_references) - 1,
        setup_s=time.perf_counter() - t)
    k1, k4 = {}, {}
    with torch.no_grad():
        t = time.perf_counter()
        k_probe = check_probe2(device)
        ps, k3, k3_est = check_line_tables(state, atom, device,
                                           K3_WIDE_SHELLS)
        pools, k2 = check_pools(state, device)
        chain, k8s = check_chain_build(atom, ps, large_atom)
        k8 = k8s["macroatom_cluster"]
        tables = path_tables(state, atom, ps, chain)
        walk_tables, walk_build = walk_path_tables(state, atom, ps)
        iip_state, iip_atom = build_iip_problem()
        tables_iip = {
            "iip": iip_tables(iip_state, iip_atom, device),
            "iip_options": iip_tables(iip_state, iip_atom, device,
                                      channels=True)}
        build_s, ptxas = build_variants(tables, pools, tables_iip.values(),
                                        walk_tables.values())
        say("build_variants", build_s=build_s, ptxas=ptxas)
        for path, opts in PATHS.items():
            k1[path], records = check_transport_loop(
                path, tables[path], pools[opts["pool"]])
            k1[f"{path}_final"] = k1[path]["final"]
            k1[path] = k1[path]["convergence"]
            # each K4 instantiation once, on the first path that selects it
            # (the v_inner path's is the main path's)
            held = {k["name"] for k in k4.values()}
            if records is not None and line_name(
                    "vpacket_volley",
                    vpacket.variant_name(tables[path])) not in held:
                k4[path] = check_vpacket_volley(tables[path], records,
                                                device)
            del records
            torch.cuda.empty_cache()
        check_sharded_transport(tables["main"], pools["simple"], device)
        torch.cuda.empty_cache()
        k1_walk = check_walk_loop(walk_tables, walk_build, pools["simple"])
        del walk_tables
        torch.cuda.empty_cache()
        large_prefix = check_large_prefix(device)
        torch.cuda.empty_cache()
        ps_main, pools_main = ps, pools["simple"]
        del ps, chain, tables, pools
        torch.cuda.empty_cache()
        k1.update(check_iip_kernels(device, iip_state, iip_atom, tables_iip,
                                    k3))
        k4_continuum = k1.pop("iip_records_k4")
        check_sharded_continuum(tables_iip["iip"], iip_state, device)
        del tables_iip
        torch.cuda.empty_cache()
        k7s = check_nonhom_loop(state, atom, ps_main, pools_main)
        k7, k7_final = k7s["convergence"], k7s["final"]
        del ps_main, pools_main
        torch.cuda.empty_cache()
        k6 = check_gamma_step(state, device)
        torch.cuda.empty_cache()
        say("kernel_checks", wall_s=time.perf_counter() - t)
        # each path's launches: K3 every iteration, its own K2, K1 and K4
        # lines as often as it runs them (K1 without line estimators in
        # every convergence iteration, with them in the final one), and no
        # other variant
        # K8: one chain build an iteration on every classic path that
        # takes the chain tables
        expected = {path: {"line_tables": None,
                           k2[opts["pool"]]["name"]: ITERATIONS,
                           k1[path]["name"]: ITERATIONS - 1,
                           k1[f"{path}_final"]["name"]: 1,
                           "macro_chain": ITERATIONS}
                    for path, opts in PATHS.items()}
        for path in ("main", "relativity"):
            expected[path].update({k4[path]["name"]: 1, "formal_integral": 1})
        expected["options"].update({
            k2["weighted"]["name"]: OPTIONS_ITERATIONS,
            k1["options"]["name"]: OPTIONS_ITERATIONS - 1,
            "macro_chain": OPTIONS_ITERATIONS})
        for path, n in (("iip", IIP_ITERATIONS),
                        ("iip_options", IIP_OPTIONS_ITERATIONS)):
            expected[path] = {"line_tables": None,
                              k2["relativistic"]["name"]: n,
                              k1[path]["name"]: n}
        # the workflow's iteration (K2, the continuum K1), its records run
        # (K2, the continuum K1 with records, K4 under full relativity),
        # then run_tardis with continuum species: the classic loop's K2 and
        # the v_inner path's K1 lines (last-interaction rows), the main
        # path's K4
        expected["iip_vpacket"] = {
            "line_tables": None, k2["relativistic"]["name"]: 2,
            k1["iip"]["name"]: 1, k1["iip_records"]["name"]: 1,
            k4_continuum["counted_as"]: 1, k2["simple"]["name"]: 2,
            k1["v_inner"]["name"]: 1, k1["v_inner_final"]["name"]: 1,
            k4["main"]["name"]: 1, "macro_chain": 2}
        expected["nonhom"] = {"line_tables": None,
                              k2["simple"]["name"]: NONHOM_ITERATIONS,
                              k7["name"]: NONHOM_ITERATIONS - 1,
                              k7_final["name"]: 1}
        # K6: two kernel launches a step (the list, the walk)
        expected["gamma"] = {k6["name"]: 2 * GAMMA_STEPS}
        # detailed rates: K1 with line estimators in every iteration, K3's
        # default instantiation for the first solve and its estimators
        # one for each solve after a convergence iteration, no final
        # re-solve
        expected["detailed_nlte"] = {
            "line_tables": 3, k3_est["name"]: 3 * (ITERATIONS - 1),
            k2["simple"]["name"]: ITERATIONS,
            k1["main_final"]["name"]: ITERATIONS,
            k4["main"]["name"]: 1, "formal_integral": 1,
            "macro_chain": ITERATIONS}
        # the main path with two shards: K1 twice an iteration
        expected["sharded"] = dict(expected["main"])
        expected["sharded"][k1["main"]["name"]] = 2 * (ITERATIONS - 1)
        expected["sharded"][k1["main_final"]["name"]] = 2
        expected["probe"] = {name: None for name in k_probe}
        # the walk path: the main path's lines with K1's walk
        # instantiations in place of its chain ones
        expected["walk"] = {"line_tables": None,
                            k2["simple"]["name"]: WALK_ITERATIONS,
                            k1_walk["convergence"]["name"]:
                                WALK_ITERATIONS - 1,
                            k1_walk["final"]["name"]: 1,
                            k4["main"]["name"]: 1, "formal_integral": 1}
        # the command-line path: K3, K2 and K1 as the main path's, one
        # convergence iteration and the final one with K4, no K5
        expected["cli"] = {"line_tables": None,
                           k2["simple"]["name"]: CLI_ITERATIONS,
                           k1["main"]["name"]: CLI_ITERATIONS - 1,
                           k1["main_final"]["name"]: 1,
                           k4["main"]["name"]: 1,
                           "macro_chain": CLI_ITERATIONS}
        # the v_inner path: its own K1 lines (last-interaction rows), the
        # main path's K4, no K5; a grid row: the main path's K1 lines, no
        # K4
        expected["v_inner"] = {"line_tables": None,
                               k2["simple"]["name"]: V_INNER_ITERATIONS,
                               k1["v_inner"]["name"]: V_INNER_ITERATIONS - 1,
                               k1["v_inner_final"]["name"]: 1,
                               k4["main"]["name"]: 1,
                               "macro_chain": V_INNER_ITERATIONS}
        expected["grid"] = {"line_tables": None,
                            k2["simple"]["name"]: GRID_CONFIG[
                                "montecarlo"]["iterations"],
                            k1["main"]["name"]: 1,
                            k1["main_final"]["name"]: 1,
                            "macro_chain": GRID_CONFIG["montecarlo"][
                                "iterations"]}
        # the large-ion path: the main path's lines without K5, K8's
        # large-system instantiation in place of its cluster one
        expected["large_ion"] = {
            key: n for key, n in expected["main"].items()
            if key not in ("formal_integral", "macro_chain")}
        expected["large_ion"]["macro_chain[macroatom_large]"] = ITERATIONS
        launches = {}
        sim, launches["main"], wall = run_path("main_path", BENCH_CONFIG,
                                               atom, device,
                                               expected["main"])
        k5 = check_formal_integral(sim, device)
        main = dict(path_numbers(sim), wall_s=wall)
        del sim
        torch.cuda.empty_cache()
        launches["large_ion"] = run_large_ion_path(large_atom, device,
                                                   expected["large_ion"])
        torch.cuda.empty_cache()
        launches["sharded"] = run_sharded_path(atom, device,
                                               expected["sharded"], main)
        torch.cuda.empty_cache()
        launches["detailed_nlte"] = run_detailed_nlte_path(
            atom, device, expected["detailed_nlte"])
        torch.cuda.empty_cache()
        launches["relativity"] = run_relativity_path(
            atom, device, expected["relativity"])
        torch.cuda.empty_cache()
        launches["options"] = run_options_path(atom, device,
                                               expected["options"])
        torch.cuda.empty_cache()
        launches["walk"] = run_walk_path(device, expected["walk"], hdf)
        torch.cuda.empty_cache()
        launches["helium"], launches["numerical_helium"] = run_helium_path(
            device, k2["simple"]["name"], k1, k1_walk)
        torch.cuda.empty_cache()
        t = time.perf_counter()
        launches["model_file"] = run_model_file_path(
            device, k1, k1_walk, k2["simple"]["name"], k4["main"]["name"])
        torch.cuda.empty_cache()
        launches["cli"] = run_cli_path(device, expected["cli"], hdf,
                                       failed_import)
        torch.cuda.empty_cache()
        say("model_io_phases", wall_s=time.perf_counter() - t)
        t = time.perf_counter()
        sim, launches["v_inner"] = run_v_inner_path(
            atom, expected["v_inner"], plots, failed_plot_import)
        check_analysis(sim, pandas_ok)
        del sim
        torch.cuda.empty_cache()
        if pandas_ok:
            run_grid_path(atom, expected["grid"])
        else:
            print(f"grid: skipped, {failed_pandas_import}", flush=True)
        torch.cuda.empty_cache()
        say("around_run_phases", wall_s=time.perf_counter() - t,
            card=card_line())
        launches["iip"] = run_iip_path("iip_path", IIP_CONFIG, iip_atom,
                                       device, expected["iip"])
        torch.cuda.empty_cache()
        launches["iip_options"] = run_iip_path(
            "iip_options_path", IIP_OPTIONS_CONFIG, iip_atom, device,
            expected["iip_options"])
        torch.cuda.empty_cache()
        launches["iip_vpacket"] = run_iip_vpacket_path(
            iip_atom, device, expected["iip_vpacket"], plots,
            failed_plot_import)
        torch.cuda.empty_cache()
        launches["nonhom"] = run_nonhom_path(atom, device, expected["nonhom"])
        torch.cuda.empty_cache()
        launches["gamma"], k6_path = run_gamma_path(state, device,
                                                    expected["gamma"])
        k6.update(k6_path)
        torch.cuda.empty_cache()
        launches["probe"] = run_probe_path(device, expected["probe"])
        torch.cuda.empty_cache()
        profile_main_path(atom, device)
        profile_main_path(large_atom, device, LARGE_ION_CONFIG,
                          "profile_large_ion")
        profile_walk_path(device)
        profile_iip_path(iip_atom, device)
        k6["path_device_ms_total"] = profile_gamma_path(state, device)
    torch.cuda.empty_cache()
    run_harness(k1["main_final"]["detailed_convergence"]["device_ms"])
    # each line's launches come from the path that runs it
    lines = [(k1["main"], "main"), (k1["main_final"], "main"),
             (k2["simple"], "main"), (k3, "main"), (k8, "main"),
             (k4["main"], "main"), (k5, "main"),
             (k3_est, "detailed_nlte"),
             (k1["relativity"], "relativity"),
             (k1["relativity_final"], "relativity"),
             (k2["relativistic"], "relativity"),
             (k4["relativity"], "relativity"),
             (k1["options"], "options"), (k1["options_final"], "options"),
             (k2["weighted"], "options"),
             (k1_walk["convergence"], "walk"), (k1_walk["final"], "walk"),
             (k1["v_inner"], "v_inner"), (k1["v_inner_final"], "v_inner"),
             (k1["iip"], "iip"), (k1["iip_options"], "iip_options"),
             (k1["iip_records"], "iip_vpacket"),
             (k4_continuum, "iip_vpacket"),
             (k7, "nonhom"), (k7_final, "nonhom"), (k6, "gamma")] + [
                 (k, "probe") for k in k_probe.values()]
    for k, path in lines:
        k["launches"] = launches[path][k.get("counted_as", k["name"])]
        if k["name"] in large_prefix:
            k.setdefault("checks", []).append("large_prefix")
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} never launched on its path")
    # K8's large-system instantiation, on the large-ion path (the main
    # path's components are the cluster one's)
    k = k8s["macroatom_large"]
    k["launches"] = launches["large_ion"][k["name"]]
    k["main_path_launches"] = launches["main"].get(k["name"], 0)
    if k["launches"] < 1:
        raise AssertionError(f"{k['name']} never launched on its path")
    lines.append((k, "large_ion"))
    # downbranch, held above off the paths: no path launches it
    k = k8s["downbranch"]
    k["launches"] = launches["main"].get(k["name"], 0)
    k["on_main_path"] = False
    lines.append((k, None))
    # the same K1 instantiations, two shards an iteration on the sharded
    # path
    for key in ("main", "main_final"):
        k1[key]["sharded_path_launches"] = launches["sharded"][
            k1[key]["name"]]
    # the detailed_nlte path's launches of the final instantiation (every
    # iteration) and of K3's default one
    k1["main_final"]["detailed_nlte_path_launches"] = launches[
        "detailed_nlte"][k1["main_final"]["name"]]
    k3["detailed_nlte_path_launches"] = launches["detailed_nlte"][
        "line_tables"]
    print(json.dumps({"kernels": [k for k, _ in lines]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
