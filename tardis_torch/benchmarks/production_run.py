"""Production-scale demonstration run.

Counterpart of ``tardis_tpu/benchmarks/production_run.py``.  Executes the
full production pipeline at reference-benchmark scale and beyond: the
kurucz-like 183k-line list, macroatom interactions, N damped convergence
iterations of ``packets`` Monte Carlo packets each, then a final
high-statistics iteration with virtual packets and the formal integral;
prints one JSON line with wall-clock, per-phase costs, and
convergence / sanity figures.

The reference's headline ASV benchmark (``time_run_tardis``,
benchmarks/run_tardis.py) runs 2e5 packets x 5 iterations + 5e5 final;
the default here is 2,097,152 x 20 + 4,194,304 final.

Usage: python -m tardis_torch.benchmarks.production_run [--packets N]
       [--iterations K] [--final N] [--vpackets V] [--levels L]
       [--jump J] [--checkpoint FILE] [--device cpu]

It runs on the card unless ``--device cpu`` asks for the plain PyTorch
versions, raises where there is no card, and exits non-zero when it ran on
another device than the one asked for.  Every host clock is read after
``torch.cuda.synchronize()``.  The line has the JAX module's keys, with
``device`` (``cuda`` or ``cpu``) in the place of ``platform`` and ``card``
(the card's name and power limit from ``nvidia-smi``, null on the CPU).
``--checkpoint`` needs h5py (``io/hdf.py``) and raises an ``ImportError``
naming it where h5py does not import.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from tardis_torch.benchmarks.transport_bench import (
    build_problem,
    device_fields,
    refuse_other_device,
    sync,
)
from tardis_torch.cuda import resolve_device
from tardis_torch.simulation.base import Simulation


def packet_accounting(packets, iterations, final, resumed_from):
    """(the run's whole workload, the convergence iterations this process
    ran (at least 1, the divisor of ``s_per_iteration``), the packets this
    process ran): a resumed run's throughput counts only the work done
    after the resume, since its convergence time spans only those
    iterations."""
    total = packets * iterations + final
    run_iterations = max(iterations - resumed_from, 1)
    run_packets = packets * (iterations - resumed_from) + final
    return total, run_iterations, run_packets


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="a production-scale run of the port (one JSON line)")
    ap.add_argument("--packets", type=int, default=2_097_152)
    ap.add_argument("--iterations", type=int, default=20)
    ap.add_argument("--final", type=int, default=4_194_304)
    ap.add_argument("--vpackets", type=int, default=2)
    ap.add_argument("--levels", type=int, default=200)
    ap.add_argument("--jump", type=int, default=60)
    ap.add_argument(
        "--checkpoint", default=None,
        help="checkpoint file (needs h5py): written every iteration; if it "
        "already exists the run resumes from it",
    )
    ap.add_argument(
        "--device", default=None,
        help="the device to run on (default: the card; 'cpu' runs the "
        "plain PyTorch versions); exits non-zero if the run lands on "
        "another",
    )
    args = ap.parse_args(argv)
    if args.checkpoint:
        try:
            import h5py  # noqa: F401
        except ImportError as exc:
            raise ImportError(
                f"--checkpoint needs h5py, which does not import here "
                f"({exc})") from exc

    device = resolve_device(args.device)
    with torch.no_grad():
        t_setup0 = time.perf_counter()
        config, state, atom, _ = build_problem(
            args.levels, args.jump, "macroatom",
            mc_overrides={
                "no_of_packets": args.packets,
                "iterations": args.iterations + 1,
                "last_no_of_packets": args.final,
                "no_of_virtual_packets": args.vpackets,
                "tracking": {"track_last_interaction": False},
                "convergence_strategy": {"type": "damped",
                                         "damping_constant": 0.5},
            },
            device=device,
        )
        sim = Simulation.from_config(config, atom_data=atom, device=device)
        resumed_from = 0
        if args.checkpoint and os.path.exists(args.checkpoint):
            from tardis_torch.io.hdf import resume_simulation

            resume_simulation(sim, args.checkpoint)
            resumed_from = sim.iterations_executed
            print(f"# resuming from iteration {resumed_from}", flush=True)
        sync(device)
        setup_s = time.perf_counter() - t_setup0

        t0 = time.perf_counter()
        sim.run_convergence(checkpoint_path=args.checkpoint)
        sync(device)
        convergence_s = time.perf_counter() - t0

        t1 = time.perf_counter()
        sim.run_final()
        sync(device)
        final_s = time.perf_counter() - t1

        t2 = time.perf_counter()
        spec_int = sim.integrate_spectrum()
        sync(device)
        integral_s = time.perf_counter() - t2

    t_rad = np.asarray(sim.state.t_radiative, np.float64)
    w = np.asarray(sim.state.dilution_factor, np.float64)
    lum = np.asarray(sim.spectrum_real.luminosity_nu, np.float64)
    total_packets, run_iterations, run_packets = packet_accounting(
        args.packets, args.iterations, args.final, resumed_from)
    # the last convergence iteration's emitted luminosity; a resumed run
    # with no iteration left to converge has only the final one's
    emitted = (sim.history[-1].emitted_luminosity if sim.history else
               sim.last_transport_result.emitted_luminosity(
                   *sim._lum_nu_window()))
    out = {
        "n_lines": atom.n_lines,
        "n_shells": sim.state.no_of_shells,
        "iterations": args.iterations,
        "packets_per_iteration": args.packets,
        "final_packets": args.final,
        "n_vpackets": args.vpackets,
        "total_packets": total_packets,
        "setup_s": round(setup_s, 2),
        "convergence_s": round(convergence_s, 2),
        "s_per_iteration": round(convergence_s / run_iterations, 3),
        "final_iteration_s": round(final_s, 2),
        "formal_integral_s": round(integral_s, 2),
        "total_s": round(convergence_s + final_s + integral_s, 2),
        "resumed_from_iteration": resumed_from,
        "e2e_packets_per_s": round(
            run_packets / (convergence_s + final_s), 1
        ),
        "t_inner": round(float(sim.state.t_inner), 1),
        "t_rad_range": [round(t_rad.min(), 1), round(t_rad.max(), 1)],
        "w_range": [round(w.min(), 4), round(w.max(), 4)],
        "emitted_over_requested": round(
            emitted / sim.state.luminosity_requested, 4
        ),
        "spectra_finite": bool(
            np.isfinite(lum).all()
            and np.isfinite(
                np.asarray(sim.spectrum_virtual.luminosity_nu)
            ).all()
            and np.isfinite(np.asarray(spec_int.luminosity_nu)).all()
        ),
        **device_fields(sim.plasma_state.tau_prefix.device),
    }
    refuse_other_device(args.device, out)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
