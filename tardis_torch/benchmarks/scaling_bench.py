"""Multi-device scaling-efficiency harness.

Counterpart of ``tardis_tpu/benchmarks/scaling_bench.py``.  Measures
packet throughput against device count for packet-parallel transport
(``parallel/transport.py`` ``run_transport_sharded``: one K1 launch a
shard, then ``_final_reduce``).  Weak scaling: the packets a device are
fixed, so ideal scaling doubles packets/s with each doubling of devices;
efficiency = (throughput_N / throughput_1) / N.  ``_final_reduce``, the
estimators' reduce that runs once after the shards, is timed alone on the
same shards' outputs (``est_reduce_s``).

The device list is every visible card by default (``packet_devices``), or
the one ``--device`` names; device counts past it are skipped (listed
under ``skipped``).  ``--one-card`` runs every count as shards of one
card (a device list that repeats it), the counterpart of the JAX
module's virtual CPU mesh: it checks the sharding and measures its
overheads on one card, not scaling across cards, and the line says so
(``"shards_of_one_card": true``).

Usage: python -m tardis_torch.benchmarks.scaling_bench [--per-device N]
       [--devices 1 2 4 8] [--mode scatter] [--one-card] [--device cpu]

It runs on the card unless ``--device cpu`` asks for the plain PyTorch
versions, raises where there is no card, and exits non-zero when it ran on
another kind of device than the one asked for.  Every host clock is read
after synchronising every device of the list.  It prints one JSON line:
the JAX module's list of rows (``devices``, ``n_packets``, ``time_s``,
``packets_per_s``, ``est_reduce_s``, ``efficiency``) under ``scaling``,
with ``device`` (``cuda`` or ``cpu``), ``card`` (the first card's name
and power limit from ``nvidia-smi``, null on the CPU),
``shards_of_one_card`` and ``skipped``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from tardis_torch.benchmarks.transport_bench import (
    build_problem,
    device_fields,
    problem_tables,
    refuse_other_device,
    sync,
)
from tardis_torch.cuda import resolve_device
from tardis_torch.parallel.transport import (
    _final_reduce,
    _sharded_chunk,
    packet_devices,
    run_transport_sharded,
)
from tardis_torch.transport import rng
from tardis_torch.transport.source import blackbody_source


def run_scaling(per_device=8192, device_counts=(1, 2, 4, 8), mode="scatter",
                n_levels=30, repeats=2, devices=None):
    """One row per device count that the device list (``devices``; every
    visible card by default, a device may repeat) holds: the best of
    ``repeats`` timed runs after one untimed run, and ``_final_reduce``
    alone on that run's shards."""
    devices = packet_devices(devices)
    config, state, atom, plasma = build_problem(n_levels, None, mode,
                                                device=devices[0])
    tables, _, _ = problem_tables(state, atom, plasma, mode)
    key = rng.key(np.uint32(7))

    def sync_all(devs):
        for d in dict.fromkeys(devs):
            sync(d)

    results = []
    with torch.no_grad():
        for n_dev in device_counts:
            if n_dev > len(devices):
                continue
            devs = devices[:n_dev]
            n_packets = per_device * n_dev
            pool_mu, pool_nu, _ = blackbody_source(
                rng.fold_in(key, 0), n_packets, state.t_inner, devices[0])
            run_key = rng.fold_in(key, 1)
            times = []
            for _ in range(repeats + 1):
                sync_all(devs)
                t0 = time.perf_counter()
                run_transport_sharded(tables, pool_mu, pool_nu, run_key,
                                      devs)
                sync_all(devs)
                times.append(time.perf_counter() - t0)
            best = min(times[1:])  # the first run builds K1
            # the estimators' reduce alone, on one run's shards: it runs
            # once after the last shard, so its own cost is the whole
            # reduce overhead of an iteration
            parts = _sharded_chunk(tables, pool_mu, pool_nu, run_key, devs)
            red_times = []
            for _ in range(repeats + 1):
                sync_all(devs)
                t0 = time.perf_counter()
                _final_reduce(parts, devs[0])
                sync_all(devs)
                red_times.append(time.perf_counter() - t0)
            results.append(
                {
                    "devices": n_dev,
                    "n_packets": n_packets,
                    "time_s": best,
                    "packets_per_s": n_packets / best,
                    "est_reduce_s": min(red_times[1:]),
                }
            )
    base = results[0]["packets_per_s"] / results[0]["devices"]
    for r in results:
        r["efficiency"] = r["packets_per_s"] / (base * r["devices"])
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="packet throughput against device count (one JSON "
        "line)")
    ap.add_argument("--per-device", type=int, default=8192)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--mode", default="scatter",
                    choices=("scatter", "downbranch", "macroatom"))
    ap.add_argument(
        "--one-card", action="store_true",
        help="run every count as shards of one card (the device repeated): "
        "the sharding's overheads, not scaling across cards",
    )
    ap.add_argument(
        "--device", default=None,
        help="the device to run on (default: every visible card; 'cpu' "
        "runs the plain PyTorch versions); exits non-zero if the run lands "
        "on another kind",
    )
    args = ap.parse_args(argv)
    first = resolve_device(args.device)  # raises with no card
    if args.one_card:
        devices = [first] * max(args.devices)
    elif args.device is None:
        devices = packet_devices()
    else:
        devices = [first]
    rows = run_scaling(per_device=args.per_device,
                       device_counts=tuple(args.devices), mode=args.mode,
                       devices=devices)
    out = {
        "scaling": rows,
        "shards_of_one_card": bool(args.one_card),
        "skipped": [n for n in args.devices if n > len(devices)],
        **device_fields(devices[0]),
    }
    refuse_other_device(args.device, out)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
