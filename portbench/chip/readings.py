"""Readings for the limits of a cell's comparison, on the chip, in one
process: for each seed one short window of the timed path, then the
numbers of its sample against the reference and the control's (the
reference in the next lower precision in the program's place), and
whatever else the driver's ``readings`` reports.  Not run by the
benchmark.

    python3 portbench/chip/readings.py --workload w7.converge \
        --seconds 2 --seeds 11 12 13 --out chiprun_out/r.jsonl
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

from portbench.harness import cache_dirs, load_json, load_module  # noqa: E402
from portbench.trace import Probe  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cache_dirs()
    cell = load_json("traffic", args.workload)
    config = load_json("configs", cell["config"])
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    drv = load_module("drivers", cell["driver"])
    d = drv.make(cell, config, device, Probe(timing=False))
    d.warm()
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t0 = time.time()
        stats = d.window(args.seconds, seed)
        sample = stats.pop("sample")
        t1 = time.time()
        row = dict(seed=seed, iterations=stats["iterations"],
                   models=stats["models"], failed=stats["failed"],
                   metrics=stats["metrics"], window_s=t1 - t0)
        row.update(d.readings(sample, control=not args.no_control))
        row["check_s"] = time.time() - t1
        del sample
        torch.cuda.empty_cache()
        line = json.dumps(row, default=float)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()


if __name__ == "__main__":
    main()
