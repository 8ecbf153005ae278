"""One run of one cell: set-up, the measured window, the comparison that
decides ``correct``, and the result line.

Everything is found by name under ``portbench/``: the cell's traffic file
``traffic/<workload>.json`` names its configuration
(``configs/<config>.json``) and its entry kind (``drivers/<kind>.py``);
the per-layer metrics are the files ``layers/*.py`` whose ``WORKLOADS``
hold the cell, each with the probes it needs; a kernel's bound is
``bounds/<kernel>.py``.

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` runs
the same window under torch.profiler with the probes timing, and reports
the per-layer metrics, the device's busy and window seconds and the
breakdown.  Either way the run ends with the comparison and prints each
number compared beside its limit, last on standard error and last in the
result line.
"""

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tardis_tpu")


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"portbench: no {kind} file {path.name}")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"portbench: no {kind} file {path.name}")
    mod_name = f"portbench.{kind}.{name.replace('.', '__')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def layers_for(workload: str) -> list:
    mods = [load_module("layers", p.stem)
            for p in sorted((HERE / "layers").glob("*.py"))]
    return [m for m in mods if workload in m.WORKLOADS]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs():
    """Fixed cache directories inside the checkout (the program builds its
    kernels into ``tardis_torch/build``, itself a fixed path there)."""
    base = ROOT / "tardis_torch" / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def say(*parts):
    print(*parts, file=sys.stderr, flush=True)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = load_json("traffic", args.workload)
    config = load_json("configs", cell["config"])
    cache_dirs()
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        say(f"portbench: {args.workload} needs {cell['chips']} CUDA "
            f"card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    import tardis_torch  # noqa: F401  (fails where the program is absent)

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(args, cell, config, device, t_start)
    if result is None:
        return 4
    print(json.dumps(result), flush=True)
    return 0


def run_cell(args, cell: dict, config: dict, device, t_start: float):
    """Set-up, window and comparison of one run on ``device``; the result
    line's object, or None where the process holds a forbidden module.
    On the CPU (the tests' rehearsal) it runs without ``--trace``."""
    import torch

    from portbench.compare import judge
    from portbench.trace import WINDOW_SPAN, Probe, analyse

    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tracing = bool(args.trace)
    probe = Probe(timing=tracing)
    layers = layers_for(args.workload) if tracing else []
    for lay in layers:
        for module, attr, label, host in getattr(lay, "PROBES", ()):
            if label not in probe.calls:
                owner = importlib.import_module(module)
                for part in attr.split(".")[:-1]:
                    owner = getattr(owner, part)
                probe.wrap(owner, attr.split(".")[-1], label, host=host)
    t_inputs = time.time()
    driver_mod = load_module("drivers", cell["driver"])
    names = driver_mod.NAMES
    driver = driver_mod.make(cell, config, device, probe)
    t_warm = time.time()
    driver.warm()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        torch.cuda.synchronize(device)
    counted = {k: v for lay in layers
               for k, v in getattr(lay, "COUNTED", {}).items()}
    counters0 = launch_counters(counted)
    for lst in (*probe.pairs.values(), *probe.host.values()):
        lst.clear()
    setup_s = time.time() - t_start
    say(f"portbench: set-up {setup_s:.3f} s: imports "
        f"{t_inputs - t_start:.3f}, inputs {t_warm - t_inputs:.3f}, "
        f"warm-up {t_start + setup_s - t_warm:.3f}")

    trace = None
    if tracing:
        from torch.profiler import ProfilerActivity, profile, record_function

        w0 = torch.cuda.Event(enable_timing=True)
        w1 = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW_SPAN):
                w0.record()
                stats = driver.window(args.seconds, args.seed)
                w1.record()
                torch.cuda.synchronize(device)
        trace = analyse(prof)
        del prof
        trace["event_window_ms"] = w0.elapsed_time(w1)
    else:
        stats = driver.window(args.seconds, args.seed)
    memory_peak = (int(torch.cuda.max_memory_allocated(device)) if cuda
                   else 0)
    counters = {k: v - counters0.get(k, 0)
                for k, v in launch_counters(counted).items()}
    found = forbidden_modules()
    if found:
        say("portbench: the process holds " + ", ".join(found))
        return None

    sample = stats.pop("sample")
    numbers = driver.check(sample)
    del sample
    limits = cell["limits"]
    correct = judge(numbers, limits, names) and stats["failed"] == 0

    if tracing:
        lost = lost_records(trace, counted, counters)
        if lost:
            say("portbench: trace lost records: " + json.dumps(lost))
        ctx = dict(probe=probe, trace=trace, stats=stats, lost=lost,
                   bounds=driver_mod.bound_inputs(driver, stats))
        metrics = {}
        for lay in layers:
            v = lay.read(ctx)
            if v is not None:
                metrics[lay.NAME] = {"value": v, "unit": lay.UNIT}
    else:
        metrics = {k: {"value": v, "unit": u}
                   for k, (v, u) in stats["metrics"].items()}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    result = {
        "correct": correct,
        "attempted": stats["iterations"],
        "failed": stats["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else device.type,
            "kind": (torch.cuda.get_device_name(device) if cuda
                     else device.type),
            "count": int(cell["chips"]),
            "memory_peak_bytes": memory_peak,
        },
    }
    if tracing:
        result["device"]["busy_s"] = busy_seconds(trace, probe, lost)
        result["device"]["window_s"] = trace["window_s"]
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    result["compared"] = {n: {"value": numbers[n], "limit": limits.get(n)}
                          for n in names}
    probe.restore()
    say(f"portbench: {args.workload} seed {args.seed}: "
        f"{stats['iterations']} iterations, {stats['models']} models, "
        f"{stats['wall_s']:.3f} s, correct {correct}")
    walls = stats.get("iteration_s")
    if walls:
        import numpy as np

        q = np.percentile(np.asarray(walls) * 1e3, [50, 90, 99, 100])
        say("portbench: iteration ms p50 %.3f p90 %.3f p99 %.3f max %.3f"
            % tuple(q))
    for n in names:
        say(f"compared {n}: {numbers[n]!r} limit {limits.get(n)!r}")
    return result


def launch_counters(counted: dict) -> dict:
    """The program's launch counts of each counted kernel (a layer file's
    ``COUNTED``: label -> (module, function with ``launches_by_variant``,
    the names of its records in a trace))."""
    out = {}
    for label, (module, fn, _) in counted.items():
        counts = getattr(getattr(importlib.import_module(module), fn),
                         "launches_by_variant", {})
        out[label] = int(sum(counts.values()))
    return out


def lost_records(trace: dict, counted: dict, counters: dict) -> dict:
    """Kernels whose records in the trace fall short of the launches the
    program counted in the window."""
    lost = {}
    for label, (_, _, names) in counted.items():
        seen = sum(n for k, n in trace["records"].items()
                   if any(s in k for s in names))
        if seen != counters.get(label, 0):
            lost[label] = {"records": seen, "launches": counters.get(label)}
    return lost


def busy_seconds(trace: dict, probe, lost: dict) -> float:
    """The device's busy seconds: the trace's, or where it lost records
    the CUDA event pairs around every kernel wrapper the probes time
    (which miss torch operations and copies), over the traced window."""
    if not lost:
        return trace["busy_s"]
    ms = sum(sum(probe.device_ms(label)) for label in probe.pairs)
    return ms / trace["event_window_ms"] * trace["window_s"]
