"""K8's instantiations on the card: each held against the plain version,
and timed by phase from ``clock64()`` stamps.

Run on a card, from the root of this repository:

    python tardis_torch/benchmarks/k8_phases.py [--shells 20 100]
        [--shapes plan workspace 4x16 ...] [--check-only]

Builds ``chip_smoke.py``'s bench problem and its plasma.  For each shell
count, macroatom mode takes each of ``--shapes``: ``plan`` (the
instantiation ``k8_plan`` chooses, the wrapper's), ``workspace`` (the
workspace instantiation, forced: at the bench shape the design K8 began
with), ``CxP`` (the cluster instantiation with clusters of C blocks and a
panel of P); downbranch mode takes its plan.  Each line holds the build
against the plain version (``chip_smoke.compare_chain``: chain rows within
1e-6, emission rows, copied columns, non-decreasing rows; and two calls
bit for bit) and prints the plan (blocks a cluster, panel, blocks, rounds
and their fill).  Unless ``--check-only``, it then times the launch
(``device_ms``, calls queued back to back) and launches once the
instantiation built with ``-DK8_PHASES``, in which thread 0 of every block
adds the cycles of each phase of each system to a device counter
(``csrc/macro_chain.cu`` ``Phases``), and prints the phases' cycles summed
over the blocks, their shares of the blocks' summed time, cycles a system,
and the grid's idle share: one less the blocks' summed time over blocks x
the instrumented launch's time at the card's SM clock (``nvidia-smi``
``clocks.sm``, read after the launch), and the cluster instantiation's
panel steps by part.  The stamps cost a few cycles and a barrier's skew
each; the shares, not the instrumented time, are the reading.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

PHASES = ("p_gather", "levels", "panel_steps", "trailing_update",
          "chain_rows")
# the cluster instantiation's panel steps, by part (counters 7-11), and
# its levels (counters 12-13)
PANEL_PARTS = ("first_barrier", "panel_copy", "second_barrier",
               "row_steps", "pivots")
LEVEL_PARTS = ("block_sums", "warp_pass")


def say(**kw):
    print(json.dumps(kw), flush=True)


def sm_clock_hz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.split()[0]) * 1e6


def parse_shape(text):
    if text == "plan":
        return None
    if text == "workspace":
        return text
    cluster, panel = text.split("x")
    return int(cluster), int(panel)


def main(shells, shapes, check_only):
    root = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                        os.pardir, os.pardir))
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from tardis_torch import cuda
    from tardis_torch.opacities import macro_atom_solver as mas
    from tardis_torch.plasma.solver import PlasmaSolver
    from tardis_torch.transport.tables import NU_UNIT

    torch.set_grad_enabled(False)
    device = torch.device("cuda", 0)
    say(phase="card", card=cs.card_line())
    _, state, atom = cs.build_problem(device)
    ps = PlasmaSolver(atom, state, device).update(state.t_radiative,
                                                  state.dilution_factor)
    rates = tuple(t.to(torch.float64).contiguous() for t in (
        ps.beta_sobolev, ps.j_blues, ps.stimulated_emission_factor))
    phases = ("K8_PHASES",)
    counts = (ctypes.c_uint64 * 16)()
    nu = atom.line_nu / NU_UNIT
    for mode in ("macroatom", "downbranch"):
        macro = atom.macro_atom if mode == "macroatom" else atom.downbranch
        ctx = mas.chain_context(macro, mode, nu)
        arrays = ctx.arrays(device)
        for n in shells:
            r = cs.shells_repeated(rates, n)
            plain = mas.chain_tables(ctx, arrays, mas.p_norm(ctx, arrays,
                                                             *r))
            for text in (shapes if ctx.W else ["plan"]):
                shape = parse_shape(text)

                def call(d=()):
                    return mas.k8_launch(ctx, arrays, *r, defines=d,
                                         shape=shape)

                out = call()
                k, plan = out[:2], out[2]
                line = dict(mode=mode, shells=n, shape=text,
                            plan=plan._asdict(),
                            two_calls_bitwise=cs.chain_bitwise(
                                k, call()[:2]))
                try:
                    line.update(cs.compare_chain(ctx, k, plain,
                                                 f"{mode} {n} {text}"))
                except AssertionError as err:
                    say(phase="k8_check_failed", error=str(err), **line)
                    if not check_only:
                        raise
                    continue
                del k, out
                if check_only:
                    say(phase="k8_check", **line)
                    continue
                ms, _ = cs.cuda_ms_queued(call, 20)
                read = cuda.function("macro_chain", "macro_chain_phases",
                                     [ctypes.c_void_p], phases)
                call(phases)
                cuda.check_launch("macro_chain_phases", read(counts))
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                call(phases)
                b.record()
                torch.cuda.synchronize()
                inst_ms = a.elapsed_time(b)
                clock = sm_clock_hz()
                cuda.check_launch("macro_chain_phases", read(counts))
                c = list(counts)
                parts = dict(zip(PANEL_PARTS, c[7:12]))
                level_parts = dict(zip(LEVEL_PARTS, c[12:14]))
                c[2] += sum(c[7:12])
                c[1] += sum(c[12:14])
                whole, systems = c[5], c[6]
                say(phase="k8_phases", device_ms=ms, instrumented_ms=inst_ms,
                    sm_clock_hz=clock, systems_run=systems,
                    grid_idle_share=1.0 - whole / (
                        plan.blocks * inst_ms * 1e-3 * clock),
                    cycles={p: c[i] for i, p in enumerate(PHASES)},
                    share={p: c[i] / whole for i, p in enumerate(PHASES)},
                    cycles_per_system={p: c[i] / max(systems, 1)
                                       for i, p in enumerate(PHASES)},
                    panel_parts_per_system={
                        k: v / max(systems, 1) for k, v in parts.items()},
                    level_parts_per_system={
                        k: v / max(systems, 1)
                        for k, v in level_parts.items()},
                    other_share=1.0 - sum(c[:5]) / whole, **line)
            del plain
            torch.cuda.empty_cache()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--shells", type=int, nargs="+", default=[20, 100])
    ap.add_argument("--shapes", nargs="+", default=["plan", "workspace"])
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args()
    main(args.shells, args.shapes, args.check_only)
