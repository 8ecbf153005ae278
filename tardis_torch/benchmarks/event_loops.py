"""Device time of every K1 / K7 instantiation that a tree's paths launch, at
``chip_smoke.py``'s bench shape, of K2's three packet pools at the paths'
shapes and of the probe's ``take_1d`` and ``scale2``, for comparing two
commits on one card.

Run on a card, from the root of this repository:

    python tardis_torch/benchmarks/event_loops.py --tree DIR [--build]
        [--only PREFIX ...]

``DIR`` is the root of any checkout of this repository (this one, or a
``git archive`` of an earlier commit); its own ``chip_smoke.py`` and
``tardis_torch`` build the problem, the pools and the kernels, so each tree
is timed as its paths run it.  ``--build`` compiles the instantiations
(one ``nvcc`` each, all at once) and exits; ``--only k7`` keeps the
launches whose label starts so (given more than once, any of them).  Each launch of the main,
relativity and options paths (the convergence iterations' and the final
one's) and of the nonhomologous path (macroatom's, and scatter's at the
convergence shape) prints one JSON line: ``device_ms`` (calls queued back
to back, ``chip_smoke.cuda_ms_queued``), ``ms`` (CUDA events around each
call, ``chip_smoke.cuda_ms``), the events and a hash of every packet's
output row, equal across trees whose per-packet results agree bit for
bit.  A tree without the ``line_estimators`` switch runs every launch with
line estimators.  Each K2 pool at 1,048,576, 2,097,152 and 4,194,304
packets (labels ``k2 <pool> <packets>``) prints, timed by this checkout's
``chip_smoke.k2_timings`` whichever tree is run: its kernels alone
(``kernel_ms``, the profiler's records, with their launches and every
other device record a call), its calls queued behind a hold
(``device_ms``, with ``held``: false when a call synchronised, so the
reading is paced by the host), the host's microseconds a call, and a hash
of mu, nu and w.  The probe's ``take_1d`` (labels ``probe take_1d``: a
12,000,000-entry table, 1,048,576 indices) and ``scale2`` (``probe
scale2``: 120 MB) print their calls queued back to back (``device_ms``,
warm) and, for ``take_1d``, each call after an L2 flush (``cold_ms``,
``chip_smoke.cuda_ms_cold``), with a hash of the output; the inputs come
from one seeded generator, the same for every tree.  K8 (labels ``k8
<mode> <shells>``: macroatom and downbranch at 20 and 100 shells, the bench
plasma's columns repeated; ``k8 wide 4`` and ``k8 large_ion 20``: 600-level
components on seeded rates, 12 and 360 systems) prints its builds queued
back to back (``device_ms``), each build by events (``ms``) and a hash of
each row table.  For a like-for-like
reading run the trees in the order A, B, B, A, one after another on the
same card, and compare each tree with itself first.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import json
import os
import sys

K2_SHAPES = (1_048_576, 2_097_152, 4_194_304)
K2_POOLS = ("simple", "relativistic", "weighted")
PROBE_TABLE, PROBE_INDICES, PROBE_SCALE2_MB = 12_000_000, 1_048_576, 120
K8_SHELLS = (20, 100)  # the bench shape, and chip_smoke.K8_WIDE_SHELLS
# K8 past a cluster's reach: (label, elements, shells) of 600-level atoms
# (level jumps up to 60) on seeded rates: one element's three components
# at 4 shells (12 systems), the large-ion problem at 20 (360)
K8_LARGE = (("k8 wide 4", (8,), 4),
            ("k8 large_ion 20", (8, 12, 14, 16, 18, 20), 20))


def cases(cs):
    """(label, kernel, path or mode, packets, iteration, line estimators,
    records) of every launch the paths make: each convergence iteration
    runs the first iteration's shape and the final one its own."""
    last, opt_last = cs.ITERATIONS - 1, cs.OPTIONS_ITERATIONS - 1
    n, nf = cs.N_PACKETS, cs.FINAL_PACKETS
    return [("k1 main", "k1", "main", n, 0, False, False),
            ("k1 main final", "k1", "main", nf, last, True, True),
            ("k1 relativity", "k1", "relativity", n, 0, False, False),
            ("k1 relativity final", "k1", "relativity", nf, last, True, True),
            ("k1 options", "k1", "options", n, 0, False, False),
            ("k1 options final", "k1", "options", n, opt_last, True, False),
            ("k7 macroatom", "k7", "macroatom", n, 0, False, False),
            ("k7 macroatom final", "k7", "macroatom", nf, last, True, False),
            ("k7 scatter", "k7", "scatter", n, 0, False, False)] + [
                (f"k2 {pool} {m}", "k2", pool, m,
                 last if m == nf else 0, False, False)
                for pool in K2_POOLS for m in K2_SHAPES] + [
                    ("probe take_1d", "probe", "take_1d", PROBE_INDICES, 0,
                     False, False),
                    ("probe scale2", "probe", "scale2", 0, 0, False, False)] + [
                        (f"k8 {mode} {shells}", "k8", mode, shells, 0, False,
                         False)
                        for mode in ("macroatom", "downbranch")
                        for shells in K8_SHELLS] + [
                            (label, "k8", elements, shells, 0, False, False)
                            for label, elements, shells in K8_LARGE]


def this_checkout_smoke():
    """This checkout's ``chip_smoke.py`` (its timing functions), whichever
    tree is timed."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("timing_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    before = set(sys.modules)
    spec.loader.exec_module(mod)
    # it imported this checkout's tardis_torch (its bounds): forget the
    # modules it added, so the timed tree's own package is the one
    # imported next (a package imported before stays)
    for name in set(sys.modules) - before:
        if name == "tardis_torch" or name.startswith("tardis_torch."):
            del sys.modules[name]
    return mod


def say(**kw):
    print(json.dumps(kw), flush=True)


def main(tree, build, only=("",)):
    """Time (or, with ``build``, compile) ``tree``'s launches."""
    timing = this_checkout_smoke()
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from tardis_torch import cuda
    from tardis_torch.opacities.macro_atom_solver import solve_macro_chain
    from tardis_torch.plasma.solver import PlasmaSolver
    from tardis_torch.transport.solver import (
        VPACKET_RECORDS_PER_PACKET,
        iteration_keys,
    )
    from tardis_torch.transport.source import blackbody_source
    from tardis_torch.transport import kernel, nonhomologous
    from tardis_torch.transport.tables import NU_UNIT

    switch = "line_estimators" in inspect.signature(
        kernel.transport_loop).parameters

    def le_kw(line_estimators):
        return {"line_estimators": line_estimators} if switch else {}

    torch.set_grad_enabled(False)
    device = torch.device("cuda", 0)
    say(phase="card", tree=tree, card=cs.card_line(),
        line_estimators_switch=switch)
    chosen = [c for c in cases(cs) if c[0].startswith(tuple(only))]
    if any(c[1] != "probe" for c in chosen):
        config, state, atom = cs.build_problem(device)
        b = cs.beta_inner(state)
    if any(c[1] in ("k1", "k7", "k8") for c in chosen):
        ps = PlasmaSolver(atom, state, device).update(
            state.t_radiative, state.dilution_factor)
        rates = tuple(t.to(torch.float64).contiguous() for t in (
            ps.beta_sobolev, ps.j_blues, ps.stimulated_emission_factor))
    if any(c[1] in ("k1", "k7") for c in chosen):
        chain = solve_macro_chain(
            atom.macro_atom, ps.beta_sobolev, ps.j_blues,
            ps.stimulated_emission_factor, mode="macroatom",
            line_nu_scaled=atom.line_nu / NU_UNIT)
        k1_tables = cs.path_tables(state, atom, ps, chain)
        geom = cs.perturbed_geometry(state.geometry)
        k7_tables = {m: cs.nonhom_tables(state, atom, ps, geom, m)
                     for m in ("scatter", "macroatom")}

    def call(kern, where, n, it, le, records):
        key, run_key = iteration_keys(cs.SEED, it)
        if kern == "probe":
            from tardis_torch.benchmarks import probe2

            gen = torch.Generator(device=device).manual_seed(cs.SEED)
            if where == "take_1d":
                tab = torch.rand(PROBE_TABLE, generator=gen, device=device)
                idx = torch.randint(0, PROBE_TABLE, (n,), generator=gen,
                                    device=device, dtype=torch.int32)
                return (("probe2", ()), lambda: probe2.take_1d(tab, idx))
            x = torch.rand(PROBE_SCALE2_MB * 1024 * 1024 // 4 // probe2.ROW,
                           probe2.ROW, generator=gen, device=device)
            return (("probe2", ()), lambda: probe2.scale2(x))
        if kern == "k8" and isinstance(where, tuple):
            from tardis_torch.atomic.synthetic import make_synthetic_atom_data
            from tardis_torch.opacities import macro_atom_solver as mas

            at = make_synthetic_atom_data(
                n_levels=600, max_level_jump=60).prepare(
                    selected_atoms=list(where),
                    line_interaction_type="macroatom")
            ctx = mas.chain_context(at.macro_atom, "macroatom",
                                    at.line_nu / NU_UNIT)
            arrays = ctx.arrays(device)
            r = timing.k8_random_rates(at.n_lines, n, device)
            return (("macro_chain", ()),
                    lambda: mas.macro_chain(ctx, arrays, *r))
        if kern == "k8":
            from tardis_torch.opacities import macro_atom_solver as mas

            macro = (atom.macro_atom if where == "macroatom"
                     else atom.downbranch)
            ctx = mas.chain_context(macro, where, atom.line_nu / NU_UNIT)
            arrays = ctx.arrays(device)
            r = timing.shells_repeated(rates, n)
            return (("macro_chain", ()),
                    lambda: mas.macro_chain(ctx, arrays, *r))
        if kern == "k2":
            return (("blackbody_source", ()), lambda: blackbody_source(
                key, n, state.t_inner, device, where, b))
        pool = cs.PATHS[where]["pool"] if kern == "k1" else "simple"
        mu, nu, w = blackbody_source(key, n, state.t_inner, device, pool, b)
        if kern == "k7":
            t = k7_tables[where]
            kw = dict(last_interaction=True, **le_kw(le))
            flags = nonhomologous.variant(t, True, 0, **le_kw(le))
            return (("nonhom_loop", nonhomologous.library_defines(flags)),
                    lambda: nonhomologous.nonhom_transport_loop(
                        t, mu, nu, run_key, **kw))
        opts = cs.PATHS[where]
        t = k1_tables[where]
        kw = dict(pool_w=w, last_interaction=opts["last_interaction"],
                  tracker_length=opts["tracker_length"],
                  vpacket_capacity=(VPACKET_RECORDS_PER_PACKET * n
                                    if records else 0), **le_kw(le))
        flags = kernel.variant(t, w, opts["last_interaction"],
                               opts["tracker_length"], **le_kw(le))
        return (("transport_loop", kernel.library_defines(flags)),
                lambda: kernel.transport_loop(t, mu, nu, run_key, **kw))

    calls = [(c[0], *call(*c[1:])) for c in chosen]
    if build:
        s = cuda.build([lib for _, lib, _ in calls])
        say(phase="build", seconds=s, libraries=len({lib for _, lib, _ in
                                                     calls}))
        return
    for label, _, fn in calls:
        if label.startswith("probe "):
            device_ms, out = timing.cuda_ms_queued(fn, 50)
            numbers = {}
            if label == "probe take_1d":
                cold = timing.cuda_ms_cold(fn, timing.COLD_REPS, device)
                numbers = dict(cold_ms=cold[0], cold_ms_spread=cold[1:3])
            say(phase="launch", label=label, n=out.numel(),
                device_ms=device_ms, **numbers,
                out_sha=hashlib.sha256(
                    out.cpu().numpy().tobytes()).hexdigest()[:16])
            continue
        if label.startswith("k8 "):
            device_ms, out = timing.cuda_ms_queued(fn, 20)
            ms, out = timing.cuda_ms(fn, 10)
            say(phase="launch", label=label, device_ms=device_ms, ms=ms,
                **{f"{name}_sha": hashlib.sha256(
                    t.cpu().numpy().tobytes()).hexdigest()[:16]
                   for name, t in zip(("chain", "emit"), out)
                   if t is not None})
            del out
            torch.cuda.empty_cache()
            continue
        if label.startswith("k2 "):
            numbers = timing.k2_timings(fn)
            ms, out = cs.cuda_ms(fn, 10)
            say(phase="launch", label=label, n=out[0].shape[0], ms=ms,
                **numbers, out_sha=hashlib.sha256(b"".join(
                    t.cpu().numpy().tobytes() for t in out
                    if t is not None)).hexdigest()[:16])
            continue
        device_ms, res = cs.cuda_ms_queued(fn, 5)
        ms, res = cs.cuda_ms(fn, 5)
        events = res.summary[2].item()
        say(phase="launch", label=label, n=res.out.shape[0],
            line_diff=res.line_diff.numel() > 0, device_ms=device_ms, ms=ms,
            events=events, events_per_s=events / (device_ms * 1e-3),
            out_sha=hashlib.sha256(
                res.out.cpu().numpy().tobytes()).hexdigest()[:16])
        del res
        torch.cuda.empty_cache()

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--build", action="store_true")
    ap.add_argument("--only", action="append", default=[])
    args = ap.parse_args()
    main(os.path.abspath(args.tree), args.build, args.only or [""])
