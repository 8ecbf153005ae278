"""Device time of every K1 / K7 instantiation that a tree's paths launch, at
``chip_smoke.py``'s bench shape, for comparing two commits on one card.

Run on a card, from the root of this repository:

    python tardis_torch/benchmarks/event_loops.py --tree DIR [--build]
        [--only PREFIX]

``DIR`` is the root of any checkout of this repository (this one, or a
``git archive`` of an earlier commit); its own ``chip_smoke.py`` and
``tardis_torch`` build the problem, the pools and the kernels, so each tree
is timed as its paths run it.  ``--build`` compiles the instantiations
(one ``nvcc`` each, all at once) and exits; ``--only k7`` keeps the
launches whose label starts so.  Each launch of the main,
relativity and options paths (the convergence iterations' and the final
one's) and of the nonhomologous path (macroatom's, and scatter's at the
convergence shape) prints one JSON line: ``device_ms`` (calls queued back
to back, ``chip_smoke.cuda_ms_queued``), ``ms`` (CUDA events around each
call, ``chip_smoke.cuda_ms``), the events and a hash of every packet's
output row, equal across trees whose per-packet results agree bit for
bit.  A tree without the ``line_estimators`` switch runs every launch with
line estimators.  For a like-for-like reading run the trees in the order
A, B, B, A, one after another on the same card, and compare each tree
with itself first.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import sys


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
            ("k7 scatter", "k7", "scatter", n, 0, False, False)]


def say(**kw):
    print(json.dumps(kw), flush=True)


def main(tree, build, only=""):
    """Time (or, with ``build``, compile) ``tree``'s launches."""
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
    config, state, atom = cs.build_problem(device)
    ps = PlasmaSolver(atom, state, device).update(state.t_radiative,
                                                  state.dilution_factor)
    chain = solve_macro_chain(atom.macro_atom, ps.beta_sobolev, ps.j_blues,
                              ps.stimulated_emission_factor, mode="macroatom",
                              line_nu_scaled=atom.line_nu / NU_UNIT)
    k1_tables = cs.path_tables(state, atom, ps, chain)
    geom = cs.perturbed_geometry(state.geometry)
    k7_tables = {m: cs.nonhom_tables(state, atom, ps, geom, m)
                 for m in ("scatter", "macroatom")}
    b = cs.beta_inner(state)

    def call(kern, where, n, it, le, records):
        pool = cs.PATHS[where]["pool"] if kern == "k1" else "simple"
        key, run_key = iteration_keys(cs.SEED, it)
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

    calls = [(c[0], *call(*c[1:])) for c in cases(cs)
             if c[0].startswith(only)]
    if build:
        s = cuda.build([lib for _, lib, _ in calls])
        say(phase="build", seconds=s, libraries=len({lib for _, lib, _ in
                                                     calls}))
        return
    for label, _, fn in calls:
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
    ap.add_argument("--only", default="")
    args = ap.parse_args()
    main(os.path.abspath(args.tree), args.build, args.only)
