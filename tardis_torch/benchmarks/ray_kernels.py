"""Device time of the ray kernels, K4 (vpacket volley, both instantiations)
and K5 (formal-integral rays), at ``chip_smoke.py``'s shapes, for comparing
two commits on one card.

Run on a card, from the root of this repository:

    python tardis_torch/benchmarks/ray_kernels.py --tree DIR [--build]

``DIR`` is the root of any checkout of this repository (this one, or a
``git archive`` of an earlier commit); its own ``chip_smoke.py`` and
``tardis_torch`` build the problem, K1's spawn records and the kernels, so
each tree is timed as its paths run it.  ``--build`` compiles the
libraries (one ``nvcc`` each, all at once) and exits.

K4 runs on the final iteration's spawn records of the main and relativity
paths (4,194,304 packets, 8 records a packet, 2 virtual packets a record,
10,000 bins).  K5 runs on the bench problem's geometry and lines at the
main path's 1,000 frequencies x 80 impact parameters, with source-function
tables drawn from a numpy seed (a ray's events follow from the geometry
and the lines alone, so it meets the main path's events; the values
change only the arithmetic's operands).  Each case prints one JSON line:
``device_ms`` (calls queued back to back, ``chip_smoke.cuda_ms_queued``),
``ms`` (CUDA events around each call, ``chip_smoke.cuda_ms``), the work
(segments, or line and boundary events) and a hash of every ray's output
(K4: its record, direction, frequency and energy, the rows in a canonical
order, as K1 writes its records in a racing order; K5: I p), equal across
trees whose rays agree bit for bit.  K5's line also times its longest ray alone (``floor_ms``),
the ray whose events a geometric count puts first.  For a like-for-like
reading run the trees in the order A, B, B, A, one after another on the
same card, and compare each tree with itself first.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

RAY_SEED = 5


def say(**kw):
    print(json.dumps(kw), flush=True)


def digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def ray_events(a):
    """Each ray's events as the geometry counts them: in each shell it
    crosses, the lines with nu_line >= nu (1 - z_bound) from its current
    line on, then the boundary (torch ops; picks the longest ray)."""
    import torch

    nu_grid, p_grid = a["nu_grid"], a["p_grid"]
    r_inner, r_outer, line_nu = a["r_inner"], a["r_outer"], a["line_nu"]
    F, P, S = nu_grid.shape[0], p_grid.shape[0], r_inner.shape[0]

    def zb(r, p2):
        return torch.sqrt(torch.clamp(r * r - p2, min=0.0))

    nu = nu_grid.repeat_interleave(P)
    p2 = p_grid.repeat(F) ** 2
    photosphere = p2 < r_inner[0] ** 2
    z = torch.where(photosphere, zb(r_inner[0], p2), -zb(r_outer[-1], p2))
    shell = torch.where(photosphere, 0, S - 1)
    line = torch.searchsorted(-line_nu, -(nu * (1.0 - z)), right=True)
    active = p2 < r_outer[-1] ** 2
    events = torch.zeros_like(line)
    for _ in range(2 * S + 2):
        sc = torch.clamp(shell, 0, S - 1)
        r_in = r_inner[sc]
        inward = (z < 0.0) & (p2 < r_in * r_in)
        z_bound = torch.where(inward, -zb(r_in, p2), zb(r_outer[sc], p2))
        nxt = torch.maximum(line, torch.searchsorted(
            -line_nu, -(nu * (1.0 - z_bound)), right=True))
        events += torch.where(active, nxt - line + 1, 0)
        line, z = nxt, z_bound
        shell = torch.where(inward, shell - 1, shell + 1)
        active = active & (shell >= 0) & (shell < S)
    return events.reshape(F, P)


def main(tree, build):
    """Time (or, with ``build``, compile) ``tree``'s ray kernels."""
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from tardis_torch import cuda
    from tardis_torch.config.reader import config_from_dict
    from tardis_torch.constants import C, SIGMA_THOMSON
    from tardis_torch.opacities.macro_atom_solver import solve_macro_chain
    from tardis_torch.plasma.lte import intensity_black_body
    from tardis_torch.plasma.solver import PlasmaSolver
    from tardis_torch.spectrum.base import frequency_grid
    from tardis_torch.spectrum.formal_integral import integrate_rays
    from tardis_torch.transport import kernel, vpacket
    from tardis_torch.transport.solver import (
        VPACKET_RECORDS_PER_PACKET,
        iteration_keys,
    )
    from tardis_torch.transport.source import blackbody_source
    from tardis_torch.transport.tables import NU_UNIT

    torch.set_grad_enabled(False)
    device = torch.device("cuda", 0)
    say(phase="card", tree=tree, card=cs.card_line())
    config, state, atom = cs.build_problem(device)
    ps = PlasmaSolver(atom, state, device).update(state.t_radiative,
                                                  state.dilution_factor)
    chain = solve_macro_chain(atom.macro_atom, ps.beta_sobolev, ps.j_blues,
                              ps.stimulated_emission_factor, mode="macroatom",
                              line_nu_scaled=atom.line_nu / NU_UNIT)
    tables = cs.path_tables(state, atom, ps, chain)
    libs = [("formal_integral", ())] + [
        ("vpacket_volley", vpacket.library_defines(tables[where]))
        for where in ("main", "relativity")]
    if build:
        s = cuda.build(libs)
        say(phase="build", seconds=s, libraries=len(libs))
        return

    spec = config_from_dict(cs.BENCH_CONFIG).spectrum
    nu_edges = frequency_grid(spec.start, spec.stop, spec.num)
    edges = torch.as_tensor((nu_edges / NU_UNIT).astype(np.float32),
                            device=device)
    b = cs.beta_inner(state)
    n = cs.FINAL_PACKETS
    for where in ("main", "relativity"):
        opts, t = cs.PATHS[where], tables[where]
        key, run_key = iteration_keys(cs.SEED, cs.ITERATIONS - 1)
        mu, nu, w = blackbody_source(key, n, state.t_inner, device,
                                     opts["pool"], b)
        res = kernel.transport_loop(
            t, mu, nu, run_key, pool_w=w,
            last_interaction=opts["last_interaction"],
            tracker_length=opts["tracker_length"],
            vpacket_capacity=VPACKET_RECORDS_PER_PACKET * n)
        records = res.vp_records[:res.n_vp_records].clone()
        del res, mu, nu, w
        torch.cuda.empty_cache()

        def volley(return_packets=False):
            return vpacket.trace_vpacket_records(
                t, records, cs.N_VPACKETS, edges,
                return_packets=return_packets)

        device_ms, _ = cs.cuda_ms_queued(volley, 5)
        ms, _ = cs.cuda_ms(volley, 5)
        out = volley(return_packets=True)
        segments = int(out.n_segments[0])
        # K1 writes its records in a racing order: each ray's record, its
        # direction index and its outputs, rows in a canonical order
        V = cs.N_VPACKETS
        rays = torch.cat([records.repeat_interleave(V, 0),
                          torch.arange(V, device=device).repeat(
                              records.shape[0])[:, None].float(),
                          out.nu[:, None], out.energy[:, None]], dim=1)
        say(phase="k4", label=f"k4 {where}", records=records.shape[0],
            rays=records.shape[0] * V, segments=segments,
            device_ms=device_ms, ms=ms,
            segments_per_s=segments / (device_ms * 1e-3),
            rays_sha=digest(cs.sorted_rows(rays)))
        del rays
        del records, out
        torch.cuda.empty_cache()

    # K5 at the main path's ray grid, tables from a numpy seed
    geometry = state.geometry
    ct = C * state.time_explosion
    S, L = state.no_of_shells, atom.n_lines
    nu_grid = np.linspace(nu_edges[0], nu_edges[-1], cs.INTEGRATED_POINTS)
    p_grid = np.linspace(0.0, geometry.r_outer[-1], 80 + 1)[1:]
    i_bb = intensity_black_body(nu_grid, float(state.t_inner))
    g = np.random.default_rng(RAY_SEED)
    scale = float(i_bb.max())
    j_blue = g.uniform(0.1, 1.0, (S, L)) * scale

    def f32(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=device)

    tau = ps.tau_sobolev.double().cpu().numpy()
    a = dict(nu_grid=f32(nu_grid / NU_UNIT), p_grid=f32(p_grid / ct),
             r_inner=f32(geometry.r_inner / ct),
             r_outer=f32(geometry.r_outer / ct),
             chi_e=f32(SIGMA_THOMSON * np.asarray(ps.electron_densities)
                       * ct),
             line_nu=f32(atom.line_nu / NU_UNIT),
             exp_tau=f32(np.exp(-tau).T),
             att_S=f32(g.uniform(0.0, 0.5, (S, L)) * scale),
             j_red=f32(j_blue * g.uniform(0.5, 1.0, (S, L))),
             j_blue=f32(j_blue), i_inner=f32(i_bb))
    device_ms, out = cs.cuda_ms_queued(lambda: integrate_rays(**a), 5)
    ms, out = cs.cuda_ms(lambda: integrate_rays(**a), 5)
    counts = out.counts.tolist()
    f, k = divmod(int(torch.argmax(ray_events(a))), len(p_grid))
    one = dict(a, nu_grid=a["nu_grid"][f:f + 1], p_grid=a["p_grid"][k:k + 1],
               i_inner=a["i_inner"][f:f + 1])
    floor_ms, alone = cs.cuda_ms_queued(lambda: integrate_rays(**one), 20)
    say(phase="k5", label="k5 main", rays=int(out.i_p.numel()),
        line_events=counts[0], boundary_events=counts[1], capped=counts[2],
        device_ms=device_ms, ms=ms,
        events_per_s=(counts[0] + counts[1]) / (device_ms * 1e-3),
        longest_ray=dict(frequency=f, impact_parameter=k,
                         events=sum(alone.counts.tolist()[:2]),
                         same_as_full=bool(torch.equal(alone.i_p[0, 0],
                                                       out.i_p[f, k]))),
        floor_ms=floor_ms, i_p_sha=digest(out.i_p))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--build", action="store_true")
    args = ap.parse_args()
    main(os.path.abspath(args.tree), args.build)
