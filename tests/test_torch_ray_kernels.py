"""What the card's ray kernels K4 and K5 rely on, held on the CPU.

K4 (``csrc/vpacket_volley.cu``) finds a segment's line through a bucketed
index of the line list and a ray's bin by a direct index checked against the
edges; ``bucket_search`` and ``direct_bin`` are those searches in torch,
built from the same ``bucket_table`` that the wrapper passes to the card,
and both must return ``searchsorted``'s index.  K5 (``csrc/formal_integral.cu``)
computes each shell's run of line events 32 at a time and walks the serial
recurrence over them; ``integrate_ray_chunked`` is that schedule in torch,
whose events and intensity-free terms must be those of one event at a time
and whose I p must be ``integrate_rays_plain``'s bit for bit.  Every
problem comes from the synthetic atom data.
"""

import numpy as np
import pytest
import torch

from tardis_torch.atomic.synthetic import make_synthetic_atom_data
from tardis_torch.config.reader import config_from_dict
from tardis_torch.constants import C
from tardis_torch.model.state import SimulationState
from tardis_torch.plasma.lte import intensity_black_body
from tardis_torch.plasma.solver import PlasmaSolver
from tardis_torch.spectrum.base import frequency_grid
from tardis_torch.spectrum.formal_integral import (
    COUNT_BOUNDARY,
    COUNT_LINE,
    integrate_ray_chunked,
    integrate_rays_plain,
)
from tardis_torch.transport.tables import NU_UNIT
from tardis_torch.transport.vpacket import (
    BUCKET_ENTRIES,
    bucket_search,
    bucket_table,
    direct_bin,
)

from tests.test_plasma import BASE_CONFIG

torch.set_num_threads(2)

SEED = 17


@pytest.fixture(scope="module")
def atom():
    return make_synthetic_atom_data().prepare(
        selected_atoms=[8, 12, 14, 16, 18, 20],
        line_interaction_type="macroatom")


def line_list(atom):
    """The synthetic atom's line list in kernel units (f32, descending)
    with every seventh frequency repeated, so that equal frequencies sit
    next to each other."""
    nu = np.asarray(atom.line_nu / NU_UNIT, np.float32)
    nu = np.sort(np.concatenate([nu, nu[::7]]))[::-1].copy()
    return torch.as_tensor(nu)


def probes(line_nu, table):
    """Thresholds that test every bracket: each line's frequency, its f32
    neighbours above and below, midpoints, values above and below the
    whole list (zero, a negative, inf, NaN among them), and the first and
    last f32 of every bucket of the table."""
    g = np.random.default_rng(SEED)
    nu = line_nu.numpy()
    pick = nu[g.integers(0, len(nu), 150)]
    mids = 0.5 * (nu[1:] + nu[:-1])[g.integers(0, len(nu) - 1, 100)]
    edge = np.array([nu[0] * 2, nu[0], nu[-1], nu[-1] * 0.5, 0.0, -1.0,
                     np.inf, np.nan], np.float32)
    keys = table.base + 1 + np.arange(table.n_buckets - 1)
    keys = keys[g.integers(0, len(keys), 100)].astype(np.int64)
    first = (keys << table.shift).astype(np.int32).view(np.float32)
    last = ((keys + 1 << table.shift) - 1).astype(np.int32).view(np.float32)
    x = np.concatenate([pick, np.nextafter(pick, np.float32(np.inf)),
                        np.nextafter(pick, np.float32(0)), mids, edge, first,
                        last]).astype(np.float32)
    return torch.as_tensor(x)


@pytest.mark.parametrize("max_entries", [BUCKET_ENTRIES, 256, 16])
def test_bucket_search_is_searchsorted(atom, max_entries):
    """K4's segment search through the bucket table returns
    max(searchsorted(-line_nu, -x), i_cur) for every i_cur from 0 to L and
    every probe, at the table the wrapper builds (at most BUCKET_ENTRIES
    entries) and at coarser ones, where a bucket holds hundreds of lines."""
    line_nu = line_list(atom)
    L = line_nu.shape[0]
    table = bucket_table(line_nu, max_entries)
    assert table.n_buckets <= max_entries
    assert int(table.counts[0]) == 0 and int(table.counts[-1]) == L
    assert bool((table.counts[1:] >= table.counts[:-1]).all())
    x = probes(line_nu, table)
    i_cur = torch.arange(L + 1)
    xx = x[:, None].expand(-1, L + 1).reshape(-1)
    ii = i_cur[None, :].expand(x.shape[0], -1).reshape(-1)
    want = torch.maximum(torch.searchsorted(-line_nu, -xx), ii)
    assert torch.equal(bucket_search(table, line_nu, xx, ii), want)
    if max_entries == BUCKET_ENTRIES:
        # the default table brackets a handful of lines a bucket
        per_bucket = torch.diff(table.counts).float()
        assert float(per_bucket.mean()) < 8


def test_bucket_table_of_the_bench_span():
    """The wrapper's table over a line list spanning 500-20,000 A at the
    bench problem's 183,060 lines fits its 32 KB of shared memory."""
    lam = np.geomspace(500e-8, 20000e-8, 183_060)
    nu = np.sort((C / lam / NU_UNIT).astype(np.float32))[::-1].copy()
    table = bucket_table(torch.as_tensor(nu))
    assert table.n_buckets <= BUCKET_ENTRIES
    assert table.n_buckets * 4 <= 32 * 1024


@pytest.mark.parametrize("grid", ["uniform", "stretched"])
def test_direct_bin_is_searchsorted(grid):
    """K4's bin, a direct index on the grid moved down then up against the
    edges, equals searchsorted(edges, nu, right) - 1 for every frequency
    inside [edges[0], edges[M]): on the spectrum's uniform grid (the
    config's 10,000 bins) and on a stretched one, with frequencies on
    every edge, next to it and between."""
    spec = config_from_dict(BASE_CONFIG).spectrum
    edges = (frequency_grid(spec.start, spec.stop, 10_000)
             / NU_UNIT).astype(np.float32)
    if grid == "stretched":
        edges = (edges[0] + (edges - edges[0]) ** 2
                 / (edges[-1] - edges[0])).astype(np.float32)
    g = np.random.default_rng(SEED)
    nu = np.concatenate([edges[:-1], np.nextafter(edges[1:], np.float32(0)),
                         np.nextafter(edges[:-1], np.float32(np.inf)),
                         g.uniform(edges[0], edges[-1], 20_000)])
    nu = nu[(nu >= edges[0]) & (nu < edges[-1])].astype(np.float32)
    e, x = torch.as_tensor(edges), torch.as_tensor(nu)
    want = torch.clamp(torch.searchsorted(e, x, right=True) - 1, 0,
                       len(edges) - 2)
    assert torch.equal(direct_bin(e, x), want)


F, P = 24, 12


@pytest.fixture(scope="module")
def rays(atom):
    """K5's inputs on the synthetic atom: the slice geometry, its LTE
    plasma's tau, source-function tables from a numpy seed, 24
    frequencies x 12 impact parameters."""
    state = SimulationState.from_config(config_from_dict(BASE_CONFIG))
    ps = PlasmaSolver(atom, state, "cpu").update(state.t_radiative,
                                                 state.dilution_factor)
    geometry = state.geometry
    ct = C * state.time_explosion
    S, L = state.no_of_shells, atom.n_lines
    g = np.random.default_rng(SEED)
    nu_grid = np.linspace(C / 20000e-8, C / 500e-8, F)
    i_bb = intensity_black_body(nu_grid, 10000.0)
    scale = float(i_bb.max())
    p_grid = np.linspace(0.0, geometry.r_outer[-1], P + 1)[1:]

    def f32(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32))

    j_blue = g.uniform(0.1, 1.0, (S, L)) * scale
    tau = ps.tau_sobolev.double().numpy()
    return dict(
        nu_grid=f32(nu_grid / NU_UNIT), p_grid=f32(p_grid / ct),
        r_inner=f32(geometry.r_inner / ct), r_outer=f32(geometry.r_outer / ct),
        chi_e=f32(6.6524587321e-25 * np.asarray(ps.electron_densities) * ct),
        line_nu=f32(atom.line_nu / NU_UNIT), exp_tau=f32(np.exp(-tau).T),
        att_S=f32(g.uniform(0.0, 0.5, (S, L)) * scale),
        j_red=f32(j_blue * g.uniform(0.5, 1.0, (S, L))), j_blue=f32(j_blue),
        i_inner=f32(i_bb))


def test_chunked_rays_are_the_plain_rays(rays):
    """Every ray through K5's schedule (4 lines a chunk, the card's group
    of lanes a ray) gives integrate_rays_plain's I p bit for bit, with its
    line and boundary events; on every fifth ray, chunks of 4, of 32 and of
    one line (one event at a time, the plain loop's sequence) meet the same
    events with the same intensity-free terms (shell, line,
    electron-scattering weight, mean J, e^-tau, source) and give the same
    I p; and some shell runs span several chunks of 4."""
    plain = integrate_rays_plain(**rays)
    n_line = n_boundary = longest_run = 0
    for f in range(F):
        for k in range(P):
            i_p, lines, bounds, terms = integrate_ray_chunked(**rays, f=f,
                                                              k=k)
            assert torch.equal(i_p, plain.i_p[f, k]), (f, k)
            assert lines + bounds == int(plain.events[f, k]), (f, k)
            n_line += lines
            n_boundary += bounds
            if (f * P + k) % 5:
                continue
            for width in (32, 1):
                other = integrate_ray_chunked(**rays, f=f, k=k, width=width)
                assert torch.equal(other[0], i_p)
                assert len(other[3]) == len(terms)
                for a, b in zip(other[3], terms):
                    assert a[:2] == b[:2]
                    assert all(torch.equal(u, v) for u, v in zip(a[2:],
                                                                 b[2:]))
            shells = [t[0] for t in terms]
            run = 0
            for a, b in zip([None] + shells, shells):
                run = run + 1 if a == b else 1
                longest_run = max(longest_run, run)
    assert n_line == int(plain.counts[COUNT_LINE])
    assert n_boundary == int(plain.counts[COUNT_BOUNDARY])
    assert longest_run > 4
