"""Virtual-packet volley (kernel K4, ``csrc/vpacket_volley.cu``).

Counterpart of ``tardis_tpu/transport/vpacket.py`` (``trace_vpacket_records``,
``_trace_vpacket_records_chunk``, ``_trace_tau``).  K1 writes one spawn
record per packet birth and interaction; each record sends ``n_vpackets``
virtual packets towards the observer:

- stratified directions mu_v = mu_min + (v + 1/2) / V (1 - mu_min) with the
  Kerzendorf & Sim (2014) weights (2 mu_v / V on the inner boundary,
  (1 - mu_min) / (2 V) elsewhere), mu_min the photosphere's limb;
- the lab frequency and energy Doppler-shifted to the new direction;
- the optical depth to the outer edge, shell segment by shell segment: the
  line part is the prefix difference P[s, i_exit] - P[s, i_enter] (one
  binary search of the line list per segment, in f64), the electron part
  chi_e * dz; a ray stops after 2S + 2 segments, at the inner or outer edge,
  or once tau >= 70;
- under full relativity (``tables.full_relativity``, ``vpacket.py:96-111,
  260-287``): mu_min aberrated into the comoving frame and the directions
  stratified there, the inner-boundary weight 2 (mu + beta) / ((2 beta + 1)
  V), each direction aberrated back to the lab frame, gamma(r) in both
  Doppler factors, the segment's line threshold nu (1 - z_next)
  gamma(r_next) and chi_e (1 - z) gamma(r_here);
- the energy e^-tau (zero for a record of zero energy or outside the spawn
  range) added to the spectrum bin of the ray's frequency, in f64.

Rays are laid out record-major: ray ``k`` belongs to record ``k // V`` and
direction ``k % V``.  ``trace_vpacket_records`` launches K4 once over every
ray for tensors on the card and runs ``trace_vpacket_records_plain`` (a
lockstep loop over segments, as the JAX ``while_loop`` steps) only for CPU
tensors.  The plain version cuts the records into chunks of at most
``max_rays_per_chunk`` rays, which bounds the memory of its lockstep
temporaries, and adds every chunk into one histogram.

On the card a segment's line search reads a bucketed index of the line list
(``bucket_table``, built once for the tables and kept on them): the count
of lines whose f32 bit pattern, shifted right, is at or below each bucket
key.  The bucket of the threshold brackets the search; ``bucket_search`` is
the card's search in torch, held against ``searchsorted`` by the CPU tests.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from tardis_torch import cuda
from tardis_torch.transport.tables import TransportTables, lorentz_gamma

TAU_STOP = 70.0
ON_INNER_REL = 1.0 + 1e-6  # a record within this factor of r_inner[0] is on it


@dataclass
class VolleyOutput:
    hist: torch.Tensor  # (M,) f64 attenuated energy per bin, packet units
    n_segments: torch.Tensor  # (1,) i64 shell segments traced
    nu: torch.Tensor | None = None  # (R*V,) f32 ray lab nu (return_packets)
    energy: torch.Tensor | None = None  # (R*V,) f32 attenuated energy
    # (R*V,) i32 each ray's segments (the plain version's return_packets)
    segments: torch.Tensor | None = None


def _spawn_range(spawn_nu_range):
    lo, hi = spawn_nu_range
    return float(np.float32(lo)), float(np.float32(hi))


def _volley_plain(t: TransportTables, rec, V, edges, lo, hi, hist, n_seg):
    """One chunk of records -> (ray nu, ray attenuated energy, ray
    segments), (R*V,)."""
    device = rec.device
    f32 = torch.float32
    S, L = t.n_shells, t.n_lines
    full_rel = t.full_relativity
    r0, mu0, nu0, e0 = rec[:, 0], rec[:, 1], rec[:, 2], rec[:, 3]
    beta_inner = t.r_inner[0]
    valid = (e0 > 0.0) & (nu0 >= lo) & (nu0 <= hi)
    # tensor divisors: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which can differ from K4 by an ulp
    v_t = torch.tensor(V, dtype=f32, device=device)
    frac = (torch.arange(V, dtype=f32, device=device) + 0.5) / v_t
    on_inner = r0 <= beta_inner * ON_INNER_REL
    r_ratio = torch.clamp(beta_inner / torch.maximum(r0, beta_inner), 0.0, 1.0)
    mu_min = torch.where(
        on_inner, 0.0,
        -torch.sqrt(torch.clamp(1.0 - r_ratio * r_ratio, min=0.0)))
    if full_rel:
        # the limb aberrated into the comoving frame, where the directions
        # are stratified (0 on the inner boundary)
        mu_min = torch.where(on_inner, 0.0,
                             (mu_min - r0) / (1.0 - r0 * mu_min))
    mu_vp = mu_min[:, None] + frac[None, :] * (1.0 - mu_min)[:, None]
    if full_rel:
        weight = torch.where(
            on_inner[:, None],
            (2.0 * (mu_vp + beta_inner)) / ((2.0 * beta_inner + 1.0) * v_t),
            ((1.0 - mu_min) / (2.0 * v_t))[:, None])
        # comoving -> lab frame
        mu_vp = (mu_vp + r0[:, None]) / (1.0 + r0[:, None] * mu_vp)
        gamma_r = lorentz_gamma(r0)[:, None]
        ratio = (((1.0 - mu0 * r0)[:, None] * gamma_r)
                 / ((1.0 - mu_vp * r0[:, None]) * gamma_r))
    else:
        weight = torch.where(on_inner[:, None], (2.0 * mu_vp) / v_t,
                             ((1.0 - mu_min) / (2.0 * v_t))[:, None])
        ratio = (1.0 - mu0 * r0)[:, None] / (1.0 - mu_vp * r0[:, None])
    nu_vp = (nu0[:, None] * ratio).reshape(-1)
    e_vp = ((e0[:, None] * weight) * ratio).reshape(-1)

    # tau to the outer edge, all rays in lockstep over shell segments
    r = r0.repeat_interleave(V)
    mu = mu_vp.reshape(-1)
    shell = rec[:, 4].long().repeat_interleave(V)
    i_cur = rec[:, 5].long().repeat_interleave(V)
    p2 = torch.clamp((r * r) * (1.0 - mu * mu), min=0.0)
    z = mu * r
    tau = torch.zeros_like(z)
    segs = torch.zeros(z.shape, dtype=torch.int32, device=device)
    neg_line_nu = -t.line_nu
    pflat = t.prefix.reshape(-1)
    for _ in range(2 * S + 2):
        active = (shell >= 0) & (shell < S) & (tau < TAU_STOP)
        n_active = active.sum()
        if not bool(n_active):
            break
        n_seg += n_active
        segs += active.int()
        sc = torch.clamp(shell, 0, S - 1)
        r_in = t.r_inner[sc]
        r_out = t.r_outer[sc]
        reaches_inner = (z < 0.0) & (p2 < r_in * r_in)
        z_next = torch.where(
            reaches_inner, -torch.sqrt(torch.clamp(r_in * r_in - p2, min=0.0)),
            torch.sqrt(torch.clamp(r_out * r_out - p2, min=0.0)))
        nu_cmf_next = nu_vp * (1.0 - z_next)
        if full_rel:
            nu_cmf_next = nu_cmf_next * lorentz_gamma(
                torch.where(reaches_inner, r_in, r_out))
        # lines with nu_line > nu_cmf at the segment's end are crossed
        i_next = torch.maximum(
            torch.searchsorted(neg_line_nu, -nu_cmf_next), i_cur)
        row = sc * (L + 1)
        d_line = (pflat[row + i_next] - pflat[row + i_cur]).float()
        chi_e = t.chi_e[sc]
        if full_rel:
            chi_e = (chi_e * (1.0 - z)) * lorentz_gamma(torch.sqrt(p2 + z * z))
        d_tau = d_line + chi_e * torch.clamp(z_next - z, min=0.0)
        tau = torch.where(active, tau + d_tau, tau)
        z = torch.where(active, z_next, z)
        i_cur = torch.where(active, i_next, i_cur)
        shell = torch.where(active, torch.where(reaches_inner, shell - 1,
                                                shell + 1), shell)

    # f64 exp rounded to f32, as K4 takes it
    e_out = torch.where(valid.repeat_interleave(V),
                        e_vp * torch.exp(-tau.double()).float(), 0.0)
    M = edges.shape[0] - 1
    bins = torch.clamp(torch.searchsorted(edges, nu_vp, right=True) - 1,
                       0, M - 1)
    in_range = (nu_vp >= edges[0]) & (nu_vp < edges[M])
    e_out = torch.where(in_range, e_out, 0.0)
    hist.index_add_(0, bins, e_out.double())
    return nu_vp, e_out, segs


# the bucketed line index stays in the L1: at most this many int32 entries
# (32 KB)
BUCKET_ENTRIES = 8192


@dataclass
class BucketTable:
    """Counts of a sorted array's entries by bucket of their f32 bit
    pattern: ``counts[t]`` entries have key (bits >> ``shift``) at or below
    ``base + t``; ``counts[0]`` is 0 and ``counts[-1]`` every entry."""

    counts: torch.Tensor  # (n_buckets,) i32
    base: int
    shift: int

    @property
    def n_buckets(self) -> int:
        return self.counts.shape[0]


def _keys(values, shift):
    return values.contiguous().view(torch.int32) >> shift


def bucket_table(values, max_entries: int = BUCKET_ENTRIES) -> BucketTable:
    """The bucket table of ``values`` (f32, positive, sorted either way) at
    the smallest shift whose table has at most ``max_entries`` entries
    (torch ops; reads the key range back once)."""
    bits = values.contiguous().view(torch.int32)
    k_min, k_max = (int(v) for v in torch.aminmax(bits))
    shift = next(s for s in range(32)
                 if (k_max >> s) - (k_min >> s) + 2 <= max_entries)
    keys = torch.sort(_keys(values, shift)).values
    base = (k_min >> shift) - 1
    probe = base + torch.arange((k_max >> shift) - base + 1,
                                device=values.device, dtype=torch.int32)
    counts = torch.searchsorted(keys, probe, right=True).to(torch.int32)
    return BucketTable(counts=counts, base=base, shift=shift)


def line_buckets(t: TransportTables) -> BucketTable:
    """The line list's bucket table, built once for ``t`` and kept there."""
    table = t.__dict__.get("_line_buckets")
    if table is None:
        table = bucket_table(t.line_nu)
        t.__dict__["_line_buckets"] = table
    return table


def bucket_search(table: BucketTable, line_nu, x, i_cur):
    """K4's search in torch: the first line at or after ``i_cur`` with
    line_nu <= x (line_nu descending), bisecting only the bracket that the
    bucket of x's key gives, [L - counts[j], L - counts[j - 1]] from
    ``i_cur`` on (j = key(x) - base, clamped into the table; a NaN counts
    every line above it, as searchsorted sorts NaN last).  Equal to
    max(searchsorted(-line_nu, -x), i_cur)."""
    L = line_nu.shape[0]
    nb = table.n_buckets - 1
    j = _keys(x, table.shift) - table.base
    j = torch.where(torch.isnan(x), -1, j).long()
    lo = L - table.counts[torch.clamp(j, 0, nb)].long()
    hi = L - table.counts[torch.clamp(j - 1, 0, nb)].long()
    lo, hi = torch.maximum(lo, i_cur), torch.maximum(hi, i_cur)
    while bool((lo < hi).any()):
        active = lo < hi
        mid = (lo + hi) >> 1
        above = line_nu[torch.clamp(mid, max=L - 1)] > x
        lo = torch.where(active & above, mid + 1, lo)
        hi = torch.where(active & ~above, mid, hi)
    return lo


def direct_bin(edges, nu):
    """K4's bin in torch: a direct index on a uniform grid, moved down then
    up until edges[bin] <= nu < edges[bin + 1]; searchsorted(edges, nu,
    right) - 1 for any ascending edges wherever edges[0] <= nu <
    edges[-1] (the only rays that K4 bins)."""
    M = edges.shape[0] - 1
    inv_width = torch.tensor(float(M), dtype=torch.float32,
                             device=edges.device) / (edges[M] - edges[0])
    b = torch.clamp(((nu - edges[0]) * inv_width).long(), 0, M - 1)
    while True:
        down = (b > 0) & (edges[b] > nu)
        if not bool(down.any()):
            break
        b = b - down.long()
    while True:
        up = (b < M - 1) & (edges[torch.clamp(b + 1, max=M)] <= nu)
        if not bool(up.any()):
            break
        b = b + up.long()
    return b


def variant_name(t: TransportTables) -> str:
    """The K4 instantiation the tables select: ``classic`` or
    ``full_relativity``."""
    return "full_relativity" if t.full_relativity else "classic"


def library_defines(t: TransportTables) -> tuple:
    """nvcc -D flags of the K4 instantiation the tables select."""
    return (f"VV_FULL_RELATIVITY={int(t.full_relativity)}",)


def _volley_cuda(t: TransportTables, rec, V, edges, lo, hi, hist, n_seg,
                 ray_nu, ray_e):
    buckets = line_buckets(t)
    fn = cuda.function("vpacket_volley", "vpacket_volley", _ARGTYPES,
                       library_defines(t))
    p = cuda.ptr
    M = edges.shape[0] - 1
    err = fn(
        p(rec), rec.shape[0], V, p(t.r_inner), p(t.r_outer), p(t.chi_e),
        p(t.line_nu), p(t.prefix), t.n_lines, t.n_shells, p(buckets.counts),
        buckets.n_buckets, buckets.base, buckets.shift, p(edges), M, lo, hi,
        p(hist),
        p(n_seg), None if ray_nu is None else p(ray_nu),
        None if ray_e is None else p(ray_e), cuda.stream(),
    )
    cuda.check_launch("vpacket_volley", err)
    name = variant_name(t)
    by = trace_vpacket_records.launches_by_variant
    by[name] = by.get(name, 0) + 1


_VP, _I64, _CI, _CF = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_float)
_ARGTYPES = ([_VP, _I64, _CI] + [_VP] * 5 + [_I64, _CI, _VP, _CI, _CI, _CI,
                                              _VP, _CI, _CF, _CF]
             + [_VP] * 5)


def _check_cuda(t: TransportTables, records, nu_edges):
    f32 = torch.float32
    device = records.device
    cuda.check_cuda(
        "vpacket_volley", device, records=(records, f32),
        r_inner=(t.r_inner, f32), r_outer=(t.r_outer, f32),
        chi_e=(t.chi_e, f32), line_nu=(t.line_nu, f32),
        prefix=(t.prefix, torch.float64), nu_edges=(nu_edges, f32),
    )
    if (records.dim() != 2 or records.shape[1] != 8
            or t.prefix.shape != (t.n_shells, t.n_lines + 1)
            or nu_edges.dim() != 1 or nu_edges.shape[0] < 2):
        raise ValueError("vpacket_volley: shapes do not agree")


def _empty_output(records, V, nu_edges, return_packets) -> VolleyOutput:
    device = records.device
    out = VolleyOutput(
        hist=torch.zeros(nu_edges.shape[0] - 1, dtype=torch.float64,
                         device=device),
        n_segments=torch.zeros(1, dtype=torch.int64, device=device),
    )
    if return_packets:
        n_rays = records.shape[0] * V
        out.nu = torch.zeros(n_rays, dtype=torch.float32, device=device)
        out.energy = torch.zeros(n_rays, dtype=torch.float32, device=device)
    return out


def trace_vpacket_records_plain(t: TransportTables, records, n_vpackets: int,
                                nu_edges, spawn_nu_range=(0.0, np.inf),
                                return_packets: bool = False,
                                max_rays_per_chunk: int = 8_388_608,
                                ) -> VolleyOutput:
    """Plain PyTorch version of K4.

    ``records`` (R, 8) f32 spawn records (every row traced), ``nu_edges``
    (M+1,) f32 ascending bin edges in NU_UNIT, ``spawn_nu_range`` the
    (lo, hi) record frequencies that spawn (NU_UNIT).
    """
    V = int(n_vpackets)
    out = _empty_output(records, V, nu_edges, return_packets)
    lo, hi = _spawn_range(spawn_nu_range)
    R = records.shape[0]
    step = max(max_rays_per_chunk // max(V, 1), 1)
    for start in range(0, R, step):
        end = min(start + step, R)
        nu_vp, e_out, segs = _volley_plain(t, records[start:end], V,
                                           nu_edges, lo, hi, out.hist,
                                           out.n_segments)
        if return_packets:
            out.nu[start * V:end * V] = nu_vp
            out.energy[start * V:end * V] = e_out
            if out.segments is None:
                out.segments = torch.zeros(R * V, dtype=torch.int32,
                                           device=records.device)
            out.segments[start * V:end * V] = segs
    return out


def trace_vpacket_records(t: TransportTables, records, n_vpackets: int,
                          nu_edges, spawn_nu_range=(0.0, np.inf),
                          return_packets: bool = False) -> VolleyOutput:
    """K4 on the card, one launch over every ray; the plain version for CPU
    tensors.  Arguments as ``trace_vpacket_records_plain``."""
    device = records.device
    if device.type == "cpu":
        return trace_vpacket_records_plain(
            t, records, n_vpackets, nu_edges, spawn_nu_range, return_packets)
    if device.type != "cuda":
        raise ValueError(f"vpacket_volley: unsupported device {device}")
    _check_cuda(t, records, nu_edges)
    V = int(n_vpackets)
    out = _empty_output(records, V, nu_edges, return_packets)
    lo, hi = _spawn_range(spawn_nu_range)
    if records.shape[0] * V > 0:
        _volley_cuda(t, records, V, nu_edges, lo, hi, out.hist,
                     out.n_segments, out.nu, out.energy)
    return out


trace_vpacket_records.launches_by_variant = {}  # launches by variant_name
