"""Monte Carlo packet event loop (kernel K1, ``csrc/transport_loop.cu``).

Counterpart of ``tardis_tpu/transport/kernel.py`` (``make_transport_step``
driven by ``run_transport``), with the luminosity summary of
``tardis_tpu/transport/solver.py`` ``_device_summary`` folded in.

Per event, with every random number from
``uniform(fold_in(fold_in(key, packet_id), event_idx), (10,), 1e-9, 1)``
(columns 0: tau, 1: mu, 2: Thomson / continuum split, 3: bound-free /
free-free split, 4: continuum selection, 5: albedo, 6: chain row or
absorbing state, 7: emission row or deactivation channel, 8: free-bound /
two-photon frequency, 9: free-free frequency), exactly the JAX package's
draws:

1. boundary distance (an inward hit needs mu < 0 strictly);
2. the first line i >= next_line whose resonance lies past the boundary or
   whose optical depth from next_line exceeds tau_event = -ln u0;
3. bulk j / nu-bar estimators, and the line difference array
   (``(line * S + shell) * 2 + {0: j_blue, 1: e_dot}``, +w at next_line,
   -w at the end of the crossed range);
4. the move, then a boundary crossing, a Thomson scatter or a line
   interaction (scatter, downbranch or the macro-atom absorbing chain);
5. death at the outer (emitted, +nu) or inner (reabsorbed, -nu) boundary.

Options, each a branch of the JAX step (``OPTIONS``; on the card each
combination is its own compiled instantiation of K1):

- ``full_relativity`` (``tables.full_relativity``, ``kernel.py:491-498,
  565-570,609-611,625-663,697,742-750,811-821``): the birth transform with
  gamma and aberration, dop = (1 - mu r) gamma(r), chi_e * dop, the
  quadratic resonance distance (``tiled_search.py:494-500``), the estimator
  path times dop, and line-independent j_blue / e_dot increments E / nu and
  E (the solver then drops the nu_i factor);
- ``reflective`` (``tables.inner_boundary_albedo`` > 0, ``:798-807,
  940-944``): a packet at the inner boundary is reflected (mu -> -mu, it
  stays in shell 0) when column 5 falls below the albedo;
- ``weights`` (``pool_w``, ``:503-505``): the birth energy times the
  pool's weight (weighted and relativistic pools);
- ``last_interaction`` (``:969-985``): per packet the row
  [type, in_line, out_line, shell, in_nu, r] of its last interaction
  (type 2 line, 1 e-scatter, 3 continuum process; lines -1 unless a line;
  in_nu before it, r after the move; zeros for a packet that never
  interacts);
- ``tracker`` (``tracker_length`` K > 0, ``:949-967``): the rows
  [r, nu, energy, shell, code, mu] after each of a packet's first K events
  (code 2 line, 1 e-scatter, 3 boundary, 4 continuum process);
- ``continuum`` (``tables.continuum``, the Type IIP workflow; ``:366-422,
  571-606,714-740,781-792,829-863,879-889``): chi = chi_e + chi_bf + chi_ff
  with chi_bf summed over the continua on the merged bound-free grid; the
  estimator moments [w, w/nu, w nu, wb, wb/nu, wb nu, 1, 0] per
  (grid cell, shell) with b = exp(-h nu / k T_e) and the free-free heating
  w chi_ff per shell; a continuous event is a Thomson scatter with
  probability chi_e / chi, else a continuum process (bound-free with
  probability chi_bf / (chi_bf + chi_ff), the continuum picked by column 4
  on the running sum, or free-free); lines and continuum processes
  activate the absorbing-Markov macro atom (two draws: the absorbing
  state, then the deactivation channel), which emits a line, a free-bound
  (column 8 on the continuum's emission CDF) or free-free photon
  (-ln u9 k T_e / h);
- ``two_photon`` (``:864-878``): the two-photon channel's frequency from
  the inverse-CDF table (column 8);
- ``adiabatic`` (``:917-928,1016-1021``): the adiabatic-cooling channel
  ends the packet with output (-nu before the interaction, energy 0).
- ``walk`` (``tables.walk``, ``:281`` ``_macro_walk``, wired at
  ``:474-478,549-557,895-910``): where the chain tables do not fit the
  device budget, or the solver is told to walk, a line interaction in
  downbranch or macroatom mode walks the macro atom
  (``macro_walk.macro_walk``: up to 40 jumps, or 1 in downbranch mode, each
  drawn from ``fold_in(event key, 8 + jump)``) and emits at
  ``line_nu[em_line]``.

``line_estimators`` (``TL_LINE_ESTIMATORS``, on by default) is the line
difference array, the j_blue / e_dot estimators' increments, which only the
callers that read them ask for (the final iteration; the convergence
iterations and the IIP workflow read the bulk estimators alone, as the JAX
package's ``need_line_estimators`` reads back, ``tardis_tpu/transport/
solver.py:535``).  With it off no line difference array is allocated or
written: ``line_diff`` is an empty tensor.  The continuum instantiations
always accumulate it.

With ``vpacket_capacity`` > 0 (the final iteration with virtual packets)
every birth and every interaction appends a spawn record for the vpacket
volley (``transport/vpacket.py``), as ``kernel.py:520-545,987-1008`` of the
JAX package do: ``[r, mu, nu, energy, shell, next_line, li_type, out_line]``
f32, the birth row ``[beta_inner, mu, nu, energy, 0, birth_line, -1, -1]``,
an interaction row the state after the scatter with ``li_type`` 1 for an
e-scatter, 2 for a line and 3 for a continuum process and ``out_line =
next_line - 1`` for a line or a continuum process (both activate the macro
atom; a packet the adiabatic channel ends writes its row too).
``vp_count`` counts every attempt; rows past the capacity are dropped.
On the card the continuum loop writes records only in its ``records``
instantiation (``TL_RECORDS``), so the one without them stays as it was;
which rows survive past the capacity depends on the order of the atomic
claims there (the JAX package keeps the first in step order).

``transport_loop`` launches the CUDA kernel (a persistent grid of lanes
that take packets from a queue and refill as soon as a packet ends) for
tensors on the card and runs the plain PyTorch version
``transport_loop_plain`` (a lockstep loop over lanes refilled from the
pool, as the JAX package steps) only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import logging
from dataclasses import dataclass

import numpy as np
import torch

from tardis_torch import cuda, tracing
from tardis_torch.transport import rng
from tardis_torch.transport.macro_walk import lower_bound, macro_walk
from tardis_torch.transport.tables import (
    GAMMA_FLOOR,
    LINE_MACROATOM,
    LINE_SCATTER,
    ContinuumTables,
    TransportTables,
    lorentz_gamma,
)

STATUS_IN_PROCESS = 0
STATUS_EMITTED = 1
STATUS_REABSORBED = 2
# per-packet event cap: a packet alive after this many events is stopped
# without output and counted (the JAX package's immortal-lane guard)
MAX_EVENTS = 500_000

COL_TAU, COL_MU, COL_ALBEDO, COL_CHAIN, COL_EMIT = 0, 1, 5, 6, 7
COL_ESCAT, COL_BFFF, COL_CONT_SEL, COL_FB, COL_FF = 2, 3, 4, 8, 9
U_MIN = 1e-9

# interaction / tracker codes
LI_ESCAT, LI_LINE, LI_CONTPROC, EV_BOUNDARY_CODE, EV_CONTPROC_CODE = (
    1, 2, 3, 3, 4)
# deactivation kinds of the Markov macro atom (opacities/continuum_macro.py
# EMIT_*; free-free, 2, is the default branch)
EMIT_LINE, EMIT_BF, EMIT_TWO_PHOTON, EMIT_ADIABATIC = 0, 1, 3, 4

# K1's compile-time options, in the order of their -D flags; every option
# is off by default but the line estimators, which are on
OPTIONS = ("full_relativity", "last_interaction", "tracker", "reflective",
           "weights", "continuum", "two_photon", "adiabatic", "records",
           "walk", "line_estimators")

logger = logging.getLogger(__name__)


@dataclass
class TransportOutput:
    out: torch.Tensor  # (N, 2) f32: signed nu (+ emitted, - reabsorbed), energy
    est_j: torch.Tensor  # (S,) f64
    est_nubar: torch.Tensor  # (S,) f64
    line_diff: torch.Tensor  # (2 * (L+1) * S,) f64 ((0,): not asked for)
    # [energy emitted inside the nu window, energy reabsorbed, events,
    #  packets stopped by the event cap]
    summary: torch.Tensor  # (4,) f64
    vp_records: torch.Tensor  # (capacity, 8) f32 spawn records
    vp_count: torch.Tensor  # (1,) i64 records attempted (may exceed capacity)
    # (N, 6) f32 [type, in_line, out_line, shell, in_nu, r] ((0, 6): off)
    last_interaction: torch.Tensor
    # (N, K, 6) f32 [r, nu, energy, shell, code, mu] ((0, 0, 6): off)
    tracker: torch.Tensor
    # continuum only ((0, 8), (0,) otherwise): the estimator moments
    # ((Ng - 1) * S, 8) f64 by row gcell * S + shell and the free-free
    # heating (S,) f64; each packet's event count (N,) i32, kept with
    # continuum and by every plain version ((0,) otherwise)
    cont_moments: torch.Tensor
    est_ff_heat: torch.Tensor
    events: torch.Tensor
    # (1,) i64: the event searches that K1's margin guard sent to the full
    # bisection (classic loop under full relativity on the card; 0 from
    # the plain version, which always bisects)
    search_fallbacks: torch.Tensor
    # continuum only ((0,) otherwise): (2,) f64 [packets handed to the
    # drain tail, events run there] (0 from the plain version, which has no
    # tail)
    tail: torch.Tensor

    @property
    def n_vp_records(self) -> int:
        """Records written: the attempts, clipped to the capacity."""
        return min(int(self.vp_count[0]), self.vp_records.shape[0])


def variant(t: TransportTables, pool_w=None, last_interaction=False,
            tracker_length=0, line_estimators=True,
            vpacket_capacity=0) -> tuple:
    """The option flags (in ``OPTIONS`` order) of one K1 configuration;
    ``records`` is the continuum loop's spawn records (the classic loop
    tests its capacity at run time)."""
    c = t.continuum
    return (bool(t.full_relativity), bool(last_interaction),
            tracker_length > 0, t.inner_boundary_albedo > 0.0,
            pool_w is not None, c is not None,
            c is not None and c.two_photon, c is not None and c.adiabatic,
            c is not None and vpacket_capacity > 0,
            walks(t), bool(line_estimators))


def walks(t: TransportTables) -> bool:
    """Whether K1's line interactions walk the macro atom (the walk
    tables are set, in downbranch or macroatom mode, without continuum)
    instead of drawing from the chain tables."""
    return (t.walk is not None and t.mode != LINE_SCATTER
            and t.continuum is None)


def variant_name(flags, options=OPTIONS, plain="classic") -> str:
    """``plain`` or the options that are on, joined by ``+``; an
    instantiation without line estimators ends in ``no_line_estimators``
    (K7's names come from the same rule with its own ``options``)."""
    on = [name for name, f in zip(options, flags)
          if f and name != "line_estimators"]
    if not flags[options.index("line_estimators")]:
        on.append("no_line_estimators")
    return "+".join(on) if on else plain


def _allocate(n_packets, S, L, capacity, last_interaction, tracker_length,
              device, cont: ContinuumTables | None = None,
              line_estimators: bool = True,
              events: bool = False) -> TransportOutput:
    z = torch.zeros
    f32, f64 = torch.float32, torch.float64
    n_moment_rows = 0 if cont is None else (cont.n_grid - 1) * S
    return TransportOutput(
        out=z((n_packets, 2), dtype=f32, device=device),
        est_j=z(S, dtype=f64, device=device),
        est_nubar=z(S, dtype=f64, device=device),
        line_diff=z(2 * (L + 1) * S if line_estimators else 0, dtype=f64,
                    device=device),
        summary=z(4, dtype=f64, device=device),
        vp_records=z((capacity, 8), dtype=f32, device=device),
        vp_count=z(1, dtype=torch.int64, device=device),
        last_interaction=z((n_packets if last_interaction else 0, 6),
                           dtype=f32, device=device),
        tracker=z((n_packets if tracker_length else 0, tracker_length, 6),
                  dtype=f32, device=device),
        cont_moments=z((n_moment_rows, 8), dtype=f64, device=device),
        est_ff_heat=z(0 if cont is None else S, dtype=f64, device=device),
        events=z(n_packets if events or cont is not None else 0,
                 dtype=torch.int32,
                 device=device),
        search_fallbacks=z(1, dtype=torch.int64, device=device),
        tail=z(0 if cont is None else 2, dtype=f64, device=device),
    )


def _spawn(res: TransportOutput, n_attempted: int, rows) -> int:
    """Append ``rows`` after ``n_attempted`` records, dropping those past
    the capacity; returns the new attempt count."""
    cap = res.vp_records.shape[0]
    keep = max(0, min(rows.shape[0], cap - n_attempted))
    if keep:
        res.vp_records[n_attempted:n_attempted + keep] = rows[:keep]
    return n_attempted + rows.shape[0]


def _window(nu_window):
    lo, hi = nu_window
    hi = float(np.finfo(np.float32).max) if not np.isfinite(hi) else hi
    return float(np.float32(lo)), float(np.float32(hi))


def _draws(k0, k1, cols, device):
    """f32 uniforms (lanes, len(cols)) in [1e-9, 1) under keys (k0, k1)."""
    c = torch.tensor(cols, dtype=torch.int64, device=device)[None, :]
    bits = rng.random_bits((k0[:, None], k1[:, None]), c)
    return rng.uniform(bits, U_MIN, 1.0)


def _resonance_distance(nu_line, nu, z, p2, full_relativity):
    """Path from the packet to the resonance of ``nu_line``: 1 - nu_i / nu
    - mu r, or under full relativity the root y - mu r of the resonance
    quadratic with p^2 = r^2 (1 - mu^2); clipped at 0."""
    if full_relativity:
        a = nu_line * nu_line
        b = nu * nu
        disc = torch.clamp(a * (a - (a + b) * p2), min=0.0)
        y = (b - torch.sqrt(disc)) / (a + b)
        return torch.clamp(y - z, min=0.0)
    return torch.clamp((1.0 - nu_line / nu) - z, min=0.0)


def _fires(t: TransportTables, shell, i, chi, z, nu, tau_event, nu_thresh,
           c0, p2):
    """K1's event predicate at line ``i`` (< L): nu_i at or below the
    boundary's frequency, or the optical depth to line i above tau."""
    return ((t.line_nu[i] <= nu_thresh)
            | (_depth(t, shell, i, chi, z, nu, c0, p2) > tau_event))


def _search(t: TransportTables, shell, lo, chi, z, nu, tau_event,
            nu_thresh, c0, p2):
    """First i in [lo, L] with i == L or ``_fires``, by a bisection of
    [lo, L]."""
    L = t.n_lines
    hi = torch.full_like(lo, L)
    for _ in range(int(np.ceil(np.log2(L + 1))) + 1):
        active = lo < hi
        mid = (lo + hi) >> 1
        fire = _fires(t, shell, torch.clamp(mid, max=L - 1), chi, z, nu,
                      tau_event, nu_thresh, c0, p2)
        lo = torch.where(active & ~fire, mid + 1, lo)
        hi = torch.where(active & fire, mid, hi)
    return lo


def _depth(t: TransportTables, shell, i, chi, z, nu, c0, p2):
    """The optical depth g_i that ``_fires`` compares with tau (i < L)."""
    s = _resonance_distance(t.line_nu[i], nu, z, p2, t.full_relativity)
    return (t.prefix.reshape(-1)[shell * (t.n_lines + 1) + i + 1]
            - c0).float() + chi * s


def _rel_search_proven(t: TransportTables, shell, start, k, chi, z, nu,
                       tau_event, nu_thresh, c0, p2):
    """K1's margin guard under full relativity (``rel_search_proven`` in
    ``csrc/transport_loop.cu``, where the bound is derived), in the same
    operations: True where the event predicate is proven monotone on
    [start, L], so that the index ``k`` the gallop found is the
    bisection's.  The optical depths at k - 1 and k, which the kernel
    keeps from its probes, are computed again here, and the test runs in
    f64, where the kernel rounds each f32 step outward: the two can part
    only where a margin lies within an f32 rounding of the bound, and both
    are sound."""
    u = 2.0 ** -24
    L = t.n_lines
    two_delta = 2.0 * u * chi.double() * (42.0 + 48.0 * p2.double())
    tau = tau_event.double()
    g_before = _depth(t, shell, torch.clamp(k - 1, 0, L - 1), chi, z, nu,
                      c0, p2).double()
    before = (k <= start) | (g_before * (1.0 + 2.0 * u) + two_delta < tau)
    kk = torch.clamp(k, max=L - 1)
    g_at = _depth(t, shell, kk, chi, z, nu, c0, p2).double()
    after = ((k >= L) | (t.line_nu[kk] <= nu_thresh)
             | (g_at * (1.0 - 2.0 * u) - two_delta > tau * (1.0 + 4.0 * u)))
    return (2.0 * nu_thresh >= nu) & (p2 <= 0.1) & before & after


def _gallop(t: TransportTables, shell, lo, chi, z, nu, tau_event, nu_thresh,
            c0, p2):
    """K1's card search in torch ops (``ClassicWalker::event``): probes at
    ``lo`` + 0, 1, 3, 7, ... up to the first that fires, then a bisection
    of the bracket.  Without full relativity it is the whole search; under
    it ``_gallop_guarded`` adds the margin guard."""
    L = t.n_lines
    start, hi = lo.clone(), torch.full_like(lo, L)
    probe, span = lo.clone(), torch.ones_like(lo)
    active = probe < L
    while bool(active.any()):
        fire = _fires(t, shell, torch.clamp(probe, max=L - 1), chi, z, nu,
                      tau_event, nu_thresh, c0, p2)
        hi = torch.where(active & fire, probe, hi)
        lo = torch.where(active & ~fire, probe + 1, lo)
        active = active & ~fire
        span = span * 2
        probe = start + span - 1
        active = active & (probe < L)
    while bool((lo < hi).any()):
        active = lo < hi
        mid = (lo + hi) >> 1
        fire = _fires(t, shell, torch.clamp(mid, max=L - 1), chi, z, nu,
                      tau_event, nu_thresh, c0, p2)
        lo = torch.where(active & ~fire, mid + 1, lo)
        hi = torch.where(active & fire, mid, hi)
    return lo


def _gallop_guarded(t: TransportTables, shell, lo, chi, z, nu, tau_event,
                    nu_thresh, c0, p2):
    """K1's card search under full relativity, in torch ops: ``_gallop``,
    then the margin guard (``_rel_search_proven``); where the guard fails,
    the bisection of [lo, L] (``_search``).  Returns (index, fell back).
    The plain version itself bisects, as the JAX package does; the tests
    hold this mirror against it."""
    args = (chi, z, nu, tau_event, nu_thresh, c0, p2)
    k = _gallop(t, shell, lo.clone(), *args)
    fell_back = ~_rel_search_proven(t, shell, lo, k, *args)
    bisect = _search(t, shell, lo.clone(), *args)
    return torch.where(fell_back, bisect, k), fell_back


def _emission(t: TransportTables, shell, i_ev, u_chain, u_emit):
    """Macro-atom / downbranch emitted line id and frequency."""
    M, W, We = t.n_states, t.chain_width, t.emit_width
    j = t.line2macro[torch.clamp(i_ev, max=t.n_lines - 1)].long()
    if t.mode == LINE_MACROATOM:
        row = t.chain_cdf[shell * M + j]  # (B, W+1)
        k = torch.clamp((row[:, :W] < u_chain[:, None]).sum(1), max=W - 1)
        j = row[:, W].long() + k
    erow = t.emit_cdf[shell * M + j]  # (B, 3*We)
    k2 = torch.clamp((erow[:, :We] < u_emit[:, None]).sum(1), max=We - 1)
    em_line = erow[:, We:2 * We].gather(1, k2[:, None])[:, 0].long()
    nu_em = erow[:, 2 * We:].gather(1, k2[:, None])[:, 0]
    return em_line, nu_em


def _continuum_opacity(c: ContinuumTables, S, shell, nu_cmf):
    """The bound-free grid cell, its interpolation weight, the Boltzmann
    factor, the running bound-free sum over the continua (a list, one
    (B,) tensor per continuum: the sum is taken left to right, as K1 does)
    and chi_ff, all in the comoving frame."""
    Ng, C = c.n_grid, c.n_continua
    gcell = torch.clamp(torch.searchsorted(c.grid_nu, nu_cmf, right=True) - 1,
                        0, Ng - 2)
    g0 = c.grid_nu[gcell]
    dg = c.grid_nu[gcell + 1] - g0
    tfrac = torch.clamp((nu_cmf - g0) / torch.clamp(dg, min=1e-30), 0.0, 1.0)
    boltz = torch.exp(-(nu_cmf * c.boltz_coef[shell]).double()).float()
    xs = c.xsect.view(Ng, C)
    x0, x1 = xs[gcell], xs[gcell + 1]  # (B, C)
    ab = torch.arange(C, device=shell.device)[None, :] * S + shell[:, None]
    term = torch.clamp(
        (x0 + tfrac[:, None] * (x1 - x0))
        * (c.coef_a[ab] - c.coef_b[ab] * boltz[:, None]), min=0.0)
    cum, running = [], torch.zeros_like(tfrac)
    for k in range(C):
        running = running + term[:, k]
        cum.append(running)
    nuc = torch.clamp(nu_cmf, min=1e-30)
    chi_ff = c.ff_coef[shell] / ((nuc * nuc) * nuc) * (1.0 - boltz)
    return gcell, boltz, cum, chi_ff


def _markov(c: ContinuumTables, S, shell, state0, u_row, u_deact):
    """The absorbing-Markov macro atom (``kernel.py:366-398``): the
    absorbing state from the state's cumulative row, then the channel in
    that state's deactivation block; returns (kind, channel id)."""
    M = c.n_states
    row = c.mk_cum_b.view(S * M, M)[shell * M + state0]  # (B, M)
    a = torch.clamp((row < u_row[:, None]).sum(1), max=M - 1)
    b0 = c.deact_block_start[a].long()
    b1 = c.deact_block_start[a + 1].long()
    t = lower_bound(c.deact_cum_prob, lambda i: i * S + shell, b0, b1,
                    u_deact, c.deact_steps)
    t = torch.minimum(torch.maximum(t, b0), torch.maximum(b1 - 1, b0))
    return c.deact_kind[t].long(), c.deact_id[t].long()


def _free_bound_nu(c: ContinuumTables, S, shell, cont_id, z):
    """Free-bound emission frequency of continuum ``cont_id``: linear
    inverse interpolation of its emission CDF (``kernel.py:401-422``)."""
    cc = torch.clamp(cont_id, 0, c.n_continua - 1)
    b0 = c.pion_block_start[cc].long()
    b1 = c.pion_block_start[cc + 1].long()
    idx = lower_bound(c.fb_cdf, lambda i: i * S + shell, b0, b1, z,
                      c.fb_steps)
    idx = torch.minimum(torch.maximum(idx, b0 + 1),
                        torch.maximum(b1 - 1, b0 + 1))
    cdf_i = c.fb_cdf[idx * S + shell]
    cdf_im = c.fb_cdf[(idx - 1) * S + shell]
    nu_i, nu_im = c.fb_nu[idx], c.fb_nu[idx - 1]
    gap = cdf_i > cdf_im
    frac = torch.where(gap, (cdf_i - z) / torch.where(gap, cdf_i - cdf_im,
                                                      1.0), 0.0)
    return nu_i - frac * (nu_i - nu_im)


def _markov_emission(t: TransportTables, shell, is_line, i_ev, cum, chi_ff,
                     boltz_coef, U, col):
    """Deactivation of the continuum macro atom for every lane: the
    activated state, the channel, the emitted comoving frequency and the
    next line; returns (kind, line id, nu_cmf, next_line)."""
    c = t.continuum
    S, L = t.n_shells, t.n_lines
    chi_bf = cum[-1]
    frac_bf = chi_bf / torch.clamp(chi_bf + chi_ff, min=1e-30)
    is_bf = U[:, col[COL_BFFF]] < frac_bf
    u_sel = U[:, col[COL_CONT_SEL]] * chi_bf
    c_sel = torch.zeros_like(shell)
    for run in cum:
        c_sel += (run < u_sel).long()
    c_sel = torch.clamp(c_sel, max=c.n_continua - 1)
    state0 = torch.where(
        is_line, c.line2state[torch.clamp(i_ev, max=L - 1)].long(),
        torch.where(is_bf, c.photo_ion_state[c_sel].long(), c.k_state))
    kind, chan = _markov(c, S, shell, state0, U[:, col[COL_CHAIN]],
                         U[:, col[COL_EMIT]])
    em_line = torch.clamp(chan, 0, L - 1)
    u_fb = U[:, col[COL_FB]]
    nu_fb = _free_bound_nu(c, S, shell, chan, u_fb)
    nu_ff = (-torch.log(U[:, col[COL_FF]].double())).float() / boltz_coef
    nu_em = torch.where(kind == EMIT_LINE, t.line_nu[em_line],
                        torch.where(kind == EMIT_BF, nu_fb, nu_ff))
    if c.two_photon:
        tpn = c.two_photon_nu.shape[0]
        pos = u_fb * float(tpn - 1)
        i_tp = torch.clamp(pos.long(), 0, tpn - 2)
        frac = pos - i_tp.float()
        nu_tp = (c.two_photon_nu[i_tp] * (1.0 - frac)
                 + c.two_photon_nu[i_tp + 1] * frac)
        nu_em = torch.where(kind == EMIT_TWO_PHOTON, nu_tp, nu_em)
    next_line = torch.where(
        kind == EMIT_LINE, em_line + 1,
        torch.searchsorted(-t.line_nu, -nu_em, right=True))
    return kind, em_line, nu_em, next_line


def transport_loop_plain(t: TransportTables, pool_mu, pool_nu, key,
                         nu_window=(0.0, np.inf), batch_size: int = 65536,
                         max_events: int = MAX_EVENTS,
                         vpacket_capacity: int = 0, pool_w=None,
                         last_interaction: bool = False,
                         tracker_length: int = 0,
                         pid_offset: int = 0,
                         line_estimators: bool = True) -> TransportOutput:
    """Plain PyTorch version of K1: a lockstep loop over ``batch_size`` lanes.

    Dead lanes refill from the pool in packet-id order; once the pool is
    spent, the live lanes are packed together (in order) whenever fewer
    than half are alive, so a long tail of a few packets steps at their
    width.  Every packet's arithmetic is elementwise and keyed by its id,
    so per-packet outputs do not depend on ``batch_size``.  Spawn records
    are appended in lane order within a step, as the JAX package's cumsum
    slots are.  ``line_estimators`` False skips the line difference array.
    Each packet's event count is kept in ``events``; with the walk, the
    walks' jump counts in ``res.walk_tally`` (``macro_walk.macro_walk``).
    """
    device = pool_mu.device
    N = pool_mu.shape[0]
    S, L = t.n_shells, t.n_lines
    full_rel = t.full_relativity
    reflective = t.inner_boundary_albedo > 0.0
    cont = t.continuum
    walk = walks(t)
    _check_line_estimators(cont, line_estimators)
    res = _allocate(N, S, L, vpacket_capacity, last_interaction,
                    tracker_length, device, cont, line_estimators,
                    events=True)
    walk_tally = {}
    moments = res.cont_moments.view(-1)
    n_vp = 0
    nu_lo, nu_hi = _window(nu_window)
    B = max(1, min(batch_size, N))
    f32, i64 = torch.float32, torch.int64
    beta_inner = t.r_inner[0]
    albedo = torch.tensor(t.inner_boundary_albedo, dtype=f32, device=device)
    cols = [COL_TAU, COL_MU, COL_CHAIN, COL_EMIT]
    if reflective:
        cols.append(COL_ALBEDO)
    if cont is not None:
        cols += [COL_ESCAT, COL_BFFF, COL_CONT_SEL, COL_FB, COL_FF]
    col = {c: i for i, c in enumerate(cols)}
    birth = torch.searchsorted(-t.line_nu, -pool_nu, right=True)
    pid_all = torch.arange(N, dtype=i64, device=device) + pid_offset
    kp_all = rng.fold_in(key, pid_all)

    r = torch.zeros(B, dtype=f32, device=device)
    mu = torch.zeros_like(r)
    nu = torch.ones_like(r)
    energy = torch.zeros_like(r)
    shell = torch.zeros(B, dtype=i64, device=device)
    next_line = torch.zeros_like(shell)
    pid = torch.zeros_like(shell)
    eidx = torch.zeros_like(shell)
    kp0 = torch.zeros_like(shell)
    kp1 = torch.zeros_like(shell)
    alive = torch.zeros(B, dtype=torch.bool, device=device)
    next_unborn = 0
    n_events = 0
    n_immortal = 0
    while True:
        # refill dead lanes from the pool
        if next_unborn < N:
            dead = ~alive
            new_ids = next_unborn + torch.cumsum(dead.long(), 0) - 1
            fill = dead & (new_ids < N)
            ids = torch.clamp(new_ids, max=N - 1)
            b_mu = pool_mu[ids]
            if full_rel:
                gamma_in = 1.0 / torch.sqrt(1.0 - beta_inner * beta_inner)
                inv_dop = (1.0 + b_mu * beta_inner) * gamma_in
                b_mu = (b_mu + beta_inner) / (1.0 + beta_inner * b_mu)
            else:
                inv_dop = 1.0 / (1.0 - b_mu * beta_inner)
            b_nu = pool_nu[ids] * inv_dop
            b_energy = inv_dop if pool_w is None else inv_dop * pool_w[ids]
            if vpacket_capacity:
                one = torch.ones_like(b_mu)
                n_vp = _spawn(res, n_vp, torch.stack(
                    [one * beta_inner, b_mu, b_nu, b_energy, 0.0 * one,
                     birth[ids].float(), -one, -one], dim=1)[fill])
            r = torch.where(fill, beta_inner, r)
            mu = torch.where(fill, b_mu, mu)
            nu = torch.where(fill, b_nu, nu)
            energy = torch.where(fill, b_energy, energy)
            shell = torch.where(fill, 0, shell)
            next_line = torch.where(fill, birth[ids], next_line)
            pid = torch.where(fill, ids, pid)
            eidx = torch.where(fill, 0, eidx)
            kp0 = torch.where(fill, kp_all[0][ids], kp0)
            kp1 = torch.where(fill, kp_all[1][ids], kp1)
            alive = alive | fill
            next_unborn += int(fill.sum())
        capped = alive & (eidx >= max_events)
        if bool(capped.any()):
            n_immortal += int(capped.sum())
            res.events[pid[capped]] = max_events
        alive = alive & ~capped
        n_alive = int(alive.sum())
        if n_alive == 0:
            if next_unborn >= N:
                break
            continue
        if next_unborn >= N and 2 * n_alive < B:
            keep = alive.nonzero()[:, 0]
            r, mu, nu, energy, shell, next_line, pid, eidx, kp0, kp1, \
                alive = (x[keep] for x in (r, mu, nu, energy, shell,
                                           next_line, pid, eidx, kp0, kp1,
                                           alive))
            B = n_alive

        # ---- draws
        ke = rng.fold_in((kp0, kp1), eidx)
        U = _draws(ke[0], ke[1], cols, device)
        tau_event = (-torch.log(U[:, col[COL_TAU]].double())).float()

        # ---- trace
        chi_e = t.chi_e[shell]
        r_in = t.r_inner[shell]
        r_out = t.r_outer[shell]
        z = mu * r
        dop = (1.0 - z) * lorentz_gamma(r) if full_rel else 1.0 - z
        nu_cmf = nu * dop
        chi = chi_e
        if cont is not None:
            boltz_coef = cont.boltz_coef[shell]
            gcell, boltz, cum, chi_ff = _continuum_opacity(cont, S, shell,
                                                           nu_cmf)
            chi = chi_e + cum[-1] + chi_ff
            escat_prob = chi_e / torch.clamp(chi, min=1e-30)
        if full_rel:
            chi = chi * dop
        out_d = torch.sqrt(torch.clamp(
            r_out * r_out + (mu * mu - 1.0) * r * r, min=0.0)) - r * mu
        check = r_in * r_in + r * r * (mu * mu - 1.0)
        hits_inner = (mu < 0.0) & (check >= 0.0)
        in_d = -r * mu - torch.sqrt(torch.clamp(check, min=0.0))
        d_b = torch.clamp(torch.where(hits_inner, in_d, out_d), min=0.0)
        delta = torch.where(hits_inner, -1, 1)

        c0 = t.prefix.reshape(-1)[shell * (L + 1) + next_line]
        if full_rel:
            p2 = torch.clamp((r * r) * (1.0 - mu * mu), min=0.0)
            rb2 = (r * r + d_b * d_b) + ((2.0 * r) * d_b) * mu
            nu_thresh = (nu * (1.0 - (z + d_b))) / torch.sqrt(
                torch.clamp(1.0 - rb2, min=GAMMA_FLOOR))
        else:
            p2 = None
            nu_thresh = nu * (1.0 - (z + d_b))
        i_ev = _search(t, shell, next_line.clone(), chi, z, nu, tau_event,
                       nu_thresh, c0, p2)
        in_range = i_ev < L
        nu_ev = torch.where(in_range, t.line_nu[torch.clamp(i_ev, max=L - 1)],
                            -torch.inf)
        found = in_range & (nu_ev > nu_thresh)
        s_ev = _resonance_distance(nu_ev, nu, z, p2, full_rel)
        tau_at = (t.prefix.reshape(-1)[shell * (L + 1) + i_ev] - c0).float()
        d_cont = torch.clamp((tau_event - tau_at) / chi, min=0.0)
        escat_f = d_cont < s_ev
        if t.disable_line_scattering:
            escat_f = torch.ones_like(escat_f)
        escat_nf = d_cont < d_b
        is_line = alive & found & ~escat_f
        is_escat = alive & torch.where(found, escat_f, escat_nf)
        is_boundary = alive & ~found & ~escat_nf
        distance = torch.where(
            found, torch.where(escat_f, d_cont, s_ev),
            torch.where(escat_nf, d_cont, d_b),
        )
        end_line = torch.where(is_line, i_ev + 1, i_ev)

        # ---- estimators
        path = distance * dop if full_rel else distance
        w_j = (energy * dop) * path
        res.est_j.index_add_(0, shell[alive], w_j[alive].double())
        res.est_nubar.index_add_(0, shell[alive],
                                 (w_j * nu_cmf)[alive].double())
        if cont is not None:
            inv_nu = 1.0 / torch.clamp(nu_cmf, min=1e-30)
            wb = w_j * boltz
            m = torch.stack([w_j, w_j * inv_nu, w_j * nu_cmf, wb,
                             wb * inv_nu, wb * nu_cmf,
                             torch.ones_like(w_j)], dim=1)[alive]
            base = ((gcell * S + shell) * 8)[alive]
            moments.index_add_(
                0, (base[:, None] + torch.arange(7, device=device)).reshape(-1),
                m.reshape(-1).double())
            res.est_ff_heat.index_add_(0, shell[alive],
                                       (w_j * chi_ff)[alive].double())
        if line_estimators:
            crossed = alive & (end_line != next_line)
            if full_rel:
                w1, w2 = energy / nu, energy
            else:
                w1, w2 = energy / (nu * nu), energy / nu
            w1, w2 = w1[crossed].double(), w2[crossed].double()
            a = (next_line[crossed] * S + shell[crossed]) * 2
            b = (end_line[crossed] * S + shell[crossed]) * 2
            res.line_diff.index_add_(0, torch.cat([a, a + 1, b, b + 1]),
                                     torch.cat([w1, w2, -w1, -w2]))

        # ---- move
        r_new = torch.sqrt(torch.clamp(
            r * r + distance * distance + 2.0 * r * distance * mu,
            min=1e-20))
        mu_new = (mu * r + distance) / r_new

        # ---- interactions
        if cont is not None:
            is_contproc = is_escat & (U[:, col[COL_ESCAT]] >= escat_prob)
            is_escat = is_escat & ~is_contproc
        else:
            is_contproc = torch.zeros_like(is_escat)
        new_shell = shell + delta
        emitted = is_boundary & (new_shell >= S)
        hits_core = is_boundary & (new_shell < 0)
        if reflective:
            reflected = hits_core & (U[:, col[COL_ALBEDO]] < albedo)
            reabsorbed = hits_core & ~reflected
        else:
            reflected = torch.zeros_like(hits_core)
            reabsorbed = hits_core
        mu_draw = 2.0 * U[:, col[COL_MU]] - 1.0
        if full_rel:
            gamma_new = lorentz_gamma(r_new)
            dop_old_pos = (1.0 - mu_new * r_new) * gamma_new
            inv_dop_new = (1.0 + mu_draw * r_new) * gamma_new
            mu_emit = (mu_draw + r_new) / (1.0 + r_new * mu_draw)
        else:
            dop_old_pos = 1.0 - mu_new * r_new
            inv_dop_new = 1.0 / (1.0 - mu_draw * r_new)
            mu_emit = mu_draw
        absorbs = is_line | is_contproc
        adiabatic = torch.zeros_like(absorbs)
        if cont is not None:
            kind, em_line, nu_em, next_em = _markov_emission(
                t, shell, is_line, i_ev, cum, chi_ff, boltz_coef, U, col)
            if cont.adiabatic:
                adiabatic = absorbs & (kind == EMIT_ADIABATIC)
        elif t.mode == LINE_SCATTER:
            em_line, nu_em = i_ev, nu_ev
            next_em = em_line + 1
        elif walk:
            em_line = i_ev.clone()
            if bool(is_line.any()):
                sel = is_line.nonzero()[:, 0]
                em_line[sel] = macro_walk(t.walk, t.max_jumps, t.walk_steps,
                                          shell[sel], i_ev[sel], ke[0][sel],
                                          ke[1][sel], walk_tally)
            nu_em = t.line_nu[torch.clamp(em_line, 0, L - 1)]
            next_em = em_line + 1
        else:
            em_line, nu_em = _emission(t, shell, i_ev, U[:, col[COL_CHAIN]],
                                       U[:, col[COL_EMIT]])
            next_em = em_line + 1
        interacts = is_escat | absorbs
        nu_new = torch.where(
            is_escat, nu * dop_old_pos * inv_dop_new,
            torch.where(absorbs, nu_em * inv_dop_new, nu),
        )
        energy = torch.where(interacts, energy * dop_old_pos * inv_dop_new,
                             energy)
        next_line = torch.where(absorbs, next_em,
                                torch.where(alive, end_line, next_line))
        if last_interaction and bool(interacts.any()):
            res.last_interaction[pid[interacts]] = torch.stack(
                [torch.where(is_line, LI_LINE, torch.where(
                    is_contproc, LI_CONTPROC, LI_ESCAT)).float(),
                 torch.where(is_line, i_ev, -1).float(),
                 torch.where(is_line, em_line, -1).float(),
                 shell.float(), nu, r_new], dim=1)[interacts]
        r = torch.where(alive, r_new, r)
        mu_after = torch.where(reflected, -mu_new, mu_new)
        mu = torch.where(interacts, mu_emit,
                         torch.where(alive, mu_after, mu))
        shell = torch.where(is_boundary & ~emitted & ~hits_core, new_shell,
                            shell)
        if tracker_length:
            slot = alive & (eidx < tracker_length)
            code = torch.where(is_line, LI_LINE, torch.where(
                is_escat, LI_ESCAT, torch.where(
                    is_contproc, EV_CONTPROC_CODE, EV_BOUNDARY_CODE))).float()
            res.tracker[pid[slot], eidx[slot]] = torch.stack(
                [r, nu_new, energy, shell.float(), code, mu], dim=1)[slot]
        if vpacket_capacity:
            li_type = torch.where(is_line, LI_LINE, torch.where(
                is_contproc, LI_CONTPROC, LI_ESCAT)).float()
            out_line = torch.where(absorbs, (next_line - 1).float(), -1.0)
            n_vp = _spawn(res, n_vp, torch.stack(
                [r, mu, nu_new, energy, shell.float(), next_line.float(),
                 li_type, out_line], dim=1)[interacts])

        # ---- deaths (nu is unchanged by a boundary crossing); an
        # adiabatic death leaves (-nu before the interaction, energy 0)
        dying = emitted | reabsorbed | adiabatic
        n_events += n_alive
        if bool(dying.any()):
            dpid = pid[dying]
            res.out[dpid, 0] = torch.where(emitted, nu, -nu)[dying]
            res.out[dpid, 1] = torch.where(adiabatic, 0.0, energy)[dying]
            res.events[dpid] = (eidx[dying] + 1).int()
            in_window = emitted & (nu > nu_lo) & (nu < nu_hi)
            res.summary[0] += energy[in_window].double().sum()
            res.summary[1] += energy[reabsorbed].double().sum()
        nu = nu_new
        alive = alive & ~dying
        eidx = eidx + 1
    res.summary[2] = n_events
    res.summary[3] = n_immortal
    res.vp_count[0] = n_vp
    if walk:
        res.walk_tally = walk_tally
    return res


def _check_line_estimators(cont: ContinuumTables | None,
                           line_estimators: bool) -> None:
    if cont is not None and not line_estimators:
        raise ValueError("transport_loop: the continuum instantiations always "
                         "accumulate the line estimators")


class ContinuumArgs(ctypes.Structure):
    """The C struct ``ContinuumArgs`` of ``csrc/transport_loop.cu``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "grid_nu", "xsect", "coef_a", "coef_b", "boltz_coef", "ff_coef",
        "mk_cum_b", "deact_block_start", "deact_cum_prob", "deact_kind",
        "deact_id", "line2state", "photo_ion_state", "fb_cdf", "fb_nu",
        "pion_block_start", "two_photon_nu", "moments", "ff_heat",
        "events", "park", "tail", "moments_private")] + [
            (name, ctypes.c_int) for name in (
                "n_grid", "n_continua", "n_states", "k_state",
                "n_two_photon", "n_deact", "n_fb", "moment_copies")] + [
                    ("tail_threshold", ctypes.c_int64)]


def _continuum_args(c: ContinuumTables, res: TransportOutput | None,
                    park=None, moments_private=None, moment_copies: int = 0,
                    tail_threshold: int = 0):
    """K1's continuum tables and outputs as a ``ContinuumArgs`` (with no
    ``res``, null output pointers: the sizes alone); ``park`` the drain
    tail's parking list, ``tail_threshold`` its hand-off threshold,
    ``moments_private`` the moments' ``moment_copies`` per-SM copies."""
    p = cuda.ptr
    outs = ((None,) * 6 if res is None else
            (p(res.cont_moments), p(res.est_ff_heat), p(res.events),
             p(park), p(res.tail), p(moments_private)))
    return ContinuumArgs(
        p(c.grid_nu), p(c.xsect), p(c.coef_a), p(c.coef_b), p(c.boltz_coef),
        p(c.ff_coef), p(c.mk_cum_b), p(c.deact_block_start),
        p(c.deact_cum_prob), p(c.deact_kind), p(c.deact_id), p(c.line2state),
        p(c.photo_ion_state), p(c.fb_cdf), p(c.fb_nu), p(c.pion_block_start),
        p(c.two_photon_nu), *outs, c.n_grid, c.n_continua, c.n_states,
        c.k_state, c.two_photon_nu.shape[0], c.deact_kind.shape[0],
        c.fb_nu.shape[0], moment_copies, tail_threshold)


def smem_tables_fit(t: TransportTables, defines: tuple) -> bool:
    """Whether K1's continuum tables, staged in shared memory with the
    lanes' accumulators, fit one block's shared memory on the current
    device: asked of K1 library ``defines``, which sizes its launch by the
    same function (``continuum_smem_fits`` in csrc/transport_loop.cu)."""
    fits = ctypes.c_int(0)
    fn = cuda.function("transport_loop", "continuum_smem_fits", [
        ctypes.POINTER(ContinuumArgs), ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)], defines)
    cuda.check_launch("continuum_smem_fits", fn(
        ctypes.byref(_continuum_args(t.continuum, None)), t.n_lines,
        t.n_shells, ctypes.byref(fits)))
    return bool(fits.value)


def tail_plan(t: TransportTables, defines: tuple, smem_tables: bool):
    """The continuum K1's drain tail on the current device, asked of K1
    library ``defines`` (``continuum_tail_plan`` in csrc/transport_loop.cu):
    (the warps its tail kernel holds resident, the default hand-off
    threshold; the bytes of one parked packet; the moments' private copies,
    one an SM)."""
    warps, packet_bytes, copies = (ctypes.c_int64(0), ctypes.c_int(0),
                                   ctypes.c_int(0))
    fn = cuda.function("transport_loop", "continuum_tail_plan", [
        ctypes.POINTER(ContinuumArgs), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)], defines)
    cuda.check_launch("continuum_tail_plan", fn(
        ctypes.byref(_continuum_args(t.continuum, None)), t.n_lines,
        t.n_shells, int(smem_tables), ctypes.byref(warps),
        ctypes.byref(packet_bytes), ctypes.byref(copies)))
    return warps.value, packet_bytes.value, copies.value


def _check_walk(t: TransportTables, device):
    w = t.walk
    i32 = torch.int32
    cuda.check_cuda("transport_loop", device,
                    cum_prob=(w.cum_prob, torch.float32),
                    block_start=(w.block_start, i32), dest=(w.dest, i32),
                    emit=(w.emit, torch.bool), line=(w.line, i32))
    T = w.dest.shape[0]
    if (w.cum_prob.shape != (T, t.n_shells) or w.emit.shape != (T,)
            or w.line.shape != (T,) or w.block_start.dim() != 1
            or t.max_jumps < 1):
        raise ValueError("transport_loop: walk table shapes do not agree")


def _check_continuum(c: ContinuumTables, t: TransportTables, device):
    f32, i32 = torch.float32, torch.int32
    cuda.check_cuda(
        "transport_loop", device, grid_nu=(c.grid_nu, f32),
        xsect=(c.xsect, f32), coef_a=(c.coef_a, f32), coef_b=(c.coef_b, f32),
        boltz_coef=(c.boltz_coef, f32), ff_coef=(c.ff_coef, f32),
        mk_cum_b=(c.mk_cum_b, f32),
        deact_block_start=(c.deact_block_start, i32),
        deact_cum_prob=(c.deact_cum_prob, f32),
        deact_kind=(c.deact_kind, torch.int8), deact_id=(c.deact_id, i32),
        line2state=(c.line2state, i32),
        photo_ion_state=(c.photo_ion_state, i32), fb_cdf=(c.fb_cdf, f32),
        fb_nu=(c.fb_nu, f32), pion_block_start=(c.pion_block_start, i32),
        two_photon_nu=(c.two_photon_nu, f32),
    )
    S, L = t.n_shells, t.n_lines
    Ng, C, M = c.n_grid, c.n_continua, c.n_states
    D, P = c.deact_kind.shape[0], c.fb_nu.shape[0]
    if (c.xsect.shape != (Ng * C,) or c.coef_a.shape != (C * S,)
            or c.coef_b.shape != (C * S,) or c.boltz_coef.shape != (S,)
            or c.ff_coef.shape != (S,) or c.mk_cum_b.shape != (S * M * M,)
            or c.deact_cum_prob.shape != (D * S,)
            or c.deact_id.shape != (D,) or c.line2state.shape != (L,)
            or c.fb_cdf.shape != (P * S,)
            or c.pion_block_start.shape != (C + 1,) or Ng < 2
            or (c.two_photon and c.two_photon_nu.shape[0] < 2)
            or L >= 1 << 30):
        raise ValueError("transport_loop: continuum table shapes do not "
                         "agree")


def transport_loop(t: TransportTables, pool_mu, pool_nu, key,
                   nu_window=(0.0, np.inf),
                   max_events: int = MAX_EVENTS,
                   vpacket_capacity: int = 0, pool_w=None,
                   last_interaction: bool = False,
                   tracker_length: int = 0,
                   pid_offset: int = 0,
                   smem_tables: bool | None = None,
                   line_estimators: bool = True,
                   tail_threshold: int | None = None) -> TransportOutput:
    """K1 on the card; the plain version for CPU tensors.

    ``key`` is the iteration's run key; ``nu_window`` the (lo, hi)
    emitted-luminosity window in NU_UNIT; ``vpacket_capacity`` the number
    of spawn records to keep (0: none are written); ``pool_w`` the pool's
    per-packet weights (None: all 1); ``last_interaction`` and
    ``tracker_length`` turn on the two trackers; ``pid_offset`` is the
    global id of the pool's first packet (a shard of a larger pool hashes
    the global ids and writes its rows by the local ones);
    ``line_estimators`` False skips the line difference array (``line_diff``
    empty).  On the card the options select K1's compiled instantiation
    (``variant``), which runs as one launch of a persistent grid: its lanes
    take packet ids from a queue and refill as soon as a packet ends, so no
    lane waits on a warp's longest packet.

    With continuum the card runs a persistent grid (as many blocks as are
    resident) whose lanes take packet ids from a queue and refill as soon
    as a packet ends: the counterpart of the JAX package's lane refill and
    ``_repack_jit``.  No lane waits on a long random walk while the queue
    has work.  Two launches follow it on the same stream: the drain tail
    and the sum of the moments' per-SM copies (below).

    The continuum loop has two instantiations, picked by size: when the
    tables an event reads (the prefix, the line, grid, cross-section,
    Markov, deactivation and free-bound tables; 142,080 bytes at the IIP
    problem's 135 lines) fit one block's shared memory with its lanes'
    accumulators (``smem_tables_fit``), each persistent block of 512 lanes
    copies them there once and its events read them there; otherwise (real
    atom data, L ~ 1e5) blocks of 128 lanes read them from device memory.  ``smem_tables`` forces one
    instantiation (True must fit).

    The drain tail: once the queue is empty and no more packets are live
    than the tail kernel holds warps (``tail_plan``), the lanes still
    walking park their packets, and a second launch on the same stream runs
    each parked packet on a whole warp (``res.tail`` counts them and their
    events).  Each SM adds the moments to a private copy, summed into
    ``cont_moments`` by a third launch.  Every packet's row, event count
    and draws are the same whichever kernel runs its events; the f64 sums
    change only in their order.  ``tail_threshold`` replaces the tail's
    threshold (0: no hand-off; N or more: every packet at birth), for the
    tests.
    """
    device = pool_mu.device
    if device.type == "cpu":
        return transport_loop_plain(
            t, pool_mu, pool_nu, key, nu_window, max_events=max_events,
            vpacket_capacity=vpacket_capacity, pool_w=pool_w,
            last_interaction=last_interaction, tracker_length=tracker_length,
            pid_offset=pid_offset, line_estimators=line_estimators)
    if device.type != "cuda":
        raise ValueError(f"transport_loop: unsupported device {device}")
    cont = t.continuum
    if cont is None and (smem_tables is not None
                         or tail_threshold is not None):
        raise ValueError("transport_loop: smem_tables and tail_threshold "
                         "apply to the continuum loop")
    if tail_threshold is not None and tail_threshold < 0:
        raise ValueError("transport_loop: tail_threshold must be >= 0")
    _check_line_estimators(cont, line_estimators)
    f32 = torch.float32
    N = pool_mu.shape[0]
    cuda.check_cuda(
        "transport_loop", device, pool_mu=(pool_mu, f32),
        pool_nu=(pool_nu, f32), r_inner=(t.r_inner, f32),
        r_outer=(t.r_outer, f32), chi_e=(t.chi_e, f32),
        line_nu=(t.line_nu, f32), prefix=(t.prefix, torch.float64),
        line2macro=(t.line2macro, torch.int32),
        chain_cdf=(t.chain_cdf, f32), emit_cdf=(t.emit_cdf, f32),
        **({} if pool_w is None else {"pool_w": (pool_w, f32)}),
    )
    S, L = t.n_shells, t.n_lines
    rows = S * t.n_states
    walk = walks(t)
    classic_macro = cont is None and t.mode != LINE_SCATTER and not walk
    if walk:
        _check_walk(t, device)
    if (pool_mu.shape != (N,) or pool_nu.shape != (N,)
            or (pool_w is not None and pool_w.shape != (N,))
            or t.prefix.shape != (S, L + 1)
            or t.line2macro.shape != (L,)
            or (classic_macro and t.mode == LINE_MACROATOM
                and t.chain_cdf.shape != (rows, t.chain_width + 1))
            or (classic_macro
                and t.emit_cdf.shape != (rows, 3 * t.emit_width))):
        raise ValueError("transport_loop: table shapes do not agree")
    if cont is not None:
        _check_continuum(cont, t, device)
    flags = variant(t, pool_w, last_interaction, tracker_length,
                    line_estimators, vpacket_capacity)
    res = _allocate(N, S, L, vpacket_capacity, last_interaction,
                    tracker_length, device, cont, line_estimators)
    nu_lo, nu_hi = _window(nu_window)
    fn = cuda.function("transport_loop", "transport_loop", _ARGTYPES,
                       library_defines(flags))
    p = cuda.ptr
    args = [
        p(pool_mu), p(pool_nu), None if pool_w is None else p(pool_w), N,
        p(t.r_inner), p(t.r_outer), p(t.chi_e), p(t.line_nu), p(t.prefix),
        p(t.line2macro), p(t.chain_cdf), p(t.emit_cdf), L, S, t.n_states,
        t.chain_width, t.emit_width, t.mode, int(t.disable_line_scattering),
        key[0], key[1], nu_lo, nu_hi, float(t.inner_boundary_albedo),
        max_events, pid_offset, p(res.out), p(res.est_j), p(res.est_nubar),
        p(res.line_diff) if line_estimators else None, p(res.summary),
        p(res.vp_records),
        p(res.vp_count), vpacket_capacity, p(res.last_interaction),
        p(res.tracker), tracker_length]
    w = t.walk if walk else None
    args += ([None] * 5 + [0] if w is None else
             [p(w.cum_prob), p(w.block_start), p(w.dest), p(w.emit),
              p(w.line), t.max_jumps])
    # the lanes' packet queue (the next packet id to take), the count of
    # the full-relativity search's fallbacks to the bisection, and the
    # continuum loop's drain tail: the packets ended in the first kernel,
    # the packets parked, the tail kernel's queue
    taken = torch.zeros(5, dtype=torch.int64, device=device)
    res.search_fallbacks = taken[1:2]
    if cont is None:
        args += [None, p(taken), 0, cuda.stream()]
    else:
        defines = library_defines(flags)
        fits = smem_tables_fit(t, defines)
        if smem_tables is None:
            smem_tables = fits
        elif smem_tables and not fits:
            raise ValueError("transport_loop: the continuum tables do not "
                             "fit shared memory")
        warps, packet_bytes, copies = tail_plan(t, defines, smem_tables)
        if tail_threshold is None:
            tail_threshold = warps
        park = torch.empty(min(N, tail_threshold) * packet_bytes,
                           dtype=torch.uint8, device=device)
        private = torch.zeros(copies * res.cont_moments.numel(),
                              dtype=torch.float64, device=device)
        args += [ctypes.byref(_continuum_args(cont, res, park, private,
                                              copies, tail_threshold)),
                 p(taken), int(smem_tables), cuda.stream()]
    with tracing.launch(transport_loop, variant_name(flags)):
        err = fn(*args)
        cuda.check_launch("transport_loop", err)
    return res


transport_loop.launches_by_variant = {}  # launches by variant_name


_VP, _I64, _CI, _CF = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_float)
_ARGTYPES = (
    [_VP, _VP, _VP, _I64] + [_VP] * 8 + [_I64] + [_CI] * 6
    + [ctypes.c_uint32, ctypes.c_uint32, _CF, _CF, _CF, _I64, _I64]
    + [_VP] * 7 + [_I64, _VP, _VP, _CI] + [_VP] * 5 + [_CI]
    + [ctypes.POINTER(ContinuumArgs), _VP, _CI, _VP]
)


def library_defines(flags) -> tuple:
    """nvcc -D flags of one K1 instantiation."""
    return tuple(f"TL_{name.upper()}={int(f)}"
                 for name, f in zip(OPTIONS, flags))


def warn_immortal(summary: np.ndarray) -> int:
    """Log how many packets the event cap stopped (``summary[3]`` of a
    ``TransportOutput``'s summary on the host); returns the count."""
    n = int(summary[3])
    if n:
        logger.warning(
            "%d packet(s) stopped after %d events (immortal-packet guard) — "
            "they carry no output", n, MAX_EVENTS,
        )
    return n
