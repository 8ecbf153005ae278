"""Nonhomologous-flow packet event loop (kernel K7, ``csrc/nonhom_loop.cu``).

Counterpart of ``tardis_tpu/transport/nonhomologous.py``: the tables
(``nonhomologous_tau_scale``, ``nonhomologous_plasma_state``,
``build_nonhom_tables``) and the event loop (``make_nonhom_step`` driven by
``nonhom_transport_loop``), with the RNG-walk macro atom of
``tardis_tpu/transport/kernel.py`` ``_macro_walk`` (``macro_walk.py``,
shared with K1).

Within shell ``i`` the velocity is piecewise linear, v(r) = v_in + m (r -
r_in).  Along a chord x = mu r + s the line-of-sight velocity (in c units,
lengths in c t_exp) is

    beta_los(x) = m x + q x / sqrt(p^2 + x^2),   q = beta_in - m r_in,

with p^2 = r^2 (1 - mu^2); the comoving frequency is nu (1 - beta_los).
Homologous flow is m = 1, q = 0.  Per event, with the draws of K1 (column
0 tau, 1 mu, 5 albedo of ``uniform(fold_in(fold_in(key, packet_id),
event_idx), (10,), 1e-9, 1)``):

1. the boundary distance, and the walk direction from the comoving
   frequency at the boundary: forward (redward, line index ascending) if
   it is not above the current one, else backward over the reversed line
   order;
2. the walked window of line indices: forward [next_line, lines above
   nu_cmf at the boundary); backward from the reddest line above
   nu_cmf (1 + 3e-7) to the last line at or above the boundary frequency;
3. the event line, from the inverted predicate: the remaining optical
   depth d_req = (tau_event - dC) / chi_e, and the line lies beyond
   beta_los(x0 + d_req) (or d_req < 0).  The predicate is monotone over
   the window where beta_los is monotone in the walk's direction over
   every x_req the window gives (``monotone_window``, a closed form in m,
   q, p^2 and the x_req of the window's first and last lines); there a
   bisection of the flat f64 prefix (forward, or of the reversed order)
   finds the first line that holds, the JAX package's line.  Elsewhere (a shell whose velocity falls steeply
   outward, extrapolated past its boundary, where beta_los turns back) the
   predicate can read true, false, true, and ``count_search`` counts false
   samples as the JAX package's three-level search does
   (``_nonhom_pred_search``), at the same sampled lines, so both packages
   take the same line (every level on the exact prefix difference, where
   the JAX package's coarse levels read the f32-rounded prefixes);
4. the event line's distance by 30 f32 bisection steps of beta_los(x) =
   1 - nu_i / nu on [x0, x_boundary];
5. a boundary crossing, a Thomson scatter or a line interaction; bulk
   estimators and the line difference array over the crossed range (the
   homologous separable form holds in any velocity law);
6. a line interaction re-emits the line (scatter) or walks the macro atom:
   at most ``max_jumps`` jumps, each drawing
   ``uniform(fold_in(fold_in(fold_in(key, packet_id), event_idx), 8 +
   jump), ())`` and taking the first transition of the level's block whose
   cumulative probability reaches it; an emission ends the walk, else the
   walk moves to the transition's destination; a walk that never emits
   scatters resonantly (``macro_walk.macro_walk``).

Options (each a compile-time instantiation on the card): the macro-atom
walk (downbranch and macroatom modes), last-interaction rows, the r-packet
tracker (rows [r, nu, energy, shell, code, 0]: the JAX package's
nonhomologous tracker leaves column 5 at 0) and the reflective inner
boundary, and the line estimators (on by default; off, the line difference
array is neither allocated nor written, as in K1).  ``nonhom_transport_loop``
launches K7 (a persistent grid of lanes that refill from a packet queue)
for tensors on the card and runs ``nonhom_transport_loop_plain`` (lockstep
lanes refilled from the pool) only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from tardis_torch import cuda, tracing
from tardis_torch.constants import C, SIGMA_THOMSON
from tardis_torch.opacities.macro_atom_solver import MacroWalkTables
from tardis_torch.plasma.line_tables import beta_sobolev
from tardis_torch.transport import rng
from tardis_torch.transport.kernel import (
    COL_ALBEDO,
    COL_MU,
    COL_TAU,
    EV_BOUNDARY_CODE,
    LI_ESCAT,
    LI_LINE,
    MAX_EVENTS,
    TransportOutput,
    _allocate,
    _draws,
    _window,
)
from tardis_torch.transport.kernel import variant_name as _variant_name
from tardis_torch.transport.macro_walk import macro_walk, max_jumps, walk_steps
from tardis_torch.transport.tables import (
    LINE_DOWNBRANCH,
    LINE_MODES,
    LINE_SCATTER,
    NU_UNIT,
)

# relative margin that keeps the just-emitted resonance out of a backward
# walk (the JAX package's CLOSE_LINE_MARGIN)
CLOSE_LINE_MARGIN = 3e-7
BISECTION_STEPS = 30
X_REQ_CAP = 1e15

# K7's compile-time options, in the order of their -D flags; every option
# is off by default but the line estimators, which are on
OPTIONS = ("macro", "last_interaction", "tracker", "reflective",
           "line_estimators")


@dataclass
class NonhomTables:
    """What K7 reads, on one device (lengths / (c t_exp), frequencies /
    NU_UNIT)."""

    r_inner: torch.Tensor  # (S,) f32
    r_outer: torch.Tensor  # (S,) f32
    beta_in: torch.Tensor  # (S,) f32 v_inner / c
    m_grad: torch.Tensor  # (S,) f32 (dv/dr) t_exp, signed
    chi_e: torch.Tensor  # (S,) f32
    line_nu: torch.Tensor  # (L,) f32 descending
    prefix: torch.Tensor  # (S, L+1) f64 forward tau prefix, leading 0
    rev_prefix: torch.Tensor  # (S, L+1) f64 prefix in reversed line order
    mode: int  # LINE_SCATTER / LINE_DOWNBRANCH / LINE_MACROATOM
    # the walk tables (None in scatter mode)
    walk: MacroWalkTables | None = None
    max_jumps: int = 0
    # bisection steps that settle a search of the widest transition block
    walk_steps: int = 1
    disable_line_scattering: bool = False
    inner_boundary_albedo: float = 0.0

    @property
    def n_shells(self) -> int:
        return self.r_inner.shape[0]

    @property
    def n_lines(self) -> int:
        return self.line_nu.shape[0]


def nonhomologous_tau_scale(geometry) -> np.ndarray:
    """Per-shell factor from homologous to nonhomologous Sobolev depth:
    tau_hom = K t_exp, tau_nonhom = K / |dv/dr|, the gradient floored at
    1e-8 / t_exp (coasting shells keep a finite depth)."""
    t_exp = geometry.time_explosion
    dvdr = np.abs(np.asarray(geometry.velocity_gradient, dtype=np.float64))
    dvdr = np.maximum(dvdr, 1e-8 / t_exp)
    return 1.0 / (t_exp * dvdr)


def nonhomologous_plasma_state(plasma_state, geometry):
    """The plasma state with tau_sobolev, beta_sobolev and the forward tau
    prefix rescaled to the nonhomologous law."""
    tau = plasma_state.tau_sobolev
    scale = torch.as_tensor(nonhomologous_tau_scale(geometry),
                            dtype=tau.dtype, device=tau.device)
    tau = tau * scale[None, :]
    return dataclasses.replace(plasma_state, tau_sobolev=tau,
                               beta_sobolev=beta_sobolev(tau),
                               tau_prefix=_prefix(tau))


def _prefix(tau: torch.Tensor) -> torch.Tensor:
    """(S, L+1) f64 inclusive prefix of tau (L, S), leading 0."""
    S, L = tau.shape[1], tau.shape[0]
    out = torch.zeros((S, L + 1), dtype=torch.float64, device=tau.device)
    torch.cumsum(tau.T.to(torch.float64), dim=1, out=out[:, 1:])
    return out


def build_nonhom_tables(geometry, plasma_state, atom_data,
                        line_interaction_type: str = "scatter",
                        walk: MacroWalkTables | None = None,
                        disable_electron_scattering: bool = False,
                        disable_line_scattering: bool = False,
                        inner_boundary_albedo: float = 0.0) -> NonhomTables:
    """K7's tables on the device of ``plasma_state.tau_sobolev``, which must
    already hold the nonhomologous depths and their prefix
    (``nonhomologous_plasma_state``);
    ``walk`` (``solve_macro_state``) is needed in the macro modes."""
    tau = plasma_state.tau_sobolev
    device = tau.device
    ct = C * geometry.time_explosion
    mode = LINE_MODES[line_interaction_type]
    if mode != LINE_SCATTER and walk is None:
        raise ValueError(f"{line_interaction_type} needs the walk tables")
    sigma = 1e-200 if disable_electron_scattering else SIGMA_THOMSON

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    dvdr = np.asarray(geometry.velocity_gradient, dtype=np.float64)
    kw = {}
    if mode != LINE_SCATTER:
        kw = dict(walk=walk, walk_steps=walk_steps(walk.block_start.cpu()),
                  max_jumps=max_jumps(mode == LINE_DOWNBRANCH))
    return NonhomTables(
        r_inner=f32(geometry.r_inner / ct),
        r_outer=f32(geometry.r_outer / ct),
        beta_in=f32(geometry.v_inner / C),
        m_grad=f32(dvdr * geometry.time_explosion),
        chi_e=f32(sigma * np.asarray(plasma_state.electron_densities) * ct),
        line_nu=f32(atom_data.line_nu / NU_UNIT),
        prefix=plasma_state.tau_prefix,
        rev_prefix=_prefix(tau.flip(0)),
        mode=mode,
        disable_line_scattering=disable_line_scattering,
        inner_boundary_albedo=float(inner_boundary_albedo),
        **kw,
    )


def variant(t: NonhomTables, last_interaction=False, tracker_length=0,
            line_estimators=True):
    """The option flags (in ``OPTIONS`` order) of one K7 configuration."""
    return (t.mode != LINE_SCATTER, bool(last_interaction),
            tracker_length > 0, t.inner_boundary_albedo > 0.0,
            bool(line_estimators))


def variant_name(flags) -> str:
    """``scatter`` or the options that are on, joined by ``+`` (ending in
    ``no_line_estimators`` without the line estimators)."""
    return _variant_name(flags, OPTIONS, "scatter")


def library_defines(flags) -> tuple:
    """nvcc -D flags of one K7 instantiation."""
    return tuple(f"NH_{name.upper()}={int(f)}"
                 for name, f in zip(OPTIONS, flags))


def _beta_los(m, q, p2, x):
    """Line-of-sight velocity at chord coordinate x; the JAX package's
    rsqrt is written 1 / sqrt, correctly rounded in both versions."""
    return m * x + q * x * (1.0 / torch.sqrt(p2 + x * x))


@dataclass
class _Window:
    """One event's walked window [lo, hi) (walk-order line indices) and
    what its predicate reads, one entry a lane; ``row`` is the shell's
    offset in the flat prefix, ``c0`` the prefix at ``lo``."""

    fwd: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    row: torch.Tensor
    c0: torch.Tensor
    tau_event: torch.Tensor
    inv_chi: torch.Tensor
    x0: torch.Tensor
    p2: torch.Tensor
    m: torch.Tensor
    q: torch.Tensor
    nu: torch.Tensor

    def take(self, idx) -> "_Window":
        return _Window(*(getattr(self, f.name)[idx]
                         for f in dataclasses.fields(self)))

    def column(self) -> "_Window":
        """Each lane's entries as a column, against a row of samples."""
        return _Window(*(getattr(self, f.name)[:, None]
                         for f in dataclasses.fields(self)))


def _x_req(t: NonhomTables, w: _Window, i):
    """(d_req, x_req) of walk-order line ``i`` (clamped into the list): the
    distance the optical depth left after the line allows, and the chord
    coordinate it reaches, from the f64 prefix difference rounded to
    f32."""
    ic = torch.clamp(i, 0, t.n_lines - 1)
    c = torch.where(w.fwd, t.prefix.reshape(-1)[w.row + ic + 1],
                    t.rev_prefix.reshape(-1)[w.row + ic + 1])
    dC = (c - w.c0).float()
    d_req = (w.tau_event - dC) * w.inv_chi
    return d_req, torch.clamp(w.x0 + torch.clamp(d_req, min=0.0),
                              max=X_REQ_CAP)


def window_pred(t: NonhomTables, w: _Window, i):
    """The inverted event predicate of walk-order line ``i`` (clamped into
    the list): the line lies beyond the line-of-sight velocity at x_req, or
    the optical depth is spent."""
    L = t.n_lines
    ic = torch.clamp(i, 0, L - 1)
    d_req, x_req = _x_req(t, w, i)
    b_req = _beta_los(w.m, w.q, w.p2, x_req)
    nl = torch.where(w.fwd, t.line_nu[ic], t.line_nu[L - 1 - ic])
    n_row = 1.0 - nl / w.nu
    ahead = torch.where(w.fwd, n_row > b_req, n_row < b_req)
    return (d_req < 0.0) | ahead


def _bisect(t: NonhomTables, w: _Window, steps: int):
    """The first line of [lo, hi) whose predicate holds (hi if none),
    found by bisection: exact where the predicate is monotone."""
    a, b = w.lo.clone(), w.hi.clone()
    for _ in range(steps):
        active = a < b
        mid = (a + b) >> 1
        pred = window_pred(t, w, mid)
        a = torch.where(active & ~pred, mid + 1, a)
        b = torch.where(active & pred, mid, b)
    return a


def monotone_window(t: NonhomTables, w: _Window):
    """True where the predicate is proven monotone over the window [lo, hi)
    (lo < hi), so that the bisection finds the line the count search does.

    A row's x_req = x0 + max(d_req, 0), d_req = (tau_event - dC) / chi,
    falls (weakly) as the row's index rises, since dC rises with it, in f32
    too (rounding keeps order).  So every row the search evaluates has
    x_req in [a, b]: a the x_req of the window's last line, b that of its
    first.  n_row = 1 - nu_i / nu rises with the index
    forward (line_nu descends) and falls backward.  If beta_los is
    non-decreasing on [a, b] (forward) or non-increasing (backward),
    b_req(i) = beta_los(x_req(i)) moves against n_row, the test n_row >
    b_req (forward; < backward) once true stays true, d_req < 0 likewise,
    and the predicate is false, ..., false, true, ..., true.

    beta_los'(x) = m + q g(x), g(x) = p^2 / (p^2 + x^2)^(3/2) >= 0, which
    depends on |x| alone and falls as |x| grows.  Over [a, b], g takes
    every value between g(far) and g(near) (far = max(|a|, |b|), near = 0
    if the interval holds 0, else min(|a|, |b|)), and beta_los' is affine
    in g: its sign over the interval is its sign at those two ends.  Both
    >= 0 makes beta_los non-decreasing, both <= 0 non-increasing.  Taken
    in f64 (x^2 reaches 1e30); p^2 = 0 at near = 0 gives 0 / 0, NaN, which
    proves nothing.  The f32 evaluation of beta_los may still swap two
    rows' b_req by an ulp; the predicate can then part from monotone only
    at a line whose n_row lies within those ulps of b_req.  Where neither
    ordering is proven, the predicate may turn back (a shell whose
    velocity falls steeply outward, extrapolated past its boundary) and
    the count search takes the JAX package's line.  The interval is the
    window's own: [x0, x0 + tau_event / chi], which holds every x_req an
    event could give, would send most events of such a shell to the count
    search, as electron scattering is thin across a shell."""
    a = _x_req(t, w, w.hi - 1)[1].double()
    b = _x_req(t, w, w.lo)[1].double()
    near = torch.where((a <= 0.0) & (b >= 0.0), torch.zeros_like(a),
                       torch.minimum(a.abs(), b.abs()))
    far = torch.maximum(a.abs(), b.abs())
    p2, m, q = w.p2.double(), w.m.double(), w.q.double()

    def slope(x):
        s = p2 + x * x
        return m + q * (p2 / (s * torch.sqrt(s)))

    s_near, s_far = slope(near), slope(far)
    return torch.where(w.fwd, (s_near >= 0.0) & (s_far >= 0.0),
                       (s_near <= 0.0) & (s_far <= 0.0))


# the JAX package's search samples every TILE^2-th, then every TILE-th, then
# every line of the walk order (tardis_tpu/transport/tiled_search.py)
TILE = 128


def count_search(t: NonhomTables, w: _Window):
    """The line the JAX package's ``_nonhom_pred_search`` returns: three
    levels, each counting the samples whose predicate is false (a sample
    below ``lo`` counts as false, one at ``hi`` or beyond as true), 128
    samples every TILE^2 lines, then every TILE lines from the last coarse
    sample before the count, then every line of one tile.  Every level
    takes the exact prefix difference, where the JAX package's two coarse
    levels read the two-float pairs' hi parts: on a list whose prefix
    reaches 1e9 those part from the f64 predicate.  Equal to the first
    true index where the predicate is monotone."""
    L = t.n_lines
    t0 = -(-L // TILE)
    t1 = -(-t0 // TILE)
    k = torch.arange(TILE, device=w.lo.device)
    wc = w.column()

    def false_samples(base, stride):
        idx = base[:, None] + k[None, :] * stride
        held = (idx >= wc.lo) & ((idx >= wc.hi) | window_pred(t, wc, idx))
        return (~held).sum(1)

    c2 = false_samples(torch.zeros_like(w.lo), TILE * TILE)
    tile1 = torch.clamp(c2 - 1, 0, t1 - 1)
    c1 = false_samples(tile1 * TILE * TILE, TILE)
    tile0 = torch.clamp(tile1 * TILE + c1 - 1, 0, t0 - 1)
    c0 = false_samples(tile0 * TILE, 1)
    return torch.minimum(torch.maximum(tile0 * TILE + c0, w.lo), w.hi)


def _count_above(neg_nu, nu, right):
    """Lines with nu_i > nu (``right`` False) or nu_i >= nu (True)."""
    return torch.searchsorted(neg_nu, -nu, right=right)


def event_window(t: NonhomTables, r, mu, nu, shell, next_line, tau_event):
    """An event's trace (nonhomologous.py:268-320): the shell's velocity
    law along the chord, the boundary distance, the walk's direction from
    the comoving frequency at the boundary, and the walked window of line
    indices: forward [next_line, lines above nu_cmf at the boundary);
    backward, over the reversed order, from the reddest line above nu_cmf
    (with the margin) to the last line at or above the boundary
    frequency."""
    L = t.n_lines
    neg_nu = -t.line_nu
    r_in = t.r_inner[shell]
    r_out = t.r_outer[shell]
    m = t.m_grad[shell]
    b_in = t.beta_in[shell]
    q = b_in - m * r_in
    dop = 1.0 - mu * (b_in + m * (r - r_in))
    nu_cmf = nu * dop
    inv_chi = 1.0 / t.chi_e[shell]
    out_d = torch.sqrt(torch.clamp(
        r_out * r_out + (mu * mu - 1.0) * r * r, min=0.0)) - r * mu
    check = r_in * r_in + r * r * (mu * mu - 1.0)
    hits_inner = (mu < 0.0) & (check >= 0.0)
    in_d = -r * mu - torch.sqrt(torch.clamp(check, min=0.0))
    d_b = torch.clamp(torch.where(hits_inner, in_d, out_d), min=0.0)
    x0 = mu * r
    xb = x0 + d_b
    p2 = torch.clamp(r * r * (1.0 - mu * mu), min=0.0)
    nu_cmf_b = nu * (1.0 - _beta_los(m, q, p2, xb))
    fwd = nu_cmf_b <= nu_cmf

    lo_f = torch.clamp(next_line, 0, L)
    hi_f = torch.minimum(torch.maximum(
        _count_above(neg_nu, nu_cmf_b, right=False), lo_f),
        torch.full_like(lo_f, L))
    cnt_m = _count_above(neg_nu, nu_cmf * (1.0 + CLOSE_LINE_MARGIN),
                         right=False)
    j_end = torch.minimum(_count_above(neg_nu, nu_cmf_b, right=True), cnt_m)
    lo = torch.where(fwd, lo_f, L - cnt_m)
    hi = torch.where(fwd, hi_f, L - j_end)
    row = shell * (L + 1)
    c0 = torch.where(fwd, t.prefix.reshape(-1)[row + lo],
                     t.rev_prefix.reshape(-1)[row + lo])
    window = _Window(fwd=fwd, lo=lo, hi=hi, row=row, c0=c0,
                     tau_event=tau_event, inv_chi=inv_chi, x0=x0, p2=p2, m=m,
                     q=q, nu=nu)
    return SimpleNamespace(window=window, r_in=r_in, b_in=b_in, dop=dop,
                           nu_cmf=nu_cmf, d_b=d_b, xb=xb,
                           delta=torch.where(hits_inner, -1, 1), lo_f=lo_f,
                           cnt_m=cnt_m)


def nonhom_transport_loop_plain(t: NonhomTables, pool_mu, pool_nu, key,
                                nu_window=(0.0, np.inf),
                                batch_size: int = 65536,
                                max_events: int = MAX_EVENTS,
                                last_interaction: bool = False,
                                tracker_length: int = 0,
                                line_estimators: bool = True
                                ) -> TransportOutput:
    """Plain PyTorch version of K7: lockstep lanes refilled from the pool in
    packet-id order, the live lanes packed once the pool is spent and fewer
    than half are alive.  Per-packet outputs do not depend on
    ``batch_size``.  Each packet's event count is kept in ``events``, and
    the number of events whose line the count search took in
    ``count_search_events``."""
    device = pool_mu.device
    N = pool_mu.shape[0]
    S, L = t.n_shells, t.n_lines
    res = _allocate(N, S, L, 0, last_interaction, tracker_length, device,
                    line_estimators=line_estimators, events=True)
    nu_lo, nu_hi = _window(nu_window)
    reflective = t.inner_boundary_albedo > 0.0
    albedo = torch.tensor(t.inner_boundary_albedo, dtype=torch.float32,
                          device=device)
    cols = [COL_TAU, COL_MU] + ([COL_ALBEDO] if reflective else [])
    col = {c: i for i, c in enumerate(cols)}
    neg_nu = -t.line_nu
    pf = t.prefix.reshape(-1)
    pr = t.rev_prefix.reshape(-1)
    steps = int(np.ceil(np.log2(L + 1))) + 1
    B = max(1, min(batch_size, N))
    f32, i64 = torch.float32, torch.int64
    r_birth = t.r_inner[0]
    beta_birth = t.beta_in[0]
    birth = _count_above(neg_nu, pool_nu, right=True)
    kp_all = rng.fold_in(key, torch.arange(N, dtype=i64, device=device))

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
    next_unborn = n_events = n_immortal = n_counted = 0
    while True:
        if next_unborn < N:
            dead = ~alive
            new_ids = next_unborn + torch.cumsum(dead.long(), 0) - 1
            fill = dead & (new_ids < N)
            ids = torch.clamp(new_ids, max=N - 1)
            b_mu = pool_mu[ids]
            inv_dop = 1.0 / (1.0 - b_mu * beta_birth)
            r = torch.where(fill, r_birth, r)
            mu = torch.where(fill, b_mu, mu)
            nu = torch.where(fill, pool_nu[ids] * inv_dop, nu)
            energy = torch.where(fill, inv_dop, energy)
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

        ke = rng.fold_in((kp0, kp1), eidx)
        U = _draws(ke[0], ke[1], cols, device)
        tau_event = (-torch.log(U[:, col[COL_TAU]].double())).float()

        # ---- trace and the walked window
        tr = event_window(t, r, mu, nu, shell, next_line, tau_event)
        w = tr.window
        fwd, lo, hi, x0, xb, m = w.fwd, w.lo, w.hi, w.x0, tr.xb, w.m
        q, p2, inv_chi, d_b = w.q, w.p2, w.inv_chi, tr.d_b
        r_in, b_in, dop, nu_cmf = tr.r_in, tr.b_in, tr.dop, tr.nu_cmf
        lo_f, cnt_m, delta = tr.lo_f, tr.cnt_m, tr.delta

        def prefix_at(i):
            return torch.where(fwd, pf[w.row + i], pr[w.row + i])

        i_walk = _bisect(t, w, steps)
        # the JAX package's count search where the predicate may not be
        # monotone over the window (the two then differ)
        counted = alive & (lo < hi) & ~monotone_window(t, w)
        if bool(counted.any()):
            sel = counted.nonzero()[:, 0]
            i_walk[sel] = count_search(t, w.take(sel))
            n_counted += len(sel)
        found = i_walk < hi
        k_before = i_walk - lo
        i_ev = torch.clamp(torch.where(fwd, i_walk, L - 1 - i_walk), 0,
                           L - 1)
        tau_before = (prefix_at(i_walk) - w.c0).float()
        tau_total = (prefix_at(hi) - w.c0).float()

        # ---- the event line's distance: bisection of beta_los = n_ev
        n_ev = 1.0 - t.line_nu[i_ev] / nu
        lox, hix = x0, xb
        for _ in range(BISECTION_STEPS):
            xm = 0.5 * (lox + hix)
            f = _beta_los(m, q, p2, xm) - n_ev
            go_lo = torch.where(fwd, f < 0.0, f > 0.0)
            lox = torch.where(go_lo, xm, lox)
            hix = torch.where(go_lo, hix, xm)
        s_ev = torch.clamp(0.5 * (lox + hix) - x0, min=0.0)

        d_cont_f = torch.clamp((tau_event - tau_before) * inv_chi, min=0.0)
        escat_f = d_cont_f < s_ev
        if t.disable_line_scattering:
            escat_f = torch.ones_like(escat_f)
        d_cont_nf = torch.clamp((tau_event - tau_total) * inv_chi, min=0.0)
        escat_nf = d_cont_nf < d_b
        is_line = alive & found & ~escat_f
        is_escat = alive & torch.where(found, escat_f, escat_nf)
        is_boundary = alive & ~found & ~escat_nf
        distance = torch.where(found, torch.where(escat_f, d_cont_f, s_ev),
                               torch.where(escat_nf, d_cont_nf, d_b))
        k_crossed = torch.where(found, k_before + is_line.long(), hi - lo)

        # ---- estimators
        w_j = (energy * dop) * distance
        res.est_j.index_add_(0, shell[alive], w_j[alive].double())
        res.est_nubar.index_add_(0, shell[alive],
                                 (w_j * nu_cmf)[alive].double())
        rng_lo = torch.where(fwd, lo_f, cnt_m - k_crossed)
        rng_hi = torch.where(fwd, lo_f + k_crossed, cnt_m)
        if line_estimators:
            crossed = alive & (rng_lo != rng_hi)
            w1 = (energy / (nu * nu))[crossed].double()
            w2 = (energy / nu)[crossed].double()
            ia = (rng_lo[crossed] * S + shell[crossed]) * 2
            ib = (rng_hi[crossed] * S + shell[crossed]) * 2
            res.line_diff.index_add_(0, torch.cat([ia, ia + 1, ib, ib + 1]),
                                     torch.cat([w1, w2, -w1, -w2]))

        # ---- move
        r_new = torch.sqrt(torch.clamp(
            r * r + distance * distance + 2.0 * r * distance * mu,
            min=1e-20))
        mu_new = (mu * r + distance) / r_new

        # ---- interactions
        new_shell = shell + delta
        emitted = is_boundary & (new_shell >= S)
        hits_core = is_boundary & (new_shell < 0)
        if reflective:
            reflected = hits_core & (U[:, col[COL_ALBEDO]] < albedo)
        else:
            reflected = torch.zeros_like(hits_core)
        reabsorbed = hits_core & ~reflected
        mu_draw = 2.0 * U[:, col[COL_MU]] - 1.0
        beta_new = b_in + m * (r_new - r_in)
        dop_old_pos = 1.0 - mu_new * beta_new
        inv_dop_new = 1.0 / (1.0 - mu_draw * beta_new)
        em_line = i_ev
        if t.mode != LINE_SCATTER and bool(is_line.any()):
            sel = is_line.nonzero()[:, 0]
            em_line = i_ev.clone()
            em_line[sel] = macro_walk(t.walk, t.max_jumps, t.walk_steps,
                                      shell[sel], i_ev[sel], ke[0][sel],
                                      ke[1][sel])
        interacts = is_escat | is_line
        nu_new = torch.where(
            is_escat, nu * dop_old_pos * inv_dop_new,
            torch.where(is_line, t.line_nu[em_line] * inv_dop_new, nu))
        energy = torch.where(interacts, energy * dop_old_pos * inv_dop_new,
                             energy)
        next_line = torch.where(
            is_line, em_line + 1,
            torch.where(alive, torch.where(fwd, rng_hi, rng_lo), next_line))
        if last_interaction and bool(interacts.any()):
            res.last_interaction[pid[interacts]] = torch.stack(
                [torch.where(is_line, LI_LINE, LI_ESCAT).float(),
                 torch.where(is_line, i_ev, -1).float(),
                 torch.where(is_line, em_line, -1).float(),
                 shell.float(), nu, r_new], dim=1)[interacts]
        r = torch.where(alive, r_new, r)
        mu_after = torch.where(interacts, mu_draw, mu_new)
        mu = torch.where(alive, torch.where(reflected, -mu_after, mu_after),
                         mu)
        shell = torch.where(is_boundary & ~emitted & ~hits_core, new_shell,
                            shell)
        if tracker_length:
            slot = alive & (eidx < tracker_length)
            code = torch.where(is_line, LI_LINE, torch.where(
                is_escat, LI_ESCAT, EV_BOUNDARY_CODE)).float()
            res.tracker[pid[slot], eidx[slot]] = torch.stack(
                [r, nu_new, energy, shell.float(), code,
                 torch.zeros_like(r)], dim=1)[slot]

        dying = emitted | reabsorbed
        n_events += n_alive
        if bool(dying.any()):
            dpid = pid[dying]
            res.out[dpid, 0] = torch.where(emitted, nu, -nu)[dying]
            res.out[dpid, 1] = energy[dying]
            res.events[dpid] = (eidx[dying] + 1).int()
            in_window = emitted & (nu > nu_lo) & (nu < nu_hi)
            res.summary[0] += energy[in_window].double().sum()
            res.summary[1] += energy[reabsorbed].double().sum()
        nu = nu_new
        alive = alive & ~dying
        eidx = eidx + 1
    res.summary[2] = n_events
    res.summary[3] = n_immortal
    res.count_search_events = n_counted
    return res


def nonhom_transport_loop(t: NonhomTables, pool_mu, pool_nu, key,
                          nu_window=(0.0, np.inf),
                          max_events: int = MAX_EVENTS,
                          last_interaction: bool = False,
                          tracker_length: int = 0,
                          line_estimators: bool = True) -> TransportOutput:
    """K7 on the card; the plain version for CPU tensors.  The options
    select K7's compiled instantiation (``variant``); ``line_estimators``
    False skips the line difference array (``line_diff`` empty).  On the
    card K7 is one launch of a persistent grid whose lanes take packet ids
    from a queue and refill as soon as a packet ends."""
    device = pool_mu.device
    if device.type == "cpu":
        return nonhom_transport_loop_plain(
            t, pool_mu, pool_nu, key, nu_window, max_events=max_events,
            last_interaction=last_interaction, tracker_length=tracker_length,
            line_estimators=line_estimators)
    if device.type != "cuda":
        raise ValueError(f"nonhom_transport_loop: unsupported device {device}")
    f32, i32 = torch.float32, torch.int32
    N = pool_mu.shape[0]
    S, L = t.n_shells, t.n_lines
    w = t.walk
    walk_args = {}
    if w is not None:
        walk_args = dict(cum_prob=(w.cum_prob, f32),
                         block_start=(w.block_start, i32), dest=(w.dest, i32),
                         emit=(w.emit, torch.bool), line=(w.line, i32),
                         line2macro=(w.line2macro, i32))
    cuda.check_cuda(
        "nonhom_transport_loop", device, pool_mu=(pool_mu, f32),
        pool_nu=(pool_nu, f32), r_inner=(t.r_inner, f32),
        r_outer=(t.r_outer, f32), beta_in=(t.beta_in, f32),
        m_grad=(t.m_grad, f32), chi_e=(t.chi_e, f32),
        line_nu=(t.line_nu, f32), prefix=(t.prefix, torch.float64),
        rev_prefix=(t.rev_prefix, torch.float64), **walk_args)
    if (pool_mu.shape != (N,) or pool_nu.shape != (N,)
            or t.prefix.shape != (S, L + 1)
            or t.rev_prefix.shape != (S, L + 1)
            or (w is not None and (
                w.cum_prob.shape[1] != S or w.line2macro.shape != (L,)
                or w.dest.shape[0] != w.cum_prob.shape[0]))):
        raise ValueError("nonhom_transport_loop: table shapes do not agree")
    flags = variant(t, last_interaction, tracker_length, line_estimators)
    res = _allocate(N, S, L, 0, last_interaction, tracker_length, device,
                    line_estimators=line_estimators)
    nu_lo, nu_hi = _window(nu_window)
    fn = cuda.function("nonhom_loop", "nonhom_loop", _ARGTYPES,
                       library_defines(flags))
    p = cuda.ptr
    # the lanes' packet queue: the next packet id to take
    taken = torch.zeros(1, dtype=torch.int64, device=device)

    def walk_ptr(name):
        return None if w is None else p(getattr(w, name))

    launch_args = (
        p(pool_mu), p(pool_nu), N, p(t.r_inner), p(t.r_outer),
        p(t.beta_in), p(t.m_grad), p(t.chi_e), p(t.line_nu), p(t.prefix),
        p(t.rev_prefix),
        walk_ptr("line2macro"), walk_ptr("cum_prob"),
        walk_ptr("block_start"), walk_ptr("dest"), walk_ptr("emit"),
        walk_ptr("line"), L, S, t.max_jumps,
        int(t.disable_line_scattering), key[0], key[1], nu_lo, nu_hi,
        float(t.inner_boundary_albedo), max_events, p(res.out),
        p(res.est_j), p(res.est_nubar),
        p(res.line_diff) if line_estimators else None, p(res.summary),
        p(res.last_interaction), p(res.tracker), tracker_length, p(taken),
        cuda.stream(),
    )
    with tracing.launch(nonhom_transport_loop, variant_name(flags)):
        err = fn(*launch_args)
        cuda.check_launch("nonhom_transport_loop", err)
    return res


nonhom_transport_loop.launches_by_variant = {}  # launches by variant_name

_VP, _I64, _CI, _CF = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_float)
_ARGTYPES = ([_VP, _VP, _I64] + [_VP] * 14 + [_I64] + [_CI] * 3
             + [ctypes.c_uint32, ctypes.c_uint32, _CF, _CF, _CF, _I64]
             + [_VP] * 7 + [_CI, _VP, _VP])
