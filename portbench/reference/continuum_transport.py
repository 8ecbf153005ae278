"""Monte Carlo transport of the Type IIP workflow: the relativistic packet
pool and the fully relativistic event loop with bound-free and free-free
opacity and the continuum macro atom, with last-interaction rows.

Units as ``transport.py``: lengths / (c t_exp), frequencies / NU_UNIT,
energies in packet birth units.  Packet p's random numbers come from
``uniform(fold_in(fold_in(key, p), event), col)`` in [1e-9, 1): columns
0 tau, 1 mu, 2 Thomson / continuum split, 3 bound-free / free-free split,
4 the continuum picked, 6 the absorbing state, 7 the deactivation
channel, 8 the free-bound frequency, 9 the free-free frequency.  Per
event:

1. the comoving frequency under full relativity, dop = (1 - mu r) gamma;
   chi = chi_e + chi_bf + chi_ff in the comoving frame (chi_bf summed over
   the continua left to right on the merged bound-free grid, chi_ff with
   its stimulated-emission factor), times dop;
2. the distance to the shell boundary, and the event line by a bisection
   of [next_line, L] on the resonance quadratic;
3. the j and nu-bar estimators (energy dop times path dop, and times
   comoving nu), the continuum estimators' moments [w, w / nu, w nu, wb,
   wb / nu, wb nu, 1] on the packet's grid cell (b = e^{-h nu / k T_e})
   and the free-free heating w chi_ff;
4. the move, then a boundary crossing, a Thomson scatter (probability
   chi_e / chi of a continuous event), a continuum process or a line
   absorption; the latter two activate the macro atom (a line's upper
   level, a bound-free continuum's i-packet state, or the k-packet after
   free-free), which picks its absorbing state and deactivation channel
   and emits a line, a free-bound or a free-free photon;
5. death at the outer (emitted, +nu) or inner (reabsorbed, -nu) boundary.

``transport`` runs the packets it is given (any ids of the pool) in
lockstep lanes, packed together whenever fewer than half are alive; a
packet alive after ``max_events`` events is left unfinished (its events
-1), so a sample of the pool can be run with a cap.
"""

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference import rng
from portbench.reference.constants import C, H, K_B, NU_UNIT
from portbench.reference.continuum import FF_OPAC_CONST
from portbench.reference.continuum_macro import EMIT_BF, EMIT_LINE

U_MIN = 1e-9
GAMMA_FLOOR = 1e-12
COLS = (0, 1, 6, 7, 2, 3, 4, 8, 9)
TAU, MU, CHAIN, EMIT, ESCAT, BFFF, SEL, FB, FF = range(9)
LI_ESCAT, LI_LINE, LI_CONTPROC = 1, 2, 3
REL_MU_FOLD = 7
F32 = np.float32
_L_ARRAY = np.cumsum(np.arange(1, 1000, dtype=np.float64) ** -4).astype(F32)
_L_COEF = F32(np.pi**4 / 90.0)


@dataclass
class Tables:
    r_inner: torch.Tensor  # (S,) f32
    r_outer: torch.Tensor
    chi_e: torch.Tensor  # (S,) f32
    line_nu: torch.Tensor  # (L,) f32
    prefix: torch.Tensor  # (S, L + 1)
    grid_nu: torch.Tensor  # (Ng,) f32
    xsect: torch.Tensor  # (Ng, C) f32
    coef_a: torch.Tensor  # (C * S,) f32
    coef_b: torch.Tensor
    boltz_coef: torch.Tensor  # (S,) f32
    ff_coef: torch.Tensor
    cum_b: torch.Tensor  # (S * M, M) f32
    deact_start: torch.Tensor  # (M + 1,)
    deact_cum: torch.Tensor  # (D * S,) f32
    deact_kind: torch.Tensor
    deact_id: torch.Tensor
    line2state: torch.Tensor
    photo_ion_state: torch.Tensor
    fb_cdf: torch.Tensor  # (P * S,) f32
    fb_nu: torch.Tensor  # (P,) f32
    pion_start: torch.Tensor  # (C + 1,)
    k_state: int
    deact_steps: int
    fb_steps: int


def continuum_grid(pi, edge_eps=1e-6):
    """The merged bound-free grid (ascending Hz) and each continuum's
    cross-section on it, with sentinel knots just outside each support so
    that interpolation on the grid keeps every threshold hard."""
    refs = pi["block_references"]
    th, mx = pi["nu"][refs[:-1]], pi["nu"][refs[1:] - 1]
    lo, hi = pi["nu"].min(), pi["nu"].max()
    grid = np.unique(np.concatenate([
        pi["nu"], th * (1.0 - edge_eps), mx * (1.0 + edge_eps),
        np.array([lo * 0.5, lo * 0.75, hi * 1.5, hi * 2.0])]))
    xs = np.zeros((len(grid), len(th)))
    for c in range(len(th)):
        a, b = refs[c], refs[c + 1]
        nus = np.concatenate([[th[c] * (1.0 - edge_eps)], pi["nu"][a:b],
                              [mx[c] * (1.0 + edge_eps)]])
        vals = np.concatenate([[0.0], pi["x_sect"][a:b], [0.0]])
        xs[:, c] = np.interp(grid, nus, vals, left=0.0, right=0.0)
    return grid, xs


def _steps(block_start) -> int:
    return int(np.ceil(np.log2(int(np.max(np.diff(block_start))) + 1))) + 1


def build_tables(model, atoms, n_e, prefix, cs, macro, device) -> Tables:
    from portbench.reference.constants import SIGMA_THOMSON

    ct = C * model.time_explosion
    pi = atoms.photo_ion
    grid, xs = continuum_grid(pi)

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(
            np.asarray(a, np.float32).reshape(-1)), device=device)

    def i64(a):
        return torch.as_tensor(np.asarray(a, np.int64).reshape(-1),
                               device=device)

    M = macro.n_states
    return Tables(
        r_inner=f32(model.r_inner / ct), r_outer=f32(model.r_outer / ct),
        chi_e=f32(SIGMA_THOMSON * np.asarray(n_e) * ct),
        line_nu=f32(atoms.line_nu / NU_UNIT),
        prefix=prefix,
        grid_nu=f32(grid / NU_UNIT), xsect=f32(xs).view(len(grid), -1),
        coef_a=f32(cs.level_pop * ct), coef_b=f32(cs.lte_pop_coef * ct),
        boltz_coef=f32(H * NU_UNIT / (K_B * cs.t_electrons)),
        ff_coef=f32(FF_OPAC_CONST * cs.ff_opacity_factor * ct / NU_UNIT**3),
        cum_b=f32(macro.cum_B).view(-1, M),
        deact_start=i64(macro.deact_block_start),
        deact_cum=f32(macro.deact_cum_prob),
        deact_kind=i64(macro.deact_kind), deact_id=i64(macro.deact_id),
        line2state=i64(macro.line2state),
        photo_ion_state=i64(macro.photo_ion_state),
        fb_cdf=f32(cs.fb_emission_cdf), fb_nu=f32(pi["nu"] / NU_UNIT),
        pion_start=i64(pi["block_references"]), k_state=macro.k_state,
        deact_steps=_steps(macro.deact_block_start),
        fb_steps=_steps(pi["block_references"]))


def relativistic_pool(key, ids, t_inner, beta_inner, device):
    """Bjorkman & Wood (2001) blackbody frequencies from columns 0-4 of
    fold_in(key, p), mu = -beta + sqrt(beta^2 + 2 beta z + z) with z the
    first draw of fold_in(fold_in(key, p), 7), and the constant weight
    (2 beta + 1) / (1 - beta^2) / gamma; f32, nu / NU_UNIT."""
    def t32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    k = rng.fold_in(key, ids)
    xi = rng.uniform(rng.bits((k[0][:, None], k[1][:, None]),
                              torch.arange(5, device=device)[None, :]))
    l_min = (torch.searchsorted(torch.as_tensor(_L_ARRAY, device=device),
                                xi[:, 0] * float(_L_COEF)) + 1).float()
    prod = torch.clamp(((xi[:, 1] * xi[:, 2]) * xi[:, 3]) * xi[:, 4],
                       min=1e-37)
    x = (-torch.log(prod.double())).float() / l_min
    nu_coef = (F32(K_B) * F32(t_inner)) / F32(H)
    nu = (x * float(nu_coef)) / t32(NU_UNIT)
    beta = F32(beta_inner)
    bb = F32(beta * beta)
    gamma = F32(F32(1.0) / F32(np.sqrt(F32(F32(1.0) - bb))))
    w = F32(F32(F32(F32(2.0) * beta) + F32(1.0)) / F32(F32(1.0) - bb))
    z = rng.uniform(rng.bits(rng.fold_in(k, REL_MU_FOLD), 0))
    mu = -t32(beta) + torch.sqrt((t32(bb) + t32(2.0 * beta) * z) + z)
    return mu, nu, torch.full_like(mu, float(F32(w / gamma)))


def _gamma(r):
    return 1.0 / torch.sqrt(torch.clamp(1.0 - r * r, min=GAMMA_FLOOR))


def _resonance(nu_line, nu, z, p2):
    a = nu_line * nu_line
    b = nu * nu
    disc = torch.clamp(a * (a - (a + b) * p2), min=0.0)
    y = (b - torch.sqrt(disc)) / (a + b)
    return torch.clamp(y - z, min=0.0)


def _event_line(t, shell, lo, chi, z, nu, tau, nu_thresh, c0, p2):
    L = t.line_nu.shape[0]
    flat = t.prefix.reshape(-1)
    hi = torch.full_like(lo, L)
    for _ in range(int(np.ceil(np.log2(L + 1))) + 1):
        active = lo < hi
        mid = (lo + hi) >> 1
        i = torch.clamp(mid, max=L - 1)
        depth = ((flat[shell * (L + 1) + i + 1] - c0).float()
                 + chi * _resonance(t.line_nu[i], nu, z, p2))
        fire = (t.line_nu[i] <= nu_thresh) | (depth > tau)
        lo = torch.where(active & ~fire, mid + 1, lo)
        hi = torch.where(active & fire, mid, hi)
    return lo


def _lower_bound(values, idx_of, lo, hi, u, steps):
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        below = values[idx_of(torch.minimum(mid, hi - 1).clamp(min=0))] < u
        lo = torch.where(active & below, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)
    return lo


def _opacity(t, S, shell, nu_cmf):
    Ng, Cn = t.xsect.shape
    gcell = torch.clamp(torch.searchsorted(t.grid_nu, nu_cmf, right=True)
                        - 1, 0, Ng - 2)
    g0 = t.grid_nu[gcell]
    dg = t.grid_nu[gcell + 1] - g0
    frac = torch.clamp((nu_cmf - g0) / torch.clamp(dg, min=1e-30), 0.0, 1.0)
    boltz = torch.exp(-(nu_cmf * t.boltz_coef[shell]).double()).float()
    x0, x1 = t.xsect[gcell], t.xsect[gcell + 1]
    ab = torch.arange(Cn, device=shell.device)[None, :] * S + shell[:, None]
    term = torch.clamp((x0 + frac[:, None] * (x1 - x0))
                       * (t.coef_a[ab] - t.coef_b[ab] * boltz[:, None]),
                       min=0.0)
    cum, running = [], torch.zeros_like(frac)
    for k in range(Cn):
        running = running + term[:, k]
        cum.append(running)
    nuc = torch.clamp(nu_cmf, min=1e-30)
    chi_ff = t.ff_coef[shell] / ((nuc * nuc) * nuc) * (1.0 - boltz)
    return gcell, boltz, cum, chi_ff


def _deactivate(t, S, shell, is_line, i_ev, cum, chi_ff, bcoef, U):
    """The macro atom's emission: (kind, line, comoving nu, next line)."""
    L = t.line_nu.shape[0]
    Cn = t.xsect.shape[1]
    M = t.cum_b.shape[1]
    chi_bf = cum[-1]
    is_bf = U[:, BFFF] < chi_bf / torch.clamp(chi_bf + chi_ff, min=1e-30)
    u_sel = U[:, SEL] * chi_bf
    c_sel = torch.zeros_like(shell)
    for run in cum:
        c_sel += (run < u_sel).long()
    c_sel = torch.clamp(c_sel, max=Cn - 1)
    state0 = torch.where(is_line, t.line2state[torch.clamp(i_ev, max=L - 1)],
                         torch.where(is_bf, t.photo_ion_state[c_sel],
                                     t.k_state))
    row = t.cum_b[shell * M + state0]
    a = torch.clamp((row < U[:, CHAIN][:, None]).sum(1), max=M - 1)
    b0, b1 = t.deact_start[a], t.deact_start[a + 1]
    ch = _lower_bound(t.deact_cum, lambda i: i * S + shell, b0, b1,
                      U[:, EMIT], t.deact_steps)
    ch = torch.minimum(torch.maximum(ch, b0), torch.maximum(b1 - 1, b0))
    kind, chan = t.deact_kind[ch], t.deact_id[ch]
    em_line = torch.clamp(chan, 0, L - 1)
    # free-bound: inverse interpolation of the continuum's emission CDF
    u = U[:, FB]
    cc = torch.clamp(chan, 0, Cn - 1)
    p0, p1 = t.pion_start[cc], t.pion_start[cc + 1]
    idx = _lower_bound(t.fb_cdf, lambda i: i * S + shell, p0, p1, u,
                       t.fb_steps)
    idx = torch.minimum(torch.maximum(idx, p0 + 1), torch.maximum(p1 - 1,
                                                                  p0 + 1))
    cdf_i, cdf_m = t.fb_cdf[idx * S + shell], t.fb_cdf[(idx - 1) * S + shell]
    gap = cdf_i > cdf_m
    w = torch.where(gap, (cdf_i - u) / torch.where(gap, cdf_i - cdf_m, 1.0),
                    0.0)
    nu_fb = t.fb_nu[idx] - w * (t.fb_nu[idx] - t.fb_nu[idx - 1])
    nu_ff = (-torch.log(U[:, FF].double())).float() / bcoef
    nu_em = torch.where(kind == EMIT_LINE, t.line_nu[em_line],
                        torch.where(kind == EMIT_BF, nu_fb, nu_ff))
    nxt = torch.where(kind == EMIT_LINE, em_line + 1,
                      torch.searchsorted(-t.line_nu, -nu_em, right=True))
    return em_line, nu_em, nxt


@dataclass
class Transported:
    ids: torch.Tensor  # (K,) the packets run
    out: torch.Tensor  # (K, 2) f32 signed nu, energy
    last: torch.Tensor  # (K, 6) f32
    events: torch.Tensor  # (K,) -1 where left unfinished
    est_j: torch.Tensor  # (S,)
    est_nubar: torch.Tensor
    moments: torch.Tensor  # ((Ng - 1) * S, 8)
    ff_heat: torch.Tensor  # (S,)
    emitted: float
    reabsorbed: float


def transport(t: Tables, pool_mu, pool_nu, pool_w, ids, key,
              max_events: int = 500_000, est_dtype=torch.float64,
              check_every: int = 16):
    """The packets ``ids`` (with their pool entries) under loop key
    ``key``.  Dead lanes step on, masked out of every sum and row, so the
    host reads the lanes' state only every ``check_every`` events (to pack
    the live lanes together and to stop)."""
    device = pool_mu.device
    K = ids.shape[0]
    S, L = t.r_inner.shape[0], t.line_nu.shape[0]
    f32, f64 = torch.float32, est_dtype
    out = torch.zeros((K, 2), dtype=f32, device=device)
    last = torch.zeros((K, 6), dtype=f32, device=device)
    events = torch.full((K,), -1, dtype=torch.int64, device=device)
    est_j = torch.zeros(S, dtype=f64, device=device)
    est_nubar = torch.zeros(S, dtype=f64, device=device)
    Ng = t.grid_nu.shape[0]
    moments = torch.zeros(((Ng - 1) * S, 8), dtype=f64, device=device)
    ff_heat = torch.zeros(S, dtype=f64, device=device)
    flat_m = moments.view(-1)
    lum = torch.zeros(2, dtype=f64, device=device)
    cols = torch.tensor(COLS, dtype=torch.int64, device=device)[None, :]
    seven = torch.arange(7, device=device)
    u_lo = torch.tensor(U_MIN, dtype=f32, device=device)
    u_span = torch.tensor(1.0, dtype=f32, device=device) - u_lo
    flat = t.prefix.reshape(-1)

    beta_inner = t.r_inner[0]
    gamma_in = 1.0 / torch.sqrt(1.0 - beta_inner * beta_inner)
    inv_dop = (1.0 + pool_mu * beta_inner) * gamma_in
    mu = (pool_mu + beta_inner) / (1.0 + beta_inner * pool_mu)
    nu = pool_nu * inv_dop
    energy = inv_dop * pool_w
    r = beta_inner.expand(K).clone()
    shell = torch.zeros(K, dtype=torch.int64, device=device)
    next_line = torch.searchsorted(-t.line_nu, -pool_nu, right=True)
    lane = torch.arange(K, device=device)
    kp0, kp1 = rng.fold_in(key, ids)
    eidx = torch.zeros_like(shell)
    alive = torch.ones(K, dtype=torch.bool, device=device)
    step = 0
    while True:
        if step % check_every == 0:
            n_alive = int(alive.sum())
            if n_alive == 0:
                break
            if 2 * n_alive < alive.shape[0]:
                keep = alive.nonzero()[:, 0]
                r, mu, nu, energy, shell, next_line, lane, eidx, kp0, kp1, \
                    alive = (x[keep] for x in (r, mu, nu, energy, shell,
                                               next_line, lane, eidx, kp0,
                                               kp1, alive))
        step += 1
        alive = alive & (eidx < max_events)
        ke = rng.fold_in((kp0, kp1), eidx)
        f = ((rng.bits((ke[0][:, None], ke[1][:, None]), cols) >> 9)
             | 0x3F800000).to(torch.int32).view(f32) - 1.0
        U = torch.maximum(u_lo, f * u_span + u_lo)
        tau = (-torch.log(U[:, TAU].double())).float()
        chi_e = t.chi_e[shell]
        r_in, r_out = t.r_inner[shell], t.r_outer[shell]
        z = mu * r
        dop = (1.0 - z) * _gamma(r)
        nu_cmf = nu * dop
        bcoef = t.boltz_coef[shell]
        gcell, boltz, cum, chi_ff = _opacity(t, S, shell, nu_cmf)
        chi = chi_e + cum[-1] + chi_ff
        escat_prob = chi_e / torch.clamp(chi, min=1e-30)
        chi = chi * dop
        out_d = torch.sqrt(torch.clamp(
            r_out * r_out + (mu * mu - 1.0) * r * r, min=0.0)) - r * mu
        check = r_in * r_in + r * r * (mu * mu - 1.0)
        hits_inner = (mu < 0.0) & (check >= 0.0)
        in_d = -r * mu - torch.sqrt(torch.clamp(check, min=0.0))
        d_b = torch.clamp(torch.where(hits_inner, in_d, out_d), min=0.0)
        delta = torch.where(hits_inner, -1, 1)
        c0 = flat[shell * (L + 1) + next_line]
        p2 = torch.clamp((r * r) * (1.0 - mu * mu), min=0.0)
        rb2 = (r * r + d_b * d_b) + ((2.0 * r) * d_b) * mu
        nu_thresh = (nu * (1.0 - (z + d_b))) / torch.sqrt(
            torch.clamp(1.0 - rb2, min=GAMMA_FLOOR))
        i_ev = _event_line(t, shell, next_line.clone(), chi, z, nu, tau,
                           nu_thresh, c0, p2)
        in_range = i_ev < L
        nu_ev = torch.where(in_range, t.line_nu[torch.clamp(i_ev, max=L - 1)],
                            -torch.inf)
        found = in_range & (nu_ev > nu_thresh)
        s_ev = _resonance(nu_ev, nu, z, p2)
        tau_at = (flat[shell * (L + 1) + i_ev] - c0).float()
        d_cont = torch.clamp((tau - tau_at) / chi, min=0.0)
        escat_f = d_cont < s_ev
        escat_nf = d_cont < d_b
        is_line = alive & found & ~escat_f
        is_cont = alive & torch.where(found, escat_f, escat_nf)
        is_boundary = alive & ~found & ~escat_nf
        distance = torch.where(found, torch.where(escat_f, d_cont, s_ev),
                               torch.where(escat_nf, d_cont, d_b))
        end_line = torch.where(is_line, i_ev + 1, i_ev)

        w_j = torch.where(alive, (energy * dop) * (distance * dop), 0.0)
        est_j.index_add_(0, shell, w_j.to(f64))
        est_nubar.index_add_(0, shell, torch.where(alive, w_j * nu_cmf,
                                                   0.0).to(f64))
        inv_nu = 1.0 / torch.clamp(nu_cmf, min=1e-30)
        wb = w_j * boltz
        m = torch.stack([w_j, w_j * inv_nu, w_j * nu_cmf, wb, wb * inv_nu,
                         wb * nu_cmf, alive.to(f32)], dim=1)
        m = torch.where(alive[:, None], m, 0.0)
        base = (gcell * S + shell) * 8
        flat_m.index_add_(0, (base[:, None] + seven).reshape(-1),
                          m.reshape(-1).to(f64))
        ff_heat.index_add_(0, shell, torch.where(alive, w_j * chi_ff,
                                                 0.0).to(f64))

        r_new = torch.sqrt(torch.clamp(
            r * r + distance * distance + 2.0 * r * distance * mu,
            min=1e-20))
        mu_new = (mu * r + distance) / r_new
        is_proc = is_cont & (U[:, ESCAT] >= escat_prob)
        is_escat = is_cont & ~is_proc
        new_shell = shell + delta
        emitted_now = is_boundary & (new_shell >= S)
        reabsorbed_now = is_boundary & (new_shell < 0)
        mu_draw = 2.0 * U[:, MU] - 1.0
        gamma_new = _gamma(r_new)
        dop_old = (1.0 - mu_new * r_new) * gamma_new
        inv_dop_new = (1.0 + mu_draw * r_new) * gamma_new
        mu_emit = (mu_draw + r_new) / (1.0 + r_new * mu_draw)
        absorbs = is_line | is_proc
        em_line, nu_em, next_em = _deactivate(t, S, shell, is_line, i_ev, cum,
                                              chi_ff, bcoef, U)
        interacts = is_escat | absorbs
        nu_new = torch.where(is_escat, nu * dop_old * inv_dop_new,
                             torch.where(absorbs, nu_em * inv_dop_new, nu))
        energy = torch.where(interacts, energy * dop_old * inv_dop_new,
                             energy)
        next_line = torch.where(absorbs, next_em,
                                torch.where(alive, end_line, next_line))
        row = torch.stack(
            [torch.where(is_line, LI_LINE, torch.where(
                is_proc, LI_CONTPROC, LI_ESCAT)).float(),
             torch.where(is_line, i_ev, -1).float(),
             torch.where(is_line, em_line, -1).float(),
             shell.float(), nu, r_new], dim=1)
        last[lane] = torch.where(interacts[:, None], row, last[lane])
        r = torch.where(alive, r_new, r)
        mu = torch.where(interacts, mu_emit,
                         torch.where(alive, mu_new, mu))
        shell = torch.where(is_boundary & ~emitted_now & ~reabsorbed_now,
                            new_shell, shell)
        dying = emitted_now | reabsorbed_now
        dead_row = torch.stack([torch.where(emitted_now, nu, -nu), energy], 1)
        out[lane] = torch.where(dying[:, None], dead_row, out[lane])
        events[lane] = torch.where(dying, eidx + 1, events[lane])
        lum += torch.stack([
            torch.where(emitted_now, energy, 0.0).to(f64).sum(),
            torch.where(reabsorbed_now, energy, 0.0).to(f64).sum()])
        nu = nu_new
        alive = alive & ~dying
        eidx = eidx + 1
    lum = lum.cpu()
    return Transported(ids=ids, out=out, last=last, events=events,
                       est_j=est_j, est_nubar=est_nubar, moments=moments,
                       ff_heat=ff_heat, emitted=float(lum[0]),
                       reabsorbed=float(lum[1]))
