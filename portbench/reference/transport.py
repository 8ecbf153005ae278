"""Monte Carlo transport of one iteration: the blackbody packet pool and the
event loop of homologous TARDIS transport in the macro-atom mode, with
last-interaction rows.

Units: lengths / (c t_exp), frequencies / NU_UNIT, energies in packet
birth units.  The state of a packet is f32 and each of its random numbers
comes from ``uniform(fold_in(fold_in(key, packet), event), col)``, columns
0 tau, 1 mu, 6 chain row, 7 emission row, in [1e-9, 1).  Per event:

1. the distance to the shell boundary (inward only for mu < 0 with a
   real intersection);
2. the event line: the first line i >= next_line whose resonance lies
   past the boundary or whose optical depth from next_line,
   [P(i + 1) - P(next_line)] + chi_e s(i), s(i) = max(1 - nu_i / nu - mu r,
   0), exceeds tau = -ln u0 (a bisection over [next_line, L]);
3. j and nu-bar estimators (energy times path, and times comoving nu);
4. the move, then a boundary crossing, a Thomson scatter or a line
   absorption, after which the macro atom's chain tables pick the
   deactivating level and its emission line;
5. death at the outer (emitted, +nu) or inner (reabsorbed, -nu) boundary.

The loop runs a fixed number of lanes in lockstep on the device of the
tables, refilling dead lanes from the pool in packet order, so each
packet's result does not depend on the lane count.
"""

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference import rng
from portbench.reference.constants import H, K_B, NU_UNIT

U_MIN = 1e-9
COL_TAU, COL_MU, COL_CHAIN, COL_EMIT = 0, 1, 6, 7
LI_ESCAT, LI_LINE = 1, 2
MAX_EVENTS = 500_000

_L_SAMPLES = 1000
F32 = np.float32


@dataclass
class Tables:
    r_inner: torch.Tensor  # (S,) f32
    r_outer: torch.Tensor
    chi_e: torch.Tensor  # (S,) f32 Thomson opacity * c t_exp
    line_nu: torch.Tensor  # (L,) f32 / NU_UNIT, descending
    prefix: torch.Tensor  # (S, L + 1) tau prefix
    line2macro: torch.Tensor  # (L,) activated level of each line
    chain_cdf: torch.Tensor  # (S * M, W + 1) f32
    emit_cdf: torch.Tensor  # (S * M, 3 We) f32
    M: int
    W: int
    We: int


@dataclass
class Transported:
    out: torch.Tensor  # (N, 2) f32 signed nu, energy
    last: torch.Tensor  # (N, 6) f32 [type, in_line, out_line, shell, nu, r]
    est_j: torch.Tensor  # (S,)
    est_nubar: torch.Tensor  # (S,)
    emitted: float  # energy emitted (birth units)
    reabsorbed: float
    events: int
    unfinished: int


def packet_pool(key, n: int, t_inner: float, device):
    """Bjorkman & Wood (2001) blackbody frequencies from columns 0-4 and
    mu = sqrt(column 5), f32, nu / NU_UNIT."""
    pid = torch.arange(n, dtype=torch.int64, device=device)
    k = rng.fold_in(key, pid)
    cols = torch.arange(6, dtype=torch.int64, device=device)[None, :]
    xi = rng.uniform(rng.bits((k[0][:, None], k[1][:, None]), cols))
    l_array = torch.as_tensor(np.cumsum(
        np.arange(1, _L_SAMPLES, dtype=np.float64) ** -4).astype(F32),
        device=device)
    l_coef = float(F32(np.pi**4 / 90.0))
    l_min = (torch.searchsorted(l_array, xi[:, 0] * l_coef) + 1).to(
        torch.float32)
    prod = torch.clamp(((xi[:, 1] * xi[:, 2]) * xi[:, 3]) * xi[:, 4],
                       min=1e-37)
    x = (-torch.log(prod.double())).float() / l_min
    nu_coef = float((F32(K_B) * F32(t_inner)) / F32(H))
    nu = (x * nu_coef) / torch.tensor(NU_UNIT, dtype=torch.float32,
                                      device=device)
    return torch.sqrt(xi[:, 5]), nu


def _draws(k0, k1, device):
    c = torch.tensor([COL_TAU, COL_MU, COL_CHAIN, COL_EMIT],
                     dtype=torch.int64, device=device)[None, :]
    return rng.uniform(rng.bits((k0[:, None], k1[:, None]), c), U_MIN, 1.0)


def _event_line(t: Tables, shell, lo, chi, z, nu, tau, nu_thresh, c0):
    """First i in [lo, L] with i == L, nu_i <= nu_thresh or depth > tau."""
    L = t.line_nu.shape[0]
    flat = t.prefix.reshape(-1)
    hi = torch.full_like(lo, L)
    for _ in range(int(np.ceil(np.log2(L + 1))) + 1):
        active = lo < hi
        mid = (lo + hi) >> 1
        i = torch.clamp(mid, max=L - 1)
        s = torch.clamp((1.0 - t.line_nu[i] / nu) - z, min=0.0)
        depth = (flat[shell * (L + 1) + i + 1] - c0).float() + chi * s
        fire = (t.line_nu[i] <= nu_thresh) | (depth > tau)
        lo = torch.where(active & ~fire, mid + 1, lo)
        hi = torch.where(active & fire, mid, hi)
    return lo


def _emission(t: Tables, shell, i_ev, u_chain, u_emit):
    L = t.line_nu.shape[0]
    j = t.line2macro[torch.clamp(i_ev, max=L - 1)].long()
    row = t.chain_cdf[shell * t.M + j]
    k = torch.clamp((row[:, :t.W] < u_chain[:, None]).sum(1), max=t.W - 1)
    j = row[:, t.W].long() + k
    erow = t.emit_cdf[shell * t.M + j]
    We = t.We
    k2 = torch.clamp((erow[:, :We] < u_emit[:, None]).sum(1), max=We - 1)
    line = erow[:, We:2 * We].gather(1, k2[:, None])[:, 0].long()
    nu = erow[:, 2 * We:].gather(1, k2[:, None])[:, 0]
    return line, nu


def transport(t: Tables, pool_mu, pool_nu, key, lanes: int = 1 << 21,
              est_dtype=torch.float64, packets=None) -> Transported:
    """``packets``: the ids of the pool's entries given (all where None);
    the rows come in their order."""
    device = pool_mu.device
    N = pool_mu.shape[0]
    S, L = t.r_inner.shape[0], t.line_nu.shape[0]
    f32, i64 = torch.float32, torch.int64
    out = torch.zeros((N, 2), dtype=f32, device=device)
    last = torch.zeros((N, 6), dtype=f32, device=device)
    est_j = torch.zeros(S, dtype=est_dtype, device=device)
    est_nubar = torch.zeros(S, dtype=est_dtype, device=device)
    emitted = torch.zeros((), dtype=est_dtype, device=device)
    reabsorbed = torch.zeros((), dtype=est_dtype, device=device)
    B = max(1, min(lanes, N))
    beta_inner = t.r_inner[0]
    birth = torch.searchsorted(-t.line_nu, -pool_nu, right=True)
    kp_all = rng.fold_in(key, torch.arange(N, dtype=i64, device=device)
                         if packets is None else packets)

    r = torch.zeros(B, dtype=f32, device=device)
    mu, energy = torch.zeros_like(r), torch.zeros_like(r)
    nu = torch.ones_like(r)
    shell = torch.zeros(B, dtype=i64, device=device)
    next_line, pid, eidx = (torch.zeros_like(shell) for _ in range(3))
    kp0, kp1 = torch.zeros_like(shell), torch.zeros_like(shell)
    alive = torch.zeros(B, dtype=torch.bool, device=device)
    next_unborn, n_events, unfinished = 0, 0, 0
    while True:
        if next_unborn < N:
            dead = ~alive
            new_ids = next_unborn + torch.cumsum(dead.long(), 0) - 1
            fill = dead & (new_ids < N)
            ids = torch.clamp(new_ids, max=N - 1)
            b_mu = pool_mu[ids]
            inv_dop = 1.0 / (1.0 - b_mu * beta_inner)
            r = torch.where(fill, beta_inner, r)
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
        capped = alive & (eidx >= MAX_EVENTS)
        unfinished += int(capped.sum())
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
        U = _draws(ke[0], ke[1], device)
        tau = (-torch.log(U[:, 0].double())).float()

        chi = t.chi_e[shell]
        r_in, r_out = t.r_inner[shell], t.r_outer[shell]
        z = mu * r
        dop = 1.0 - z
        nu_cmf = nu * dop
        out_d = torch.sqrt(torch.clamp(
            r_out * r_out + (mu * mu - 1.0) * r * r, min=0.0)) - r * mu
        check = r_in * r_in + r * r * (mu * mu - 1.0)
        hits_inner = (mu < 0.0) & (check >= 0.0)
        in_d = -r * mu - torch.sqrt(torch.clamp(check, min=0.0))
        d_b = torch.clamp(torch.where(hits_inner, in_d, out_d), min=0.0)
        delta = torch.where(hits_inner, -1, 1)

        flat = t.prefix.reshape(-1)
        c0 = flat[shell * (L + 1) + next_line]
        nu_thresh = nu * (1.0 - (z + d_b))
        i_ev = _event_line(t, shell, next_line.clone(), chi, z, nu, tau,
                           nu_thresh, c0)
        in_range = i_ev < L
        nu_ev = torch.where(in_range, t.line_nu[torch.clamp(i_ev, max=L - 1)],
                            -torch.inf)
        found = in_range & (nu_ev > nu_thresh)
        s_ev = torch.clamp((1.0 - nu_ev / nu) - z, min=0.0)
        tau_at = (flat[shell * (L + 1) + i_ev] - c0).float()
        d_cont = torch.clamp((tau - tau_at) / chi, min=0.0)
        escat_f = d_cont < s_ev
        escat_nf = d_cont < d_b
        is_line = alive & found & ~escat_f
        is_escat = alive & torch.where(found, escat_f, escat_nf)
        is_boundary = alive & ~found & ~escat_nf
        distance = torch.where(found, torch.where(escat_f, d_cont, s_ev),
                               torch.where(escat_nf, d_cont, d_b))
        end_line = torch.where(is_line, i_ev + 1, i_ev)

        w_j = (energy * dop) * distance
        est_j.index_add_(0, shell[alive], w_j[alive].to(est_dtype))
        est_nubar.index_add_(0, shell[alive],
                             (w_j * nu_cmf)[alive].to(est_dtype))

        r_new = torch.sqrt(torch.clamp(
            r * r + distance * distance + 2.0 * r * distance * mu,
            min=1e-20))
        mu_new = (mu * r + distance) / r_new
        new_shell = shell + delta
        emitted_now = is_boundary & (new_shell >= S)
        reabsorbed_now = is_boundary & (new_shell < 0)
        mu_draw = 2.0 * U[:, 1] - 1.0
        dop_old = 1.0 - mu_new * r_new
        inv_dop_new = 1.0 / (1.0 - mu_draw * r_new)
        em_line, nu_em = _emission(t, shell, i_ev, U[:, 2], U[:, 3])
        interacts = is_escat | is_line
        nu_new = torch.where(is_escat, nu * dop_old * inv_dop_new,
                             torch.where(is_line, nu_em * inv_dop_new, nu))
        energy = torch.where(interacts, energy * dop_old * inv_dop_new,
                             energy)
        next_line = torch.where(is_line, em_line + 1,
                                torch.where(alive, end_line, next_line))
        if bool(interacts.any()):
            last[pid[interacts]] = torch.stack(
                [torch.where(is_line, LI_LINE, LI_ESCAT).float(),
                 torch.where(is_line, i_ev, -1).float(),
                 torch.where(is_line, em_line, -1).float(),
                 shell.float(), nu, r_new], dim=1)[interacts]
        r = torch.where(alive, r_new, r)
        mu = torch.where(interacts, mu_draw, torch.where(alive, mu_new, mu))
        shell = torch.where(is_boundary & ~emitted_now & ~reabsorbed_now,
                            new_shell, shell)
        dying = emitted_now | reabsorbed_now
        n_events += n_alive
        if bool(dying.any()):
            dpid = pid[dying]
            out[dpid, 0] = torch.where(emitted_now, nu, -nu)[dying]
            out[dpid, 1] = energy[dying]
            emitted += energy[emitted_now].to(est_dtype).sum()
            reabsorbed += energy[reabsorbed_now].to(est_dtype).sum()
        nu = nu_new
        alive = alive & ~dying
        eidx = eidx + 1
    return Transported(out=out, last=last, est_j=est_j, est_nubar=est_nubar,
                       emitted=float(emitted), reabsorbed=float(reabsorbed),
                       events=n_events, unfinished=unfinished)
