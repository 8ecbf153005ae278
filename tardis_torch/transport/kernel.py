"""Monte Carlo packet event loop (kernel K1, ``csrc/transport_loop.cu``).

Counterpart of ``tardis_tpu/transport/kernel.py`` (``make_transport_step``
driven by ``run_transport``) in classic mode, with the luminosity summary
of ``tardis_tpu/transport/solver.py`` ``_device_summary`` folded in.

Per event, with every random number from
``uniform(fold_in(fold_in(key, packet_id), event_idx), (10,), 1e-9, 1)``
(columns 0: tau, 1: mu, 6: chain row, 7: emission row), exactly the JAX
package's draws:

1. boundary distance (an inward hit needs mu < 0 strictly);
2. the first line i >= next_line whose resonance lies past the boundary or
   whose optical depth from next_line exceeds tau_event = -ln u0;
3. bulk j / nu-bar estimators, and the line difference array
   (``(line * S + shell) * 2 + {0: j_blue, 1: e_dot}``, +w at next_line,
   -w at the end of the crossed range);
4. the move, then a boundary crossing, a Thomson scatter or a line
   interaction (scatter, downbranch or the macro-atom absorbing chain);
5. death at the outer (emitted, +nu) or inner (reabsorbed, -nu) boundary.

With ``vpacket_capacity`` > 0 (the final iteration with virtual packets)
every birth and every interaction appends a spawn record for the vpacket
volley (``transport/vpacket.py``), as ``kernel.py:520-545,987-1008`` of the
JAX package do: ``[r, mu, nu, energy, shell, next_line, li_type, out_line]``
f32, the birth row ``[beta_inner, mu, nu, energy, 0, birth_line, -1, -1]``,
an interaction row the state after the scatter with ``li_type`` 1 for an
e-scatter and 2 for a line and ``out_line = next_line - 1`` for a line.
``vp_count`` counts every attempt; rows past the capacity are dropped.

``transport_loop`` launches the CUDA kernel (one thread per packet) for
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

from tardis_torch import cuda
from tardis_torch.transport import rng
from tardis_torch.transport.tables import (
    LINE_MACROATOM,
    LINE_SCATTER,
    TransportTables,
)

STATUS_IN_PROCESS = 0
STATUS_EMITTED = 1
STATUS_REABSORBED = 2
# per-packet event cap: a packet alive after this many events is stopped
# without output and counted (the JAX package's immortal-lane guard)
MAX_EVENTS = 500_000

COL_TAU, COL_MU, COL_CHAIN, COL_EMIT = 0, 1, 6, 7
U_MIN = 1e-9

logger = logging.getLogger(__name__)


@dataclass
class TransportOutput:
    out: torch.Tensor  # (N, 2) f32: signed nu (+ emitted, - reabsorbed), energy
    est_j: torch.Tensor  # (S,) f64
    est_nubar: torch.Tensor  # (S,) f64
    line_diff: torch.Tensor  # (2 * (L+1) * S,) f64
    # [energy emitted inside the nu window, energy reabsorbed, events,
    #  packets stopped by the event cap]
    summary: torch.Tensor  # (4,) f64
    vp_records: torch.Tensor  # (capacity, 8) f32 spawn records
    vp_count: torch.Tensor  # (1,) i64 records attempted (may exceed capacity)

    @property
    def n_vp_records(self) -> int:
        """Records written: the attempts, clipped to the capacity."""
        return min(int(self.vp_count[0]), self.vp_records.shape[0])


def _allocate(n_packets, S, L, capacity, device) -> TransportOutput:
    z = torch.zeros
    return TransportOutput(
        out=z((n_packets, 2), dtype=torch.float32, device=device),
        est_j=z(S, dtype=torch.float64, device=device),
        est_nubar=z(S, dtype=torch.float64, device=device),
        line_diff=z(2 * (L + 1) * S, dtype=torch.float64, device=device),
        summary=z(4, dtype=torch.float64, device=device),
        vp_records=z((capacity, 8), dtype=torch.float32, device=device),
        vp_count=z(1, dtype=torch.int64, device=device),
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


def _search(t: TransportTables, shell, lo, chi, z, nu, tau_event,
            nu_thresh, c0):
    """First i in [lo, L] with i == L, nu_i <= nu_thresh or g(i) > tau."""
    L = t.n_lines
    hi = torch.full_like(lo, L)
    row = shell * (L + 1)
    pflat = t.prefix.reshape(-1)
    for _ in range(int(np.ceil(np.log2(L + 1))) + 1):
        active = lo < hi
        mid = (lo + hi) >> 1
        midc = torch.clamp(mid, max=L - 1)
        nl = t.line_nu[midc]
        s = torch.clamp((1.0 - nl / nu) - z, min=0.0)
        g = (pflat[row + midc + 1] - c0).float() + chi * s
        fire = (nl <= nu_thresh) | (g > tau_event)
        lo = torch.where(active & ~fire, mid + 1, lo)
        hi = torch.where(active & fire, mid, hi)
    return lo


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


def transport_loop_plain(t: TransportTables, pool_mu, pool_nu, key,
                         nu_window=(0.0, np.inf), batch_size: int = 65536,
                         max_events: int = MAX_EVENTS,
                         vpacket_capacity: int = 0) -> TransportOutput:
    """Plain PyTorch version of K1: a lockstep loop over ``batch_size`` lanes.

    Dead lanes refill from the pool in packet-id order.  Every packet's
    arithmetic is elementwise and keyed by its id, so per-packet outputs do
    not depend on ``batch_size``.  Spawn records are appended in lane order
    within a step, as the JAX package's cumsum slots are.
    """
    device = pool_mu.device
    N = pool_mu.shape[0]
    S, L = t.n_shells, t.n_lines
    res = _allocate(N, S, L, vpacket_capacity, device)
    n_vp = 0
    nu_lo, nu_hi = _window(nu_window)
    B = max(1, min(batch_size, N))
    f32, i64 = torch.float32, torch.int64
    beta_inner = t.r_inner[0]
    birth = torch.searchsorted(-t.line_nu, -pool_nu, right=True)
    pid_all = torch.arange(N, dtype=i64, device=device)
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
            inv_dop = 1.0 / (1.0 - b_mu * beta_inner)
            b_nu = pool_nu[ids] * inv_dop
            if vpacket_capacity:
                one = torch.ones_like(b_mu)
                n_vp = _spawn(res, n_vp, torch.stack(
                    [one * beta_inner, b_mu, b_nu, inv_dop, 0.0 * one,
                     birth[ids].float(), -one, -one], dim=1)[fill])
            r = torch.where(fill, beta_inner, r)
            mu = torch.where(fill, b_mu, mu)
            nu = torch.where(fill, b_nu, nu)
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
        n_immortal += int(capped.sum())
        alive = alive & ~capped
        if not bool(alive.any()):
            if next_unborn >= N:
                break
            continue

        # ---- draws
        ke = rng.fold_in((kp0, kp1), eidx)
        U = _draws(ke[0], ke[1], (COL_TAU, COL_MU, COL_CHAIN, COL_EMIT),
                   device)
        tau_event = (-torch.log(U[:, 0].double())).float()

        # ---- trace
        chi = t.chi_e[shell]
        r_in = t.r_inner[shell]
        r_out = t.r_outer[shell]
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

        c0 = t.prefix.reshape(-1)[shell * (L + 1) + next_line]
        nu_thresh = nu * (1.0 - (z + d_b))
        i_ev = _search(t, shell, next_line.clone(), chi, z, nu, tau_event,
                       nu_thresh, c0)
        in_range = i_ev < L
        nu_ev = torch.where(in_range, t.line_nu[torch.clamp(i_ev, max=L - 1)],
                            -torch.inf)
        found = in_range & (nu_ev > nu_thresh)
        s_ev = torch.clamp((1.0 - nu_ev / nu) - z, min=0.0)
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
        w_j = (energy * dop) * distance
        res.est_j.index_add_(0, shell[alive], w_j[alive].double())
        res.est_nubar.index_add_(0, shell[alive],
                                 (w_j * nu_cmf)[alive].double())
        crossed = alive & (end_line != next_line)
        w1 = (energy / (nu * nu))[crossed].double()
        w2 = (energy / nu)[crossed].double()
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
        new_shell = shell + delta
        emitted = is_boundary & (new_shell >= S)
        reabsorbed = is_boundary & (new_shell < 0)
        mu_draw = 2.0 * U[:, 1] - 1.0
        dop_old_pos = 1.0 - mu_new * r_new
        inv_dop_new = 1.0 / (1.0 - mu_draw * r_new)
        if t.mode == LINE_SCATTER:
            em_line, nu_em = i_ev, nu_ev
        else:
            em_line, nu_em = _emission(t, shell, i_ev, U[:, 2], U[:, 3])
        interacts = is_escat | is_line
        nu_new = torch.where(
            is_escat, nu * dop_old_pos * inv_dop_new,
            torch.where(is_line, nu_em * inv_dop_new, nu),
        )
        energy = torch.where(interacts, energy * dop_old_pos * inv_dop_new,
                             energy)
        next_line = torch.where(is_line, em_line + 1,
                                torch.where(alive, end_line, next_line))
        r = torch.where(alive, r_new, r)
        mu = torch.where(interacts, mu_draw, torch.where(alive, mu_new, mu))
        shell = torch.where(is_boundary & ~emitted & ~reabsorbed, new_shell,
                            shell)
        if vpacket_capacity:
            li_type = torch.where(is_line, 2.0, 1.0).float()
            out_line = torch.where(is_line, (next_line - 1).float(), -1.0)
            n_vp = _spawn(res, n_vp, torch.stack(
                [r, mu, nu_new, energy, shell.float(), next_line.float(),
                 li_type, out_line], dim=1)[interacts])

        # ---- deaths (nu is unchanged by a boundary crossing)
        dying = emitted | reabsorbed
        n_events += int(alive.sum())
        if bool(dying.any()):
            dpid = pid[dying]
            res.out[dpid, 0] = torch.where(emitted, nu, -nu)[dying]
            res.out[dpid, 1] = energy[dying]
            in_window = emitted & (nu > nu_lo) & (nu < nu_hi)
            res.summary[0] += energy[in_window].double().sum()
            res.summary[1] += energy[reabsorbed].double().sum()
        nu = nu_new
        alive = alive & ~dying
        eidx = eidx + 1
    res.summary[2] = n_events
    res.summary[3] = n_immortal
    res.vp_count[0] = n_vp
    return res


def transport_loop(t: TransportTables, pool_mu, pool_nu, key,
                   nu_window=(0.0, np.inf),
                   max_events: int = MAX_EVENTS,
                   vpacket_capacity: int = 0) -> TransportOutput:
    """K1 on the card; the plain version for CPU tensors.

    ``key`` is the iteration's run key; ``nu_window`` the (lo, hi)
    emitted-luminosity window in NU_UNIT; ``vpacket_capacity`` the number
    of spawn records to keep (0: none are written).
    """
    device = pool_mu.device
    if device.type == "cpu":
        return transport_loop_plain(t, pool_mu, pool_nu, key, nu_window,
                                    max_events=max_events,
                                    vpacket_capacity=vpacket_capacity)
    if device.type != "cuda":
        raise ValueError(f"transport_loop: unsupported device {device}")
    f32 = torch.float32
    cuda.check_cuda(
        "transport_loop", device, pool_mu=(pool_mu, f32),
        pool_nu=(pool_nu, f32), r_inner=(t.r_inner, f32),
        r_outer=(t.r_outer, f32), chi_e=(t.chi_e, f32),
        line_nu=(t.line_nu, f32), prefix=(t.prefix, torch.float64),
        line2macro=(t.line2macro, torch.int32),
        chain_cdf=(t.chain_cdf, f32), emit_cdf=(t.emit_cdf, f32),
    )
    N = pool_mu.shape[0]
    S, L = t.n_shells, t.n_lines
    rows = S * t.n_states
    if (pool_mu.shape != (N,) or pool_nu.shape != (N,)
            or t.prefix.shape != (S, L + 1)
            or t.line2macro.shape != (L,)
            or (t.mode == LINE_MACROATOM
                and t.chain_cdf.shape != (rows, t.chain_width + 1))
            or (t.mode != LINE_SCATTER
                and t.emit_cdf.shape != (rows, 3 * t.emit_width))):
        raise ValueError("transport_loop: table shapes do not agree")
    res = _allocate(N, S, L, vpacket_capacity, device)
    nu_lo, nu_hi = _window(nu_window)
    fn = cuda.library("transport_loop").transport_loop
    fn.restype = ctypes.c_int
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = (
        [vp, vp, i64] + [vp] * 8 + [i64] + [ci] * 6
        + [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float, ctypes.c_float,
           i64] + [vp] * 7 + [i64, vp]
    )
    p = cuda.ptr
    err = fn(
        p(pool_mu), p(pool_nu), N, p(t.r_inner), p(t.r_outer), p(t.chi_e),
        p(t.line_nu), p(t.prefix), p(t.line2macro), p(t.chain_cdf),
        p(t.emit_cdf), L, S, t.n_states, t.chain_width, t.emit_width,
        t.mode, int(t.disable_line_scattering), key[0], key[1], nu_lo, nu_hi,
        max_events, p(res.out), p(res.est_j), p(res.est_nubar),
        p(res.line_diff), p(res.summary), p(res.vp_records),
        p(res.vp_count), vpacket_capacity, cuda.stream(),
    )
    cuda.check_launch("transport_loop", err)
    transport_loop.launches += 1
    return res


transport_loop.launches = 0


def warn_immortal(res: TransportOutput) -> int:
    """Log how many packets the event cap stopped; returns the count."""
    n = int(res.summary[3])
    if n:
        logger.warning(
            "%d packet(s) stopped after %d events (immortal-packet guard) — "
            "they carry no output", n, MAX_EVENTS,
        )
    return n
