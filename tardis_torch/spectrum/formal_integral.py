"""Formal-integral spectrum (Lucy 1999) with the ray kernel K5.

Counterpart of ``tardis_tpu/spectrum/formal_integral.py``
(``solve_source_function``, ``_integrate_rays``,
``check_formal_integral_requirements``, ``_interp_shells``,
``FormalIntegralSolver``).  The host builds the (L, S) source-function
tables in f64 from the final iteration's line estimators (numpy / scipy, as
in the JAX package); ``integrate_rays`` integrates every (nu, p) ray through
them on the simulation's device: K5 (``csrc/formal_integral.cu``) for
tensors on the card, the plain PyTorch version ``integrate_rays_plain`` (a
lockstep loop over events) only for CPU tensors.

Geometry in kernel units (length / ct, frequency / NU_UNIT): a ray of
impact parameter p is parameterized by z, its projection towards the
observer; its comoving frequency nu (1 - z) falls as z grows, so the ray
meets the lines in line-list order.  One event per step: the next line
resonance or the next shell boundary, whichever comes first.  A line event
adds the electron-scattering source collected since the last line, then
attenuates by e^-tau and adds the line's source function; a boundary event
collects electron scattering only (Lucy 1999, Eqs 26-28).

The four line tables are stored (S, L), so a ray walking the lines of one
shell reads consecutive addresses; the JAX package indexes them
``line * S + shell``.  The function is the same.

On the card each ray is walked by a group of lanes that computes a shell's
run of line events a few lines at a time (which lines, where, and every
term that does not depend on the intensity) and then runs the serial
recurrence over them in this module's order of f32 operations;
``integrate_ray_chunked`` is that schedule in torch, held against
``integrate_rays_plain`` by the CPU tests.
"""

from __future__ import annotations

import ctypes
import warnings
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as splinalg
import torch

from tardis_torch import cuda, tracing
from tardis_torch.atomic.atom_data import MACRO_EMISSION, MacroAtomData
from tardis_torch.constants import C, SIGMA_THOMSON
from tardis_torch.opacities.macro_atom_solver import (
    solve_transition_probabilities,
)
from tardis_torch.plasma.lte import intensity_black_body
from tardis_torch.spectrum.base import Spectrum
from tardis_torch.transport.tables import NU_UNIT

COUNT_LINE, COUNT_BOUNDARY, COUNT_CAPPED = 0, 1, 2

# ---------------------------------------------------------------------------
# source function (host, f64)
# ---------------------------------------------------------------------------


@dataclass
class SourceFunctionState:
    att_S_ul: np.ndarray  # (L, S)
    Jred_lu: np.ndarray  # (L, S)
    Jblue_lu: np.ndarray  # (L, S)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def solve_source_function(
    macro: MacroAtomData,
    plasma_state,
    transport_result,
    sim_state,
    atom_data,
    line_interaction_type: str = "macroatom",
) -> SourceFunctionState:
    """att_S_ul, Jred_lu and Jblue_lu from the Monte Carlo line estimators."""
    tau = _host(plasma_state.tau_sobolev)  # (L, S)
    dt = transport_result.time_of_simulation
    volume = sim_state.volume
    t_exp = sim_state.time_explosion
    L, S = tau.shape

    e_dot_lu = (transport_result.edot_lu_estimator * -np.expm1(-tau)
                / (dt * volume))

    # line absorption summed into the upper macro levels
    n_macro = macro.n_macro_levels
    e_dot_u = np.zeros((n_macro, S))
    np.add.at(e_dot_u, macro.line2macro_level_upper, e_dot_lu)

    probs = solve_transition_probabilities(
        macro, _host(plasma_state.beta_sobolev), _host(plasma_state.j_blues),
        _host(plasma_state.stimulated_emission_factor),
    )  # (T, S)
    src_level = np.repeat(np.arange(n_macro), np.diff(macro.block_references))

    if line_interaction_type == "macroatom":
        # redistribute through the internal jumps: (I - Q^T) C = e_dot_u
        internal = macro.transition_type >= 0
        src = src_level[internal]
        dst = macro.destination_level_id[internal]
        p_int = probs[internal]
        C_out = np.empty_like(e_dot_u)
        for s in range(S):
            Q = sp.coo_matrix((p_int[:, s], (src, dst)),
                              shape=(n_macro, n_macro))
            A = (sp.identity(n_macro) - Q).T.tocsc()
            C_out[:, s] = splinalg.spsolve(A, e_dot_u[:, s])
        e_dot_u = C_out

    # attenuated source function per line: lambda q_ul e_dot_u t / (4 pi)
    emission = macro.transition_type == MACRO_EMISSION
    em_line_ids = macro.transition_line_id[emission]
    wave = (C / atom_data.line_nu)[em_line_ids][:, None]
    att_S_ul = np.zeros((L, S))
    att_S_ul[em_line_ids] = (wave * probs[emission]
                             * e_dot_u[src_level[emission]] * t_exp
                             / (4.0 * np.pi))

    jblue_norm = C * t_exp / (4.0 * np.pi * dt * volume)
    Jblue_lu = transport_result.j_blue_estimator * jblue_norm[None, :]
    Jred_lu = Jblue_lu * np.exp(-tau) + att_S_ul
    return SourceFunctionState(att_S_ul=att_S_ul, Jred_lu=Jred_lu,
                               Jblue_lu=Jblue_lu)


# ---------------------------------------------------------------------------
# ray integrator (K5)
# ---------------------------------------------------------------------------


@dataclass
class RayOutput:
    i_p: torch.Tensor  # (F, P) f32 emergent intensity times p
    # [line events, boundary events, rays stopped by the event cap]
    counts: torch.Tensor  # (3,) i64
    # (F, P) i32 each ray's events (the plain version only; None from K5)
    events: torch.Tensor | None = None


def max_ray_events(n_lines: int, n_shells: int) -> int:
    """A ray meets each line at most once and crosses at most 2S
    boundaries; a ray still going after this many events is stopped and
    counted (``counts[COUNT_CAPPED]``), which should never happen."""
    return n_lines + 2 * n_shells + 2


def _zb(r, p2):
    return torch.sqrt(torch.clamp(r * r - p2, min=0.0))


def integrate_rays_plain(nu_grid, p_grid, r_inner, r_outer, chi_e, line_nu,
                         exp_tau, att_S, j_red, j_blue, i_inner) -> RayOutput:
    """Plain PyTorch version of K5: all rays step in lockstep, one event per
    step, and rays that leave the shells drop out of the step.

    ``nu_grid`` (F,), ``p_grid`` (P,) impact parameters, ``r_inner``,
    ``r_outer``, ``chi_e`` (S,), ``line_nu`` (L,) descending, the four
    tables (S, L) and ``i_inner`` (F,) the photosphere's intensity, all f32.
    """
    device = nu_grid.device
    F, P = nu_grid.shape[0], p_grid.shape[0]
    S, L = exp_tau.shape
    counts = torch.zeros(3, dtype=torch.int64, device=device)
    nu = nu_grid.repeat_interleave(P)
    p = p_grid.repeat(F)
    p2 = p * p
    beta_inner = r_inner[0]
    r_max = r_outer[S - 1]
    photosphere = p < beta_inner
    z = torch.where(photosphere, _zb(beta_inner, p2), -_zb(r_max, p2))
    shell = torch.where(photosphere, 0, S - 1)
    intensity = torch.where(photosphere, i_inner.repeat_interleave(P), 0.0)
    line = torch.searchsorted(-line_nu, -(nu * (1.0 - z)), right=True)
    out = intensity.clone()
    events = torch.zeros(F * P, dtype=torch.int32, device=device)

    ids = torch.nonzero(p < r_max).squeeze(1)
    nu, p2, z, shell, line, intensity = (
        a[ids] for a in (nu, p2, z, shell, line, intensity))
    z_seg = z.clone()
    escat = torch.zeros_like(z)
    first = torch.ones_like(z, dtype=torch.bool)
    exp_tau_f, att_f, j_red_f, j_blue_f = (
        a.reshape(-1) for a in (exp_tau, att_S, j_red, j_blue))
    cap = max_ray_events(L, S)
    step = 0
    while ids.numel():
        if step >= cap:
            counts[COUNT_CAPPED] += ids.numel()
            out[ids] = intensity
            break
        step += 1
        chi = chi_e[shell]
        r_in = r_inner[shell]
        reaches_inner = (z < 0.0) & (p2 < r_in * r_in)
        z_bound = torch.where(reaches_inner, -_zb(r_in, p2),
                              _zb(r_outer[shell], p2))
        line_c = torch.clamp(line, max=L - 1)
        has_line = line < L
        zeta = 1.0 - line_nu[line_c] / nu
        z_line = torch.where(has_line, torch.maximum(zeta, z), torch.inf)
        line_event = has_line & (z_line <= z_bound)
        row = shell * L
        jb = j_blue_f[row + line_c]
        jr_prev = j_red_f[row + torch.clamp(line_c - 1, min=0)]
        jbar_bound = 0.5 * (jr_prev + jb)
        jbar_line = torch.where(first, jb, jbar_bound)
        d_es_line = ((z_line - z_seg) * chi) * (jbar_line - intensity)
        i_line = ((intensity + escat) + d_es_line) * exp_tau_f[row + line_c] \
            + att_f[row + line_c]
        d_es_bound = ((z_bound - z_seg) * chi) * (jbar_bound - intensity)
        events[ids] += 1
        n_line = line_event.sum()
        counts[COUNT_LINE] += n_line
        counts[COUNT_BOUNDARY] += line_event.numel() - n_line
        intensity = torch.where(line_event, i_line, intensity)
        escat = torch.where(line_event, 0.0, escat + d_es_bound)
        z = torch.where(line_event, z_line, z_bound)
        z_seg = z
        line = torch.where(line_event, line + 1, line)
        shell = torch.where(line_event, shell,
                            torch.where(reaches_inner, shell - 1, shell + 1))
        first = first & ~line_event
        done = (shell < 0) | (shell >= S)
        if bool(done.any()):
            out[ids[done]] = intensity[done]
            keep = ~done
            ids, nu, p2, z, z_seg, shell, line, intensity, escat, first = (
                a[keep] for a in (ids, nu, p2, z, z_seg, shell, line,
                                  intensity, escat, first))
    return RayOutput(i_p=(out * p).reshape(F, P), counts=counts,
                     events=events.reshape(F, P))


def integrate_ray_chunked(nu_grid, p_grid, r_inner, r_outer, chi_e, line_nu,
                          exp_tau, att_S, j_red, j_blue, i_inner, f, k,
                          width: int = 4):
    """K5's schedule for ray (``f``, ``k``) in torch: each shell's run of
    line events ``width`` lines at a time (K5's group of lanes a ray: 4),
    their intensity-free terms
    computed for the whole chunk at once (z_line = max(zeta, z) from the
    chunk's first z, z_seg from the previous line, the mean J, e^-tau and
    the attenuated source), the run ended at the chunk's first line past
    the boundary, then the serial recurrence over the chunk's events in
    the plain version's order of f32 operations, then the boundary event.
    Returns (I p, line events, boundary events, [(shell, line, w, J,
    e^-tau, S) of every line event])."""
    S, L = exp_tau.shape
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32)
    nu, pp = nu_grid[f], p_grid[k]
    p2 = pp * pp
    photosphere = bool(pp < r_inner[0])
    r_max = r_outer[S - 1]
    z = _zb(r_inner[0], p2) if photosphere else -_zb(r_max, p2)
    shell = 0 if photosphere else S - 1
    intensity = i_inner[f].clone() if photosphere else zero.clone()
    line = int(torch.searchsorted(-line_nu, -(nu * (1.0 - z)).reshape(1),
                                  right=True))
    z_seg, escat, first = z, zero.clone(), True
    n_line = n_boundary = 0
    terms = []
    lanes = torch.arange(width)
    active = bool(pp < r_max)
    while active:
        chi = chi_e[shell]
        r_in = r_inner[shell]
        reaches_inner = bool((z < 0.0) & (p2 < r_in * r_in))
        z_bound = -_zb(r_in, p2) if reaches_inner else _zb(r_outer[shell],
                                                           p2)
        while True:
            i = line + lanes
            has_line = i < L
            ic = torch.clamp(i, max=L - 1)
            zeta = 1.0 - line_nu[ic] / nu
            jb = j_blue[shell, ic]
            jr_prev = j_red[shell, torch.clamp(ic - 1, min=0)]
            z_line = torch.maximum(zeta, z)
            ok = has_line & (z_line <= z_bound)
            n = width if bool(ok.all()) else int((~ok).int().argmax())
            zs = torch.cat([z_seg.reshape(1), z_line[:-1]])
            w = (z_line - zs) * chi
            jbar = 0.5 * (jr_prev + jb)
            if first:
                jbar[0] = jb[0]
            e, src = exp_tau[shell, ic], att_S[shell, ic]
            for t in range(n):
                d_es = w[t] * (jbar[t] - intensity)
                intensity = ((intensity + escat) + d_es) * e[t] + src[t]
                escat = zero.clone()
                terms.append((shell, int(i[t]), w[t], jbar[t], e[t],
                              src[t]))
            if n:
                z = z_line[n - 1]
                z_seg = z
                line += n
                n_line += n
                first = False
            if n < width:
                break
        line_c = min(line, L - 1)
        jbar_bound = 0.5 * (j_red[shell, max(line_c - 1, 0)]
                            + j_blue[shell, line_c])
        escat = escat + ((z_bound - z_seg) * chi) * (jbar_bound - intensity)
        z = z_bound
        z_seg = z
        shell += -1 if reaches_inner else 1
        active = 0 <= shell < S
        n_boundary += 1
    return intensity * pp, n_line, n_boundary, terms


def integrate_rays(nu_grid, p_grid, r_inner, r_outer, chi_e, line_nu,
                   exp_tau, att_S, j_red, j_blue, i_inner) -> RayOutput:
    """K5 on the card; the plain version for CPU tensors.  Arguments as
    ``integrate_rays_plain``."""
    device = nu_grid.device
    if device.type == "cpu":
        return integrate_rays_plain(nu_grid, p_grid, r_inner, r_outer, chi_e,
                                    line_nu, exp_tau, att_S, j_red, j_blue,
                                    i_inner)
    if device.type != "cuda":
        raise ValueError(f"formal_integral: unsupported device {device}")
    f32 = torch.float32
    cuda.check_cuda(
        "formal_integral", device, nu_grid=(nu_grid, f32),
        p_grid=(p_grid, f32), r_inner=(r_inner, f32),
        r_outer=(r_outer, f32), chi_e=(chi_e, f32), line_nu=(line_nu, f32),
        exp_tau=(exp_tau, f32), att_S=(att_S, f32), j_red=(j_red, f32),
        j_blue=(j_blue, f32), i_inner=(i_inner, f32),
    )
    F, P = nu_grid.shape[0], p_grid.shape[0]
    S, L = exp_tau.shape
    if not (att_S.shape == j_red.shape == j_blue.shape == (S, L)
            and r_inner.shape == r_outer.shape == chi_e.shape == (S,)
            and line_nu.shape == (L,) and i_inner.shape == (F,)):
        raise ValueError("formal_integral: shapes do not agree")
    res = RayOutput(
        i_p=torch.empty((F, P), dtype=f32, device=device),
        counts=torch.zeros(3, dtype=torch.int64, device=device),
    )
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn = cuda.function("formal_integral", "formal_integral",
                       [vp] * 11 + [ci, ci, ci, i64, i64] + [vp] * 4)
    p = cuda.ptr
    # the ray queue's counter (zeroed in the launch)
    taken = torch.empty(1, dtype=torch.int64, device=device)
    err = fn(
        p(nu_grid), p(p_grid), p(r_inner), p(r_outer), p(chi_e), p(line_nu),
        p(exp_tau), p(att_S), p(j_red), p(j_blue), p(i_inner), F, P, S, L,
        max_ray_events(L, S), p(res.i_p), p(res.counts), p(taken),
        cuda.stream(),
    )
    cuda.check_launch("formal_integral", err)
    integrate_rays.launches += 1
    return res


integrate_rays.launches = 0


# ---------------------------------------------------------------------------
# solver
# ---------------------------------------------------------------------------


class IntegrationError(ValueError):
    """The formal integral cannot run under the current configuration."""


def check_formal_integral_requirements(
    line_interaction_type: str,
    continuum_enabled: bool = False,
    raises: bool = True,
) -> bool:
    """Only downbranch / macroatom line interaction and no continuum."""

    def fail(msg):
        if raises:
            raise IntegrationError(msg)
        warnings.warn(msg)
        return False

    if line_interaction_type not in ("downbranch", "macroatom"):
        return fail(
            "the formal integral only works for line_interaction_type "
            "'downbranch' or 'macroatom' "
            f"(got {line_interaction_type!r})"
        )
    if continuum_enabled:
        return fail(
            "the formal integral does not work with continuum interactions"
        )
    return True


def interp_shells(x_mid_old, x_mid_new, arr, kind="linear"):
    """Per-row interpolation of (rows, S_old) onto S_new shell midpoints:
    linear with linear extrapolation, negatives clamped to 0, or nearest
    (for the electron densities)."""
    arr = np.atleast_2d(arr)
    if kind == "nearest":
        idx = np.abs(x_mid_new[None, :] - x_mid_old[:, None]).argmin(axis=0)
        return arr[:, idx]
    out = np.empty((arr.shape[0], len(x_mid_new)))
    for k in range(arr.shape[0]):
        out[k] = np.interp(x_mid_new, x_mid_old, arr[k])
    lo_slope = (arr[:, 1] - arr[:, 0]) / (x_mid_old[1] - x_mid_old[0])
    hi_slope = (arr[:, -1] - arr[:, -2]) / (x_mid_old[-1] - x_mid_old[-2])
    left = x_mid_new < x_mid_old[0]
    right = x_mid_new > x_mid_old[-1]
    out[:, left] = (arr[:, :1]
                    + lo_slope[:, None] * (x_mid_new[left] - x_mid_old[0]))
    out[:, right] = (arr[:, -1:]
                     + hi_slope[:, None] * (x_mid_new[right] - x_mid_old[-1]))
    return np.clip(out, 0.0, None)


@dataclass
class RayInputs:
    """K5's arguments on one device, and what turns I p into L_nu."""

    tensors: dict  # integrate_rays keyword arguments
    nu_grid: np.ndarray  # (F,) Hz
    dp: float  # impact-parameter step, kernel units
    ct: float  # c t_exp, cm


class FormalIntegralSolver:
    """Source function + ray integration -> Spectrum."""

    def __init__(self, n_points: int = 1000, n_impact_parameters: int = 80,
                 interpolate_shells: int = 0):
        self.n_points = n_points
        self.n_p = n_impact_parameters
        self.interpolate_shells = interpolate_shells

    def ray_inputs(self, nu_edges, sim_state, plasma_state, transport_result,
                   atom_data, line_interaction_type: str = "macroatom",
                   device=None) -> RayInputs:
        """Check the requirements, solve the source function on the host
        and put K5's tables on ``device`` (the card unless the caller asks
        for the CPU; without a card ``None`` raises)."""
        device = cuda.resolve_device(device)
        check_formal_integral_requirements(line_interaction_type)
        with tracing.span("tardis.source_function"):
            source = solve_source_function(
                atom_data.macro_atom if line_interaction_type == "macroatom"
                else atom_data.downbranch,
                plasma_state, transport_result, sim_state, atom_data,
                line_interaction_type,
            )
        ct = C * sim_state.time_explosion
        geometry = sim_state.geometry
        r_inner, r_outer = geometry.r_inner, geometry.r_outer
        tau = _host(plasma_state.tau_sobolev)
        n_e = np.asarray(plasma_state.electron_densities)
        att_S, j_red, j_blue = source.att_S_ul, source.Jred_lu, source.Jblue_lu
        S = sim_state.no_of_shells
        if self.interpolate_shells and self.interpolate_shells > S:
            Sn = int(self.interpolate_shells)
            mid_old = 0.5 * (r_inner + r_outer)
            edges = np.linspace(r_inner[0], r_outer[-1], Sn + 1)
            r_inner, r_outer = edges[:-1], edges[1:]
            mid_new = 0.5 * (r_inner + r_outer)
            att_S, j_red, j_blue, tau = (
                interp_shells(mid_old, mid_new, a)
                for a in (att_S, j_red, j_blue, tau))
            n_e = interp_shells(mid_old, mid_new, n_e[None, :],
                                kind="nearest")[0]

        nu_grid = np.linspace(nu_edges[0], nu_edges[-1], self.n_points)
        p_grid = np.linspace(0.0, r_outer[-1], self.n_p + 1)[1:]

        def f32(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                   device=device)

        tensors = dict(
            nu_grid=f32(nu_grid / NU_UNIT),
            p_grid=f32(p_grid / ct),
            r_inner=f32(r_inner / ct),
            r_outer=f32(r_outer / ct),
            chi_e=f32(SIGMA_THOMSON * n_e * ct),
            line_nu=f32(atom_data.line_nu / NU_UNIT),
            # (S, L): a shell's lines are contiguous
            exp_tau=f32(np.exp(-tau).astype(np.float32).T),
            att_S=f32(att_S.T),
            j_red=f32(j_red.T),
            j_blue=f32(j_blue.T),
            i_inner=f32(intensity_black_body(nu_grid, sim_state.t_inner)),
        )
        return RayInputs(tensors=tensors, nu_grid=nu_grid,
                         dp=float((p_grid[1] - p_grid[0]) / ct), ct=ct)

    def solve(self, nu_edges, sim_state, plasma_state, transport_result,
              atom_data, line_interaction_type: str = "macroatom",
              device=None) -> Spectrum:
        """The integrated spectrum on ``nu_edges``; K5 runs on ``device``,
        as in ``ray_inputs``."""
        inputs = self.ray_inputs(nu_edges, sim_state, plasma_state,
                                 transport_result, atom_data,
                                 line_interaction_type, device)
        with tracing.span("tardis.formal_integral"):
            rays = integrate_rays(**inputs.tensors)
            i_p = rays.i_p.cpu().numpy().astype(np.float64)
        capped = int(rays.counts[COUNT_CAPPED])
        if capped:
            raise RuntimeError(
                f"formal integral: {capped} ray(s) hit the event cap")
        # L_nu = 8 pi^2 integral I p dp, in cgs (times ct^2)
        lum_nu_grid = (8.0 * np.pi**2 * np.trapezoid(i_p, dx=inputs.dp, axis=1)
                       * inputs.ct**2)
        centers = 0.5 * (nu_edges[:-1] + nu_edges[1:])
        lum_nu = np.interp(centers, inputs.nu_grid, lum_nu_grid)
        return Spectrum(nu_edges=np.asarray(nu_edges), luminosity_nu=lum_nu)
