"""The stages of one Type IIP iteration (TARDIS's TypeIIPWorkflow), from
the state it starts from to the state it hands on:

1. the plasma of the field (LTE, with T_e = link T_rad and, after a
   thermal balance, its electron density held fixed);
2. the continuum state and the continuum macro atom;
3. the relativistic packet pool and the transport (``continuum_transport``);
4. the estimators in cgs units: j, nu-bar, the luminosities, and the
   continuum estimators from the grid moments (within a grid cell each
   cross-section is linear in nu, so the per-event sums over the active
   continua factor into contractions with the moments), normalized by
   1 / (dt V h) and damped by J_model / J_estimated;
5. the damped field: t_rad and W towards their estimates, t_inner by
   (L_emitted / L_requested)^-1/2;
6. the thermal balance: per shell, least squares over (electron fraction,
   link) zeroing the fractional heating and the rate-equation electron
   density's change (scipy's trust-region reflective solver, 2 x 2
   blocks, at most ``max_nfev`` evaluations);
7. after the last iteration, the real-packet spectrum.

The keys are those of the converge cells: base (0, seed), the pool's
fold_in(base, 2 it), the loop's fold_in(base, 2 it + 1).  ``dtype``
np.float32 (the control) rounds what the configuration states in f64 to
f32 at each stage: the plasma, the continuum state and the macro atom's
inputs, the tau prefix, the estimators' sums, the thermal balance's
residuals and the field handed on.
"""

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference import rng
from portbench.reference.constants import (
    C,
    H,
    NU_UNIT,
    SIGMA_SB,
    T_RADIATIVE_ESTIMATOR_CONSTANT,
)
from portbench.reference.continuum import Continua, Estimators, State
from portbench.reference.continuum_macro import solve_macro
from portbench.reference.continuum_transport import (
    build_tables,
    continuum_grid,
    relativistic_pool,
    transport,
)
from portbench.reference.iteration import damping
from portbench.reference.plasma import solve_plasma

T_INNER_EXPONENT = -0.5


def round_to(a, dtype):
    return np.asarray(np.asarray(a, np.float64).astype(dtype), np.float64)


@dataclass
class Before:
    """What an iteration starts from: the field, the link T_e / T_rad,
    the electron density the thermal balance fixed (None: the plasma's
    fixpoint, from ``n_e_start``, None: from the total ion density) and
    the damped continuum estimators of the last iteration (None: the
    first, which takes the dilute blackbody)."""

    t_rad: np.ndarray
    w: np.ndarray
    t_inner: float
    link: np.ndarray
    n_e_fixed: np.ndarray | None
    n_e_start: np.ndarray | None
    estimators: Estimators | None


def keys(seed: int, iteration: int):
    base = rng.key(seed)
    return rng.fold_in(base, 2 * iteration), rng.fold_in(base,
                                                         2 * iteration + 1)


def plasma_and_continuum(atoms, model, cont: Continua, b: Before, device,
                         dtype=np.float64):
    """Stages 1 and 2: (plasma, continuum state, macro atom)."""
    pl = solve_plasma(atoms, model, b.t_rad, b.w, b.n_e_start, device, dtype,
                      n_e_fixed=b.n_e_fixed)
    t_e = np.asarray(b.link, np.float64) * np.asarray(b.t_rad, np.float64)
    cs = cont.update(pl, t_e, np.asarray(b.t_rad, np.float64),
                     np.asarray(b.w, np.float64), b.estimators)
    if dtype != np.float64:
        for name in State.COMPARED + ("level_pop", "lte_pop_coef",
                                      "coll_deexc_coeff",
                                      "coll_recomb_coeff",
                                      "coll_deexc_heat_rate",
                                      "coll_ion_cool_rate",
                                      "coll_ion_heat_rate"):
            setattr(cs, name, round_to(getattr(cs, name), dtype))

    def host(x):
        return round_to(x.double().cpu().numpy(), dtype)

    macro = solve_macro(atoms, cs, host(pl.beta), host(pl.stim),
                        host(pl.j_blues))
    return pl, cs, macro


def pool(seed, iteration, ids, t_inner, model, device):
    beta_inner = float(model.r_inner[0] / (C * model.time_explosion))
    return relativistic_pool(keys(seed, iteration)[0], ids, t_inner,
                             beta_inner, device)


def run_transport(atoms, model, seed, iteration, n_e, prefix, cs, macro,
                  pool_mu, pool_nu, pool_w, ids, device, max_events=500_000,
                  est_dtype=torch.float64):
    t = build_tables(model, atoms, n_e, prefix, cs, macro, device)
    return transport(t, pool_mu, pool_nu, pool_w, ids,
                     keys(seed, iteration)[1], max_events=max_events,
                     est_dtype=est_dtype)


def estimators(atoms, model, tr, n_packets: int):
    """Stage 4 before the damping: j, nu-bar (cgs), emitted and
    reabsorbed luminosity, and the continuum estimators."""
    ct = C * model.time_explosion
    e0 = 1.0 / n_packets
    dt = 1.0 / model.luminosity_requested
    S = len(model.density)
    pi = atoms.photo_ion
    grid, xs = continuum_grid(pi)
    gs = grid / NU_UNIT
    m = tr.moments.double().cpu().numpy().reshape(len(grid) - 1, S, 8)
    dg = gs[1:] - gs[:-1]
    beta = (xs[1:] - xs[:-1]) / np.maximum(dg, 1e-300)[:, None]
    alpha = xs[:-1] - beta * gs[:-1, None]

    def contract(ma, mb):
        return (np.einsum("gc,gs->cs", alpha, ma)
                + np.einsum("gc,gs->cs", beta, mb))

    M0, M1, M2, Mb0, Mb1, Mb2 = (m[..., k] for k in range(6))
    nu_th = pi["nu"][pi["block_references"][:-1]] / NU_UNIT
    norm = 1.0 / (dt * model.volume * H)
    active = (xs[:-1] > 0) & (xs[1:] > 0)
    est = Estimators(
        photo_ion=contract(M1, M0) * (ct / NU_UNIT) * e0 * norm[None, :],
        stim_recomb=contract(Mb1, Mb0) * (ct / NU_UNIT) * e0 * norm[None, :],
        bf_heating=((contract(M0, M2) - nu_th[:, None] * contract(M1, M0))
                    * ct * e0 * norm[None, :] * H),
        stim_recomb_cooling=((contract(Mb0, Mb2)
                              - nu_th[:, None] * contract(Mb1, Mb0))
                             * ct * e0 * norm[None, :] * H),
        photo_ion_statistics=np.einsum("gc,gs->cs",
                                       active.astype(np.float64),
                                       m[..., 6]),
        ff_heating=tr.ff_heat.double().cpu().numpy() * e0 * norm * H)
    return dict(
        est_j=tr.est_j.double().cpu().numpy() * e0 * ct,
        est_nubar=tr.est_nubar.double().cpu().numpy() * e0 * ct * NU_UNIT,
        emitted=tr.emitted * e0 / dt, reabsorbed=tr.reabsorbed * e0 / dt,
        continuum=est)


def damp_estimators(model, b: Before, est_j, raw: Estimators) -> Estimators:
    """The continuum estimators times J_model / J_estimated of each shell,
    J_model from the field the iteration started from."""
    dt = 1.0 / model.luminosity_requested
    j_model = b.w * b.t_rad**4 * SIGMA_SB / np.pi
    j_est = est_j / (4.0 * np.pi * dt * model.volume)
    with np.errstate(divide="ignore", invalid="ignore"):
        d = np.where(j_est > 0, j_model / j_est, 1.0)
    return Estimators(
        photo_ion=raw.photo_ion * d[None, :],
        stim_recomb=raw.stim_recomb * d[None, :],
        bf_heating=raw.bf_heating * d[None, :],
        stim_recomb_cooling=raw.stim_recomb_cooling * d[None, :],
        photo_ion_statistics=raw.photo_ion_statistics,
        ff_heating=raw.ff_heating * d)


def field_update(cfg, model, b: Before, est_j, est_nubar, emitted,
                 dtype=np.float64):
    """Stage 5: the damped (t_rad, W, t_inner)."""
    dt = 1.0 / model.luminosity_requested
    t_rad_est = T_RADIATIVE_ESTIMATOR_CONSTANT * est_nubar / est_j
    w_est = est_j / (4.0 * SIGMA_SB * t_rad_est**4 * dt * model.volume)
    t_inner_est = b.t_inner * (emitted / model.luminosity_requested
                               ) ** T_INNER_EXPONENT
    d_t, d_w, d_i = damping(cfg)
    t_rad = np.asarray(b.t_rad, np.float64)
    w = np.asarray(b.w, np.float64)
    return (round_to(t_rad + d_t * (t_rad_est - t_rad), dtype),
            round_to(w + d_w * (w_est - w), dtype),
            float(round_to(b.t_inner + d_i * (t_inner_est - b.t_inner),
                           dtype)))


def thermal_balance(atoms, model, cont: Continua, t_rad, w, link0, n_e0,
                    est: Estimators, max_nfev: int, device,
                    dtype=np.float64):
    """Stage 6: (link, fixed electron density) of each shell."""
    from scipy.optimize import least_squares
    from scipy.sparse import block_diag

    S = len(t_rad)
    max_n_e = np.zeros(S)
    for e, z in enumerate(model.elements):
        nd = model.mass_fractions[e] * model.density / atoms.masses[int(z)]
        max_n_e = max_n_e + nd * z
    x0 = np.empty(2 * S)
    x0[::2] = np.clip(n_e0 / max_n_e, 1e-10, 1.0)
    x0[1::2] = np.clip(np.broadcast_to(np.asarray(link0, float), (S,)),
                       1500.0 / t_rad.min(), 1.5)

    def residuals(x):
        n_e = x[::2] * max_n_e
        pl = solve_plasma(atoms, model, t_rad, w, None, device, dtype,
                          n_e_fixed=n_e, lines=False)
        cs = cont.update(pl, x[1::2] * t_rad, t_rad, w, est)
        n_e_rate = cont.rate_equation_n_e(pl, cs)
        frac_heat = cont.fractional_heating(pl, cs, est)
        res = np.empty(2 * S)
        with np.errstate(divide="ignore", invalid="ignore"):
            res[::2] = (n_e_rate - n_e) / np.maximum(n_e, 1e-300)
        res[1::2] = frac_heat
        return round_to(np.where(np.isfinite(res), res, 1e3), dtype)

    lower, upper = np.empty(2 * S), np.empty(2 * S)
    lower[::2], upper[::2] = 1e-10, 1.0
    lower[1::2], upper[1::2] = 1500.0 / t_rad.min(), 1.5
    x0 = np.clip(x0, lower, upper)
    sol = least_squares(residuals, x0, bounds=(lower, upper),
                        jac_sparsity=block_diag([np.ones((2, 2))] * S),
                        xtol=1e-12, ftol=1e-10, max_nfev=max_nfev,
                        method="trf")
    return sol.x[1::2], sol.x[::2] * max_n_e


def spectrum(cfg, model, out, n_packets: int):
    """Stage 7: L_nu of the emitted packets (rows of signed nu / NU_UNIT
    and energy in birth units) on the configuration's frequency grid,
    uniform in nu between c / lambda_stop and c / lambda_start."""
    from portbench.reference.constants import quantity

    sp = cfg["spectrum"]
    edges = np.linspace(C / quantity(sp["stop"]), C / quantity(sp["start"]),
                        int(sp["num"]) + 1)
    out = out.cpu().numpy().astype(np.float64)
    keep = out[:, 0] > 0
    hist, _ = np.histogram(np.abs(out[:, 0])[keep] * NU_UNIT, bins=edges,
                           weights=(out[:, 1] * (1.0 / n_packets))[keep])
    return hist / (1.0 / model.luminosity_requested) / np.diff(edges)
