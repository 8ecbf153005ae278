"""One convergence iteration of a TARDIS model, from the radiation field it
starts from to the damped field it hands on: plasma, chain tables, packet
pool, transport, estimators, the field they imply and the damped update
(t_rad and W, then t_inner from the emitted luminosity).

The keys are those of TARDIS on JAX with partitionable threefry:
base = (0, seed), the pool's fold_in(base, 2 it), the loop's
fold_in(base, 2 it + 1).  ``dtype`` is the precision of everything the
configuration states in f64 (np.float32 for the control): the plasma,
the chain tables, the tau prefix and the estimators' sums; the scalar
arithmetic in cgs units stays in f64 (luminosities and volumes overflow
f32), and the damped field handed on is rounded to ``dtype``.
"""

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference import rng
from portbench.reference.constants import (
    C,
    NU_UNIT,
    SIGMA_SB,
    SIGMA_THOMSON,
    T_RADIATIVE_ESTIMATOR_CONSTANT,
)
from portbench.reference.macro import chain_tables
from portbench.reference.plasma import solve_plasma
from portbench.reference.transport import Tables, packet_pool, transport


@dataclass
class FieldState:
    """The radiation field an iteration starts from, and the electron
    density its plasma fixpoint starts from (None: the first solve)."""

    t_rad: np.ndarray
    w: np.ndarray
    t_inner: float
    n_e_start: np.ndarray | None


def damping(cfg: dict) -> tuple:
    """(t_rad, W, t_inner) damping constants of a ``damped`` strategy."""
    st = cfg["montecarlo"].get("convergence_strategy", {}) or {}
    if st.get("type", "damped") != "damped":
        raise ValueError("the reference runs the damped strategy")
    base = st.get("damping_constant", 1.0)
    return tuple((st.get(k, {}) or {}).get("damping_constant", base)
                 for k in ("t_rad", "w", "t_inner"))


def run_iteration(cfg, atoms, lay, model, state: FieldState, seed: int,
                  iteration: int, n_packets: int, device,
                  dtype=np.float64, lanes: int = 1 << 21,
                  prefix=None, packets=None) -> dict:
    """``prefix`` replaces the reference's tau prefix (the witness: what
    the prefix's rounding alone changes); ``packets`` runs only those ids
    of the pool, and returns their rows alone, in their order."""
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    plasma = solve_plasma(atoms, model, state.t_rad, state.w,
                          state.n_e_start, device, dtype)
    if prefix is not None:
        plasma.prefix = prefix
    mode = cfg["plasma"]["line_interaction_type"]
    if mode != "macroatom":
        raise ValueError(f"the reference runs macroatom, not {mode}")
    chain_cdf, emit_cdf = chain_tables(atoms, lay, plasma.beta,
                                       plasma.j_blues, plasma.stim, tdt)
    ct = C * model.time_explosion

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    tables = Tables(
        r_inner=f32(model.r_inner / ct), r_outer=f32(model.r_outer / ct),
        chi_e=f32(SIGMA_THOMSON * np.asarray(plasma.n_e) * ct),
        line_nu=f32(atoms.line_nu / NU_UNIT), prefix=plasma.prefix,
        line2macro=torch.as_tensor(atoms.line_macro_upper, device=device),
        chain_cdf=chain_cdf, emit_cdf=emit_cdf,
        M=atoms.n_macro, W=lay.W, We=lay.We)
    base = rng.key(seed)
    mu, nu = packet_pool(rng.fold_in(base, 2 * iteration), n_packets,
                         state.t_inner, device)
    if packets is not None:
        mu, nu = mu[packets], nu[packets]
    tr = transport(tables, mu, nu, rng.fold_in(base, 2 * iteration + 1),
                   lanes=lanes, est_dtype=tdt, packets=packets)
    if packets is not None:
        return dict(out=tr.out, last=tr.last)

    e0 = 1.0 / n_packets
    lum = model.luminosity_requested
    dt = 1.0 / lum
    j = tr.est_j.cpu().numpy().astype(np.float64) * e0 * ct
    nubar = tr.est_nubar.cpu().numpy().astype(np.float64) * e0 * ct * NU_UNIT
    emitted = tr.emitted * e0 / dt
    reabsorbed = tr.reabsorbed * e0 / dt
    t_rad_est = T_RADIATIVE_ESTIMATOR_CONSTANT * nubar / j
    w_est = j / (4.0 * SIGMA_SB * t_rad_est**4 * dt * model.volume)
    t_inner_est = state.t_inner * (emitted / lum) ** -0.5
    d_t, d_w, d_i = damping(cfg)
    t_rad = np.asarray(state.t_rad, np.float64)
    w = np.asarray(state.w, np.float64)

    def rounded(a):
        return np.asarray(a, np.float64).astype(dtype)

    return dict(
        n_e=plasma.n_e, tau=plasma.tau, prefix=plasma.prefix,
        chain_cdf=chain_cdf,
        emit_cdf=emit_cdf, out=tr.out, last=tr.last, est_j=j,
        est_nubar=nubar, emitted=emitted, reabsorbed=reabsorbed,
        events=tr.events, unfinished=tr.unfinished,
        t_rad=rounded(t_rad + d_t * (t_rad_est - t_rad)),
        w=rounded(w + d_w * (w_est - w)),
        t_inner=float(rounded(state.t_inner
                              + d_i * (t_inner_est - state.t_inner))),
    )
