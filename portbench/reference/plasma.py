"""LTE plasma: level populations, the electron density and the Sobolev line
tables of one radiation field (Saha ionization with the electron-density
fixpoint, Boltzmann excitation, dilute-blackbody J_blue).

The fixpoint stops at 5% relative change, as TARDIS's does, so its result
depends on where it starts: the caller passes the electron density it
starts from (None: the total ion number density).  Where the caller fixes
the electron density (the Type IIP thermal balance's), the ions follow
from it without the fixpoint.
"""

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference.atoms import Atoms
from portbench.reference.constants import (
    C,
    H,
    K_B,
    M_E,
    SOBOLEV_COEFFICIENT,
)
from portbench.reference.model import Model

ION_ZERO = 1e-20
N_E_THRESHOLD = 0.05
N_E_MAX_ITERATIONS = 200


@dataclass
class Plasma:
    n_e: np.ndarray  # (S,)
    ion: np.ndarray  # (Sp, S) ion number densities by species
    level_pop: np.ndarray  # (N, S)
    stim: torch.Tensor  # (L, S)
    tau: torch.Tensor  # (L, S)
    beta: torch.Tensor  # (L, S) Sobolev escape probability
    j_blues: torch.Tensor  # (L, S)
    prefix: torch.Tensor  # (S, L + 1) inclusive tau prefix, leading 0


def ion_ladder(atoms: Atoms, model: Model, dtype):
    """Per element present: its species rows (= ion rows, stage order), the
    ionization energies of its steps and its number density (S,)."""
    blocks = []
    for e, z in enumerate(model.elements):
        rows = np.nonzero(atoms.species[:, 0] == z)[0]
        if not len(rows):
            continue
        stages = atoms.species[rows, 1]
        chi = [atoms.ion_energy[(atoms.ion_z == z) & (atoms.ion_stage == j)]
               [0] for j in stages[1:]]
        nd = (model.mass_fractions[e] * model.density
              / atoms.masses[int(z)]).astype(dtype)
        blocks.append((rows, np.asarray(chi, dtype), nd))
    return blocks


def solve_plasma(atoms: Atoms, model: Model, t_rad, w, n_e_start,
                 device, dtype=np.float64, n_e_fixed=None,
                 lines=True) -> Plasma:
    """``lines`` False leaves out the line tables (the thermal balance
    reads the populations alone)."""
    t_rad = np.asarray(t_rad, dtype)
    w = np.asarray(w, dtype)
    beta = (1.0 / (K_B * t_rad)).astype(dtype)
    bf = (atoms.level_g[:, None]
          * np.exp(-np.outer(atoms.level_energy, beta))).astype(dtype)
    z_part = np.zeros((len(atoms.species), len(t_rad)), dtype)
    np.add.at(z_part, atoms.level_species, bf)
    g_el = ((2.0 * np.pi * M_E / (beta * H * H)) ** 1.5).astype(dtype)
    blocks = ion_ladder(atoms, model, dtype)
    phis = [(z_part[rows[1:]] / z_part[rows[:-1]]) * 2.0 * g_el[None]
            * np.exp(-np.outer(chi, beta)) for rows, chi, _ in blocks]

    def ions(n_e):
        out = np.zeros((len(atoms.species), len(t_rad)), dtype)
        for (rows, _, nd), phi in zip(blocks, phis):
            prod = np.cumprod(phi / n_e[None], axis=0)
            base = nd / (1.0 + prod.sum(axis=0))
            out[rows[0]] = base
            out[rows[1:]] = base[None] * prod
        out[out < ION_ZERO] = 0.0
        return out

    charge = atoms.species[:, 1].astype(dtype)
    iterations = N_E_MAX_ITERATIONS
    if n_e_fixed is not None:
        n_e_start, iterations = n_e_fixed, 0
    n_e = (np.sum([nd for _, _, nd in blocks], axis=0) if n_e_start is None
           else np.asarray(n_e_start, dtype))
    for _ in range(iterations):
        new = (ions(n_e) * charge[:, None]).sum(axis=0)
        if not np.all(np.isfinite(new)):
            raise FloatingPointError("electron density diverged")
        if np.all(np.abs(new - n_e) / np.maximum(n_e, 1e-300)
                  < N_E_THRESHOLD):
            n_e = new
            break
        n_e = 0.5 * (new + n_e)
    ion = ions(n_e)
    pop = (bf / z_part[atoms.level_species]
           * ion[atoms.level_species]).astype(dtype)
    tables = (line_tables(atoms, model, pop, t_rad, w, device, dtype)
              if lines else dict.fromkeys(("stim", "tau", "beta", "j_blues",
                                           "prefix")))
    return Plasma(n_e=n_e, ion=ion, level_pop=pop, **tables)


def line_tables(atoms: Atoms, model: Model, pop, t_rad, w, device, dtype):
    tdt = torch.float64 if dtype == np.float64 else torch.float32

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype), dtype=tdt,
                               device=device)

    nu = t(atoms.line_nu)
    lo, up = (torch.as_tensor(a, device=device)
              for a in (atoms.line_lower, atoms.line_upper))
    level_pop = t(pop)
    n_lo, n_up = level_pop[lo], level_pop[up]
    g = t(atoms.level_g)
    ratio = (g[lo][:, None] * n_up) / (g[up][:, None] * n_lo)
    ratio = torch.where(torch.isfinite(ratio), ratio, 1.0)
    stim = torch.clamp(1.0 - ratio, min=0.0)
    wl_flu = t((C / atoms.line_nu) * atoms.line_f_lu)
    tau = (SOBOLEV_COEFFICIENT * wl_flu[:, None] * model.time_explosion
           * stim * n_lo)
    safe = torch.where(tau > 0, tau, 1.0)
    beta = torch.where(tau > 1e3, 1.0 / safe, torch.where(
        tau < 1e-4, 1.0 - 0.5 * tau, -torch.expm1(-tau) / safe))
    x = torch.clamp(nu[:, None] * t(H / (K_B * t_rad))[None], max=700.0)
    nu3 = t(2.0 * H * atoms.line_nu**3 / C**2)
    j_blues = t(w)[None] * (nu3[:, None] / torch.expm1(x))
    prefix = torch.zeros((tau.shape[1], tau.shape[0] + 1), dtype=tdt,
                         device=device)
    torch.cumsum(tau.T, dim=1, out=prefix[:, 1:])
    return dict(stim=stim, tau=tau, beta=beta, j_blues=j_blues,
                prefix=prefix)
