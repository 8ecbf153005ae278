"""NLTE level populations from statistical-equilibrium rate matrices.

Counterpart of ``tardis_tpu/plasma/nlte.py`` (the reference's
``LevelBoltzmannFactorNLTE``), host numpy f64 as there: for each NLTE
species, one (K, K) rate matrix per shell from the Einstein coefficients
and the lines' mean intensities, plus collisional rates, solved with a
particle-conservation closure in place of the last row.  A few
milliseconds per iteration at the bench problem's Si II (K = 200 levels,
~10,000 lines, 20 shells); no device program of the JAX package computes
it.

Radiative rates (Einstein relations from f_lu):
    A_ul = (8 pi^2 e^2 nu^2 / m_e c^3) (g_l/g_u) f_lu
    B_lu = (4 pi^2 e^2 / m_e h nu c) f_lu          [J_nu convention]
    B_ul = (g_l/g_u) B_lu

Modes: the default reads the lines' j_blues; ``coronal_approximation``
sets them to 0; ``classical_nebular`` takes W B_nu(T_rad).  Collisions
take the tabulated strengths (``AtomData.collision``) where the table
covers a transition and the van Regemorter (1962) approximation where it
does not.
"""

from __future__ import annotations

import numpy as np

from tardis_torch.atomic.atom_data import SYMBOL_TO_Z
from tardis_torch.constants import C, E_CHARGE, H, K_B, M_E
from tardis_torch.plasma.continuum import BETA_COLL, interp_yg
from tardis_torch.plasma.lte import intensity_black_body

A_COEF = 8.0 * np.pi**2 * E_CHARGE**2 / (M_E * C**3)
B_COEF = 4.0 * np.pi**2 * E_CHARGE**2 / (M_E * H * C)
# van Regemorter: rate coefficient prefactor [cm^3 s^-1 sqrt(K)], with an
# effective Gaunt factor of 0.2 (neutral) or 0.7 (ions)
VR_COEF = 5.465e-11
CHI_H = 2.1798724e-11  # hydrogen ionization energy [erg]
ROMAN = {"I": 1, "II": 2, "III": 3, "IV": 4, "V": 5, "VI": 6}


def parse_species(spec: str) -> tuple[int, int]:
    """'Si 2' / 'Si II' / 'Si_2' -> (Z, ion), the ion 0-based."""
    symbol, ion = spec.replace("_", " ").split()[:2]
    stage = ROMAN[ion] if ion in ROMAN else int(ion)
    return SYMBOL_TO_Z[symbol.capitalize()], stage - 1


def einstein_rates(nu, f_lu, g_l, g_u, jb):
    """(r_up, r_down) (n_lines, S): B_lu J and A_ul + B_ul J."""
    a_ul = A_COEF * nu**2 * (g_l / g_u) * f_lu
    b_lu = B_COEF / nu * f_lu
    b_ul = b_lu * (g_l / g_u)
    return b_lu[:, None] * jb, a_ul[:, None] + b_ul[:, None] * jb


def van_regemorter(nu, f_lu, t_electrons, g_bar):
    """(q_lu (n_lines, S) [cm^3 / s], u0 = h nu / k T_e (n_lines, S));
    ``g_bar`` a scalar or one per line."""
    de = H * nu
    u0 = np.minimum(de[:, None] / (K_B * t_electrons)[None, :], 500.0)
    g_bar = np.reshape(g_bar, (-1, 1)) if np.ndim(g_bar) else g_bar
    q_lu = (VR_COEF * np.sqrt(t_electrons)[None, :] * 14.5 * f_lu[:, None]
            * (CHI_H / de[:, None]) ** 2 * u0 * np.exp(-u0) * g_bar)
    return q_lu, u0


def tabulated_rates(atom, in_set, local, g, t_electrons, n_e):
    """The collision table's transitions inside the level set ``in_set``
    (a mask over flat levels): (lo, up) local indices and their rates
    (C_lu, C_ul) (Nc, S) [1/s], or None where the table has none."""
    coll = getattr(atom, "collision", None)
    if coll is None or len(coll) == 0:
        return None
    keep = in_set[coll.lower_flat] & in_set[coll.upper_flat]
    if not keep.any():
        return None
    lo_f, up_f = coll.lower_flat[keep], coll.upper_flat[keep]
    yg = interp_yg(coll, t_electrons)[keep]  # (Nc, S)
    lo, up = local[lo_f], local[up_f]
    d_e = atom.level_energy[up_f] - atom.level_energy[lo_f]
    u0 = np.minimum(d_e[:, None] / (K_B * t_electrons)[None, :], 500.0)
    pref = BETA_COLL / np.sqrt(t_electrons)[None, :]
    c_lu = pref * yg * np.exp(-u0) * n_e[None, :]
    c_ul = pref * yg * (g[lo] / g[up])[:, None] * n_e[None, :]
    return lo, up, c_lu, c_ul


def solve_closed(M: np.ndarray, total: float = 1.0) -> np.ndarray:
    """Populations of the rate matrix ``M`` (rates into row from column,
    diagonal not yet filled) with the last row replaced by conservation:
    sum = ``total``; uniform where the system is singular."""
    K = M.shape[0]
    M[np.diag_indices(K)] -= M.sum(axis=0)
    M[-1, :] = 1.0
    rhs = np.zeros(K)
    rhs[-1] = total
    try:
        return np.linalg.solve(M, rhs)
    except np.linalg.LinAlgError:
        return np.full(K, total / K)


def nlte_level_boltzmann_factor(
    atom_data,
    species: tuple[int, int],
    t_rad: np.ndarray,  # (S,)
    w: np.ndarray,  # (S,)
    j_blues: np.ndarray,  # (L, S) line mean intensities
    electron_densities: np.ndarray | None = None,  # (S,) for collisions
    t_electrons: np.ndarray | None = None,
    coronal_approximation: bool = False,
    classical_nebular: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """One species' level populations, as (flat level indices,
    boltzmann factors (K, S)): the rows that replace the species' LTE
    level Boltzmann factors, scaled so the ground level is g_0 as in LTE.
    Without ``electron_densities`` and ``t_electrons`` no collisions are
    taken."""
    z, ion = species
    sel = (atom_data.level_z == z) & (atom_data.level_ion == ion)
    level_idx = np.nonzero(sel)[0]
    K = len(level_idx)
    S = len(t_rad)
    if K == 0:
        return level_idx, np.zeros((0, S))
    g = atom_data.level_g[level_idx]
    local = np.full(len(sel), -1, np.int64)
    local[level_idx] = np.arange(K)

    line_ids = np.nonzero((atom_data.line_z == z)
                          & (atom_data.line_ion == ion))[0]
    lo = local[atom_data.line_lower_idx[line_ids]]
    up = local[atom_data.line_upper_idx[line_ids]]
    nu = atom_data.line_nu[line_ids]
    f_lu = atom_data.line_f_lu[line_ids]
    g_l, g_u = g[lo], g[up]

    if coronal_approximation:
        jb = np.zeros((len(line_ids), S))
    elif classical_nebular:
        jb = w[None, :] * intensity_black_body(nu[:, None], t_rad[None, :])
    else:
        jb = j_blues[line_ids]
    r_up, r_down = einstein_rates(nu, f_lu, g_l, g_u, jb)

    collisions = electron_densities is not None and t_electrons is not None
    tab = (tabulated_rates(atom_data, sel, local, g, t_electrons,
                           electron_densities) if collisions else None)
    if collisions:
        q_lu, u0 = van_regemorter(nu, f_lu, t_electrons,
                                  0.2 if ion == 0 else 0.7)
        c_lu = q_lu * electron_densities[None, :]
        # detailed balance: C_ul = C_lu (g_l / g_u) e^{u0}
        c_ul = c_lu * (g_l / g_u)[:, None] * np.exp(u0)
        if tab is not None:
            # a line whose level pair the table covers takes its rates
            # from the table's entry instead
            covered = np.isin(lo * K + up, tab[0] * K + tab[1])
            c_lu = np.where(covered[:, None], 0.0, c_lu)
            c_ul = np.where(covered[:, None], 0.0, c_ul)
    else:
        c_lu = c_ul = np.zeros((len(line_ids), S))

    bf = np.empty((K, S))
    for s in range(S):
        M = np.zeros((K, K))
        np.add.at(M, (lo, up), r_down[:, s] + c_ul[:, s])  # into l from u
        np.add.at(M, (up, lo), r_up[:, s] + c_lu[:, s])  # into u from l
        if tab is not None:
            t_lo, t_up, t_lu, t_ul = tab
            np.add.at(M, (t_lo, t_up), t_ul[:, s])
            np.add.at(M, (t_up, t_lo), t_lu[:, s])
        n = np.clip(solve_closed(M), 1e-300, None)
        bf[:, s] = n / n[0] * g[0]
    return level_idx, bf
