"""Helium NLTE treatments: the recombination approximation and the
numerical solve.

Counterpart of ``tardis_tpu/plasma/helium.py`` (the reference's
``HeliumNLTE``, ``IonNumberDensityHeNLTE`` and ``HeliumNumericalNLTE``),
host numpy f64 as there.

``recomb-nlte``: the helium level populations are tied to the He II
ground state through detailed-balance recombination factors instead of
the Saha ladder, and the He ion populations, hence the free electrons,
are rebuilt from them inside the n_e fixpoint
(``ion_number_density_he_nlte``).

``numerical-nlte``: one statistical-equilibrium matrix per shell over [He
I levels | He II levels | He III ground], with bound-bound radiative and
collisional rates, hydrogenic photoionization, Milne-relation
recombination (spontaneous and stimulated) and Seaton collisional
ionization with three-body recombination by detailed balance
(``helium_numerical_nlte``); the reference hands this solve to an
external program.
"""

from __future__ import annotations

import numpy as np

from tardis_torch.constants import C, H, K_B, M_E
from tardis_torch.plasma.continuum import BETA_COLL, interp_yg
from tardis_torch.plasma.nlte import (
    CHI_H,
    einstein_rates,
    solve_closed,
    van_regemorter,
)

ION_ZERO_THRESHOLD = 1e-20
SIGMA_0 = 7.906e-18  # hydrogenic ground-state photoionization [cm^2]
SAHA_CONST = (H * H / (2.0 * np.pi * M_E * K_B)) ** 1.5  # cm^3 K^{3/2}


def species_rows(atom, ion: int) -> np.ndarray:
    """Flat level indices of helium's ion stage ``ion`` (empty if the data
    has no such species)."""
    for s, (z, j) in enumerate(zip(atom.species_z, atom.species_ion)):
        if z == 2 and j == ion:
            return np.where(atom.level_species_id == s)[0]
    return np.empty(0, np.int64)


def helium_relative_population(
    atom,
    bf: np.ndarray,  # (N_levels, S) level Boltzmann factors
    g_el: np.ndarray,  # (S,)
    beta_rad: np.ndarray,  # (S,)
    w: np.ndarray,  # (S,)
    t_rad: np.ndarray,  # (S,)
    t_electrons: np.ndarray,  # (S,)
    chi_he1: float,  # He I -> He II ionization energy [erg]
    chi_he2: float,  # He II -> He III
    zeta_he2: np.ndarray,  # (S,) zeta of (2, 2)
    delta_he2: np.ndarray,  # (S,) delta of (2, 2)
):
    """Helium level populations relative to the He II ground state (= 1):
    (rows (n,) flat level indices, rel (n, S), he3_rel (S,), stage (n,))."""
    rows_he1, rows_he2 = species_rows(atom, 0), species_rows(atom, 1)
    if len(rows_he1) == 0 or len(rows_he2) == 0:
        raise ValueError(
            "helium recomb-NLTE requires He I and He II level data")
    rows_he3 = species_rows(atom, 2)
    g_he2_ground = float(atom.level_g[rows_he2[0]])
    g_he3_ground = (float(atom.level_g[rows_he3[0]]) if len(rows_he3)
                    else 1.0)
    # He I excited states in recombination equilibrium with He II ground;
    # the approximation leaves He I's ground state empty
    he1 = (bf[rows_he1] / (2.0 * g_he2_ground) / g_el[None, :]
           / (w[None, :] ** 2) * np.exp(chi_he1 * beta_rad)[None, :])
    he1[0] = 0.0
    he2 = bf[rows_he2] / g_he2_ground
    he2[0] = 1.0
    he3 = (2.0 * (g_he3_ground / g_he2_ground) * g_el
           * np.exp(-chi_he2 * beta_rad) * w
           * (delta_he2 * zeta_he2 + w * (1.0 - zeta_he2))
           * np.sqrt(t_electrons / t_rad))
    stage = np.concatenate([np.zeros(len(rows_he1), np.int64),
                            np.ones(len(rows_he2), np.int64)])
    return (np.concatenate([rows_he1, rows_he2]),
            np.concatenate([he1, he2], axis=0), he3, stage)


def _update_he_population(rel, he3_rel, stage, n_e, n_he):
    """The relative populations scaled by n_e (He I) and normalised to
    the helium number density."""
    pop = np.where(stage[:, None] == 0, rel * n_e[None, :], rel)
    he3 = he3_rel / n_e
    total = pop.sum(axis=0) + he3
    scale = n_he / np.maximum(total, 1e-300)
    return pop * scale[None, :], he3 * scale


def ion_number_density_he_nlte(
    phi: np.ndarray,
    element_block_start: np.ndarray,
    number_density: np.ndarray,
    he_element_index: int,
    rel: np.ndarray,
    he3_rel: np.ndarray,
    stage: np.ndarray,
    n_electron_init: np.ndarray | None = None,
    electron_densities: np.ndarray | None = None,
    n_e_convergence_threshold: float = 0.05,
    max_iterations: int = 200,
):
    """The Saha ladder and its n_e fixpoint with the helium ion rows taken
    from the recombination approximation: (ion_density, n_e,
    ion_block_start, (he level populations (n, S), he3 (S,)))."""
    E, S = number_density.shape
    n_pairs = phi.shape[0]
    ion_block_start = element_block_start + np.arange(E + 1)
    n_he = number_density[he_element_index]
    o_he = ion_block_start[he_element_index]
    n_he_stages = ion_block_start[he_element_index + 1] - o_he

    def solve(n_e):
        phi_e = phi / n_e[None, :]
        ion_density = np.empty((n_pairs + E, S))
        for e in range(E):
            b0, b1 = element_block_start[e], element_block_start[e + 1]
            prod = np.cumprod(phi_e[b0:b1], axis=0)
            base = number_density[e] / (1.0 + prod.sum(axis=0))
            o0 = ion_block_start[e]
            ion_density[o0] = base
            ion_density[o0 + 1:o0 + 1 + (b1 - b0)] = base[None, :] * prod
        pop, he3 = _update_he_population(rel, he3_rel, stage, n_e, n_he)
        ion_density[o_he] = pop[stage == 0].sum(axis=0)
        if n_he_stages > 1:
            ion_density[o_he + 1] = pop[stage == 1].sum(axis=0)
        if n_he_stages > 2:
            ion_density[o_he + 2] = he3
        ion_density[ion_density < ION_ZERO_THRESHOLD] = 0.0
        return ion_density, pop, he3

    if electron_densities is not None:
        n_e = np.asarray(electron_densities, dtype=np.float64)
        ion_density, pop, he3 = solve(n_e)
        return ion_density, n_e, ion_block_start, (pop, he3)

    charges = np.concatenate([
        np.arange(ion_block_start[e + 1] - ion_block_start[e],
                  dtype=np.float64) for e in range(E)])
    n_e = (number_density.sum(axis=0) if n_electron_init is None
           else np.array(n_electron_init, dtype=np.float64))
    for _ in range(max_iterations):
        ion_density, pop, he3 = solve(n_e)
        n_e_new = (ion_density * charges[:, None]).sum(axis=0)
        if np.any(np.isnan(n_e_new)):
            raise RuntimeError("n_electron turned NaN in helium NLTE solve")
        if np.all(np.abs(n_e_new - n_e) / np.maximum(n_e, 1e-300)
                  < n_e_convergence_threshold):
            n_e = n_e_new
            break
        n_e = 0.5 * (n_e_new + n_e)
    ion_density, pop, he3 = solve(n_e)
    return ion_density, n_e, ion_block_start, (pop, he3)


def _bb_rate_entries(atom, rows, local, j_blues, t_electrons, n_e, g):
    """Bound-bound radiative and collisional rates of the lines inside the
    level set ``rows``: (lo, up) local indices, rate_up and rate_down (nl,
    S).  Van Regemorter takes g_bar per line from its lower level's ion
    (0.2 neutral, 0.7 ions); a line whose level pair the collision table
    covers takes the table's rates instead."""
    inset = np.zeros(len(atom.level_energy), dtype=bool)
    inset[rows] = True
    lids = np.nonzero(inset[atom.line_lower_idx]
                      & inset[atom.line_upper_idx])[0]
    S = len(t_electrons)
    if len(lids) == 0:
        e = np.empty(0, np.int64)
        return e, e, np.zeros((0, S)), np.zeros((0, S))
    lo = local[atom.line_lower_idx[lids]]
    up = local[atom.line_upper_idx[lids]]
    nu = atom.line_nu[lids]
    f_lu = atom.line_f_lu[lids]
    g_l, g_u = g[lo], g[up]
    r_up, r_down = einstein_rates(nu, f_lu, g_l, g_u, j_blues[lids])
    g_bar = np.where(atom.level_ion[atom.line_lower_idx[lids]] == 0,
                     0.2, 0.7)
    q_lu, u0 = van_regemorter(nu, f_lu, t_electrons, g_bar)
    c_lu = q_lu * n_e[None, :]
    c_ul = c_lu * (g_l / g_u)[:, None] * np.exp(u0)

    coll = getattr(atom, "collision", None)
    if coll is not None and len(coll) > 0:
        in_sp = inset[coll.lower_flat] & inset[coll.upper_flat]
        if in_sp.any():
            lo_f, up_f = coll.lower_flat[in_sp], coll.upper_flat[in_sp]
            yg_T = interp_yg(coll, t_electrons)[in_sp]  # (Nc, S)
            tab_lo, tab_up = local[lo_f], local[up_f]
            d_e = atom.level_energy[up_f] - atom.level_energy[lo_f]
            u0_t = np.minimum(
                d_e[:, None] / (K_B * t_electrons)[None, :], 500.0)
            pref = BETA_COLL / np.sqrt(t_electrons)[None, :]
            tc_lu = pref * yg_T * np.exp(-u0_t) * n_e[None, :]
            tc_ul = (pref * yg_T * (g[tab_lo] / g[tab_up])[:, None]
                     * n_e[None, :])
            # the table entry of each line's (lo, up) pair, -1 for none
            K = len(g)
            tab_keys = {int(a) * K + int(b): k
                        for k, (a, b) in enumerate(zip(tab_lo, tab_up))}
            cov_pos = np.array([tab_keys.get(int(p), -1)
                                for p in lo * K + up])
            covered = (cov_pos >= 0)[:, None]
            pos = np.maximum(cov_pos, 0)
            c_lu = np.where(covered, 0.0, c_lu)
            c_ul = np.where(covered, 0.0, c_ul)
            c_lu = c_lu + np.where(covered, tc_lu[pos], 0.0)
            c_ul = c_ul + np.where(covered, tc_ul[pos], 0.0)
    return lo, up, r_up + c_lu, r_down + c_ul


def _ionization_rates(chi_lvl, g_lvl, g_ion, z_core, t_rad, w, t_electrons,
                      n_e, n_nu=48):
    """Each level's ionization and recombination rates to the next ion's
    ground state [1/s]: (R_ion (K, S), R_rec (K, S)), R_rec per particle
    of the upper ion (n_e included).

    Hydrogenic Kramers cross-section sigma(nu) = sigma_0 n_eff / z^2
    (nu_th / nu)^3 from each level's threshold, on a log grid of ``n_nu``
    points to 40 nu_th; photoionization under J_nu = W B_nu(T_rad),
    recombination (spontaneous and stimulated) by the Milne relation at
    T_e, collisional ionization by Seaton's formula and three-body
    recombination by detailed balance."""
    chi = np.maximum(chi_lvl, 1e-13)
    nu_th = chi / H  # (K,)
    n_eff = z_core * np.sqrt(CHI_H / chi)
    sigma_th = SIGMA_0 * np.maximum(n_eff, 0.1) / z_core**2  # (K,)
    x = np.logspace(0.0, np.log10(40.0), n_nu)
    nu = nu_th[:, None] * x[None, :]  # (K, n)
    sig = sigma_th[:, None] * x[None, :] ** -3
    hk = H / K_B
    with np.errstate(over="ignore"):
        b_rad = (2.0 * H * nu**3 / C**2)[:, :, None] / np.expm1(
            np.minimum(hk * nu[:, :, None] / t_rad[None, None, :], 600.0))
    j_nu = w[None, None, :] * b_rad
    wgt = np.gradient(nu, axis=1)[:, :, None]  # d nu
    pref = 4.0 * np.pi * sig[:, :, None] / (H * nu)[:, :, None]
    r_pi = (pref * j_nu * wgt).sum(axis=1)  # (K, S)
    with np.errstate(over="ignore"):
        boltz_e = np.exp(-np.minimum(
            hk * nu[:, :, None] / t_electrons[None, None, :], 600.0))
        b_el = (2.0 * H * nu**3 / C**2)[:, :, None] / np.expm1(np.minimum(
            hk * nu[:, :, None] / t_electrons[None, None, :], 600.0))
    # (n_l / n_+ n_e) in LTE at T_e
    saha = ((g_lvl / (2.0 * g_ion))[:, None]
            * SAHA_CONST / t_electrons[None, :] ** 1.5
            * np.exp(np.minimum(chi[:, None] / (K_B * t_electrons)[None, :],
                                600.0)))
    r_rec_sp = saha * (pref * b_el * boltz_e * wgt).sum(axis=1)
    r_rec_st = saha * (pref * j_nu * boltz_e * wgt).sum(axis=1)
    # Seaton: C_I = 1.55e13 T_e^-1/2 g_bar sigma_th e^-u / u n_e, u =
    # chi / k T_e, g_bar = 0.1 z_core
    u = chi[:, None] / (K_B * t_electrons)[None, :]
    q_ci = (1.55e13 / np.sqrt(t_electrons)[None, :] * (0.1 * z_core)
            * sigma_th[:, None] * np.exp(-np.minimum(u, 600.0))
            / np.maximum(u, 1e-10))
    r_ion = r_pi + q_ci * n_e[None, :]
    r_3b = saha * q_ci * n_e[None, :]
    r_rec = (r_rec_sp + r_rec_st + r_3b) * n_e[None, :]
    return r_ion, r_rec


def helium_numerical_nlte(
    atom,
    t_rad: np.ndarray,  # (S,)
    w: np.ndarray,  # (S,)
    t_electrons: np.ndarray,  # (S,)
    n_e: np.ndarray,  # (S,)
    j_blues: np.ndarray,  # (L, S)
    n_he: np.ndarray,  # (S,) helium number density
    heating_rate_data: np.ndarray | None = None,
):
    """Helium level and ion populations from one rate matrix per shell
    over [He I levels | He II levels | He III ground], normalised to the
    helium number density.  ``heating_rate_data`` is taken for the JAX
    package's signature and not read.

    Returns (rows (flat He I + II level indices), level populations
    (n_rows, S), he3 (S,), ion populations (3, S))."""
    rows1, rows2 = species_rows(atom, 0), species_rows(atom, 1)
    if len(rows1) == 0 or len(rows2) == 0:
        raise ValueError("numerical helium NLTE requires He I and He II")
    K1, K2 = len(rows1), len(rows2)
    S = len(t_rad)
    n = K1 + K2 + 1
    rows = np.concatenate([rows1, rows2])
    local = np.full(len(atom.level_energy), -1, np.int64)
    local[rows] = np.arange(K1 + K2)
    g = atom.level_g[rows].astype(np.float64)
    lo, up, rate_up, rate_dn = _bb_rate_entries(
        atom, rows, local, j_blues, t_electrons, n_e, g)

    # He I levels -> He II ground (state K1), He II levels -> He III
    # ground (state K1 + K2)
    chi = {(int(z), int(j)): c for z, j, c in zip(
        atom.ionization_z, atom.ionization_ion, atom.ionization_energy)}
    chi1 = chi[(2, 1)] - atom.level_energy[rows1]
    chi2 = chi[(2, 2)] - atom.level_energy[rows2]
    ion1, rec1 = _ionization_rates(chi1, g[:K1], g[K1], 1.0, t_rad, w,
                                   t_electrons, n_e)
    ion2, rec2 = _ionization_rates(chi2, g[K1:K1 + K2], 1.0, 2.0, t_rad, w,
                                   t_electrons, n_e)

    pops = np.empty((n, S))
    for s in range(S):
        M = np.zeros((n, n))
        if len(lo):
            np.add.at(M, (up, lo), rate_up[:, s])
            np.add.at(M, (lo, up), rate_dn[:, s])
        M[K1, :K1] += ion1[:, s]
        M[:K1, K1] += rec1[:, s]
        M[K1 + K2, K1:K1 + K2] += ion2[:, s]
        M[K1:K1 + K2, K1 + K2] += rec2[:, s]
        pops[:, s] = np.clip(solve_closed(M), 0.0, None)

    pops *= n_he[None, :] / np.maximum(pops.sum(axis=0), 1e-300)
    he3 = pops[K1 + K2]
    ion_pops = np.stack([pops[:K1].sum(axis=0),
                         pops[K1:K1 + K2].sum(axis=0), he3])
    return rows, pops[:K1 + K2], he3, ion_pops
