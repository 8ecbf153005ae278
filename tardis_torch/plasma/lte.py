"""LTE / dilute-LTE / nebular plasma physics as batched array functions.

Replaces the reference's networkx property graph
(tardis/plasma/base.py:21-230 and plasma/properties/*) with an
explicit vectorized pipeline over flat level/species arrays.  All functions are
pure; shapes: N = levels, Sp = species (Z, ion), S = shells, L = lines.

Physics formulas mirror:
- LevelBoltzmannFactorLTE/DiluteLTE  (plasma/properties/partition_function.py:32,88)
- PhiSahaLTE / PhiSahaNebular / RadiationFieldCorrection
  (plasma/properties/ion_population.py:37,125,185)
- IonNumberDensity n_e fixpoint      (ion_population.py:261-390)
- TauSobolev                          (opacities/tau_sobolev.py:20-75)
"""

from __future__ import annotations

import numpy as np

from tardis_torch.constants import C, H, K_B, M_E, SOBOLEV_COEFFICIENT

ION_ZERO_THRESHOLD = 1e-20


def beta_rad(t_rad: np.ndarray) -> np.ndarray:
    return 1.0 / (K_B * t_rad)


def level_boltzmann_factor(
    level_energy: np.ndarray,
    level_g: np.ndarray,
    level_meta: np.ndarray,
    beta: np.ndarray,
    w: np.ndarray | None = None,
) -> np.ndarray:
    """g * exp(-eps * beta); dilute-LTE multiplies non-metastable levels by W."""
    bf = level_g[:, None] * np.exp(-np.outer(level_energy, beta))
    if w is not None:
        bf = np.where(level_meta[:, None], bf, bf * w[None, :])
    return bf


def partition_function(bf: np.ndarray, level_species_id: np.ndarray, n_species: int):
    """Sum Boltzmann factors per species -> (Sp, S)."""
    out = np.zeros((n_species, bf.shape[1]))
    np.add.at(out, level_species_id, bf)
    return out


def g_electron(beta: np.ndarray) -> np.ndarray:
    """(2 pi m_e / (beta h^2))^(3/2) per shell."""
    return (2.0 * np.pi * M_E / (beta * H * H)) ** 1.5


def phi_saha_lte(
    g_el: np.ndarray,
    beta: np.ndarray,
    z_part: np.ndarray,
    chi: np.ndarray,
    upper_species: np.ndarray,
    lower_species: np.ndarray,
) -> np.ndarray:
    """Saha factor phi_j = n_j n_e / n_{j-1} for each ionization pair.

    Parameters
    ----------
    z_part : (Sp, S) partition functions
    chi : (I,) ionization energies [erg]
    upper_species, lower_species : (I,) species indices of ion j and j-1
    """
    ratio = z_part[upper_species] / z_part[lower_species]
    return ratio * 2.0 * g_el[None, :] * np.exp(-np.outer(chi, beta))


def radiation_field_correction(
    chi: np.ndarray,
    w: np.ndarray,
    t_rad: np.ndarray,
    t_electrons: np.ndarray,
    beta: np.ndarray,
    beta_el: np.ndarray,
    chi_0: float = 1.9020591570241798e-11,
    departure_coefficient: np.ndarray | None = None,
) -> np.ndarray:
    """Mazzali & Lucy (1993) delta factor, (I, S).

    (reference: plasma/properties/ion_population.py:185-258; default chi_0 is
    the Ca II threshold)
    """
    if departure_coefficient is None:
        departure_coefficient = 1.0 / w
    factor_a = t_electrons / (departure_coefficient * w * t_rad)

    delta = np.empty((len(chi), len(w)))
    ge = np.outer(chi, beta - beta_el)
    below = chi < chi_0
    delta[~below] = factor_a[None, :] * np.exp(ge[~below])
    delta[below] = (
        1.0
        - np.exp(np.outer(chi[below], beta) - beta[None, :] * chi_0)
        + factor_a[None, :]
        * np.exp(np.outer(chi[below], beta) - chi_0 * beta_el[None, :])
    )
    return delta


def phi_saha_nebular(
    phi_lte: np.ndarray,
    w: np.ndarray,
    zeta: np.ndarray,
    delta: np.ndarray,
    t_rad: np.ndarray,
    t_electrons: np.ndarray,
) -> np.ndarray:
    """phi = phi_lte * W * (zeta*delta + W*(1-zeta)) * sqrt(T_e/T_rad)."""
    return (
        phi_lte
        * w[None, :]
        * (zeta * delta + w[None, :] * (1.0 - zeta))
        * np.sqrt(t_electrons / t_rad)[None, :]
    )


def ion_number_density(
    phi: np.ndarray,
    element_block_start: np.ndarray,
    number_density: np.ndarray,
    n_electron_init: np.ndarray | None = None,
    electron_densities: np.ndarray | None = None,
    n_e_convergence_threshold: float = 0.05,
    max_iterations: int = 200,
):
    """Solve the Saha ladder + electron-density fixpoint.

    Parameters
    ----------
    phi : (I, S) Saha factors, grouped contiguously per element (the pairs of
        element e occupy rows element_block_start[e]:element_block_start[e+1],
        ordered by ion stage).
    element_block_start : (E+1,) int offsets into phi rows.
    number_density : (E, S) total element number densities.

    Returns
    -------
    ion_density : (I_tot, S) where I_tot = I + E (one extra row per element:
        stage 0 prepended to each block), grouped per element.
    n_electron : (S,)
    ion_block_start : (E+1,) offsets into ion_density rows.
    """
    E, S = number_density.shape
    n_pairs = phi.shape[0]
    ion_block_start = element_block_start + np.arange(E + 1)

    def solve(n_e):
        phi_e = phi / n_e[None, :]
        ion_density = np.empty((n_pairs + E, S))
        for e in range(E):
            b0, b1 = element_block_start[e], element_block_start[e + 1]
            prod = np.cumprod(phi_e[b0:b1], axis=0)
            base = number_density[e] / (1.0 + prod.sum(axis=0))
            o0 = ion_block_start[e]
            ion_density[o0] = base
            ion_density[o0 + 1 : o0 + 1 + (b1 - b0)] = base[None, :] * prod
        ion_density[ion_density < ION_ZERO_THRESHOLD] = 0.0
        return ion_density

    # charge of each ion row (stage number within its element block)
    charges = np.concatenate(
        [
            np.arange(
                ion_block_start[e + 1] - ion_block_start[e], dtype=np.float64
            )
            for e in range(E)
        ]
    )

    if electron_densities is not None:
        n_e = np.asarray(electron_densities, dtype=np.float64)
        return solve(n_e), n_e, ion_block_start

    n_e = (
        number_density.sum(axis=0)
        if n_electron_init is None
        else np.array(n_electron_init, dtype=np.float64)
    )
    for _ in range(max_iterations):
        ion_density = solve(n_e)
        new_n_e = (ion_density * charges[:, None]).sum(axis=0)
        if np.any(~np.isfinite(new_n_e)):
            raise FloatingPointError("n_electron diverged in ion balance")
        if np.all(np.abs(new_n_e - n_e) / np.maximum(n_e, 1e-300) < n_e_convergence_threshold):
            n_e = new_n_e
            break
        n_e = 0.5 * (new_n_e + n_e)
    return solve(n_e), n_e, ion_block_start


def level_number_density(
    bf: np.ndarray,
    z_part: np.ndarray,
    ion_density_per_species: np.ndarray,
    level_species_id: np.ndarray,
) -> np.ndarray:
    """n_level = (bf / Z_species) * N_ion, (N, S)."""
    frac = bf / z_part[level_species_id]
    return frac * ion_density_per_species[level_species_id]


def stimulated_emission_factor(
    n_lower: np.ndarray,
    n_upper: np.ndarray,
    g_lower: np.ndarray,
    g_upper: np.ndarray,
) -> np.ndarray:
    """1 - (g_l n_u) / (g_u n_l), clipped at 0 (no masers)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = (g_lower[:, None] * n_upper) / (g_upper[:, None] * n_lower)
    ratio = np.where(np.isfinite(ratio), ratio, 1.0)
    return np.clip(1.0 - ratio, 0.0, None)


def tau_sobolev(
    wavelength_cm: np.ndarray,
    f_lu: np.ndarray,
    time_explosion: float,
    n_lower: np.ndarray,
    stim_factor: np.ndarray,
) -> np.ndarray:
    """Sobolev line optical depth (L, S)."""
    tau = (
        SOBOLEV_COEFFICIENT
        * (wavelength_cm * f_lu)[:, None]
        * time_explosion
        * stim_factor
        * n_lower
    )
    if np.any(~np.isfinite(tau)):
        raise ValueError("non-finite tau_sobolev")
    return tau


def beta_sobolev(tau: np.ndarray) -> np.ndarray:
    """Escape probability (1 - exp(-tau))/tau with stable branches
    (reference opacities/tau_sobolev.py:77-90)."""
    out = np.empty_like(tau)
    big = tau > 1e3
    small = tau < 1e-4
    mid = ~(big | small)
    out[big] = 1.0 / tau[big]
    out[small] = 1.0 - 0.5 * tau[small]
    out[mid] = -np.expm1(-tau[mid]) / tau[mid]
    return out


def intensity_black_body(nu, t):
    """Planck B_nu(T) [erg s^-1 cm^-2 Hz^-1 sr^-1]."""
    nu = np.asarray(nu, dtype=np.float64)
    beta_ = H / (K_B * np.asarray(t, dtype=np.float64))
    return (2.0 * H * nu**3 / C**2) / np.expm1(
        np.minimum(nu * beta_, 700.0)
    )


def dilute_planck_j_blues(line_nu, t_rad, w):
    """j_blue = W * B_nu(T_rad) per (line, shell)."""
    return w[None, :] * intensity_black_body(
        line_nu[:, None], t_rad[None, :]
    )
