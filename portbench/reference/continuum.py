"""Continuum (bound-free / free-free) plasma of the Type IIP workflow:
host numpy, f64, in continuum order (threshold frequency descending).

Written from TARDIS's legacy IIP plasma (tardis/iip_plasma/) and the
TypeIIPWorkflow's thermal balance, in the vectorized form both of the
repository's packages take, and kept here frozen so that a change to the
program cannot move it:

- the Saha factor at T_e of each continuum's bound level, phi_lucy;
- bound-free opacity at the tabulation points, chi_bf = x_sect (n_level
  - phi_lucy n_e n_ion_next e^{-h nu / k T_e}), clipped at 0;
- the free-bound emission CDF of each continuum (nu^3 x_sect
  e^{-h nu / k T_e}, cumulative trapezoids, normalized);
- the free-free factor n_e sum n_ion q^2 and its opacity factor over
  sqrt(T_e);
- rate coefficients: photoionization gamma from the estimators (with the
  stimulated-recombination correction) or from the dilute blackbody,
  spontaneous and stimulated recombination, Seaton collisional
  ionization, van Regemorter collisional excitation of the continuum
  species' lines (the benchmark's atomic data carries no tabulated
  collision strengths);
- cooling and heating rates, the rate-equation electron density and the
  thermal balance's fractional heating.

Ion densities are indexed by species (``Atoms.species`` rows), as the
reference's plasma keeps them.
"""

from dataclasses import dataclass

import numpy as np

from portbench.reference.constants import C, E_CHARGE, H, K_B, M_E

FF_OPAC_CONST = float((2.0 * np.pi / (3.0 * M_E * K_B)) ** 0.5 * 4.0
                      * E_CHARGE**6 / (3.0 * M_E * H * C))
C0_FF = 1.426e-27  # Osterbrock (1974) free-free cooling constant
C0_REGEMORTER = 5.465e-11
I_H = 2.1798724e-11  # erg


def beta_of(t):
    return 1.0 / (K_B * t)


def planck(nu, t):
    """B_nu(T), the exponent clipped at 700."""
    nu = np.asarray(nu, dtype=np.float64)
    b = H / (K_B * np.asarray(t, dtype=np.float64))
    return (2.0 * H * nu**3 / C**2) / np.expm1(np.minimum(nu * b, 700.0))


def trapz_blocks(values, nu, refs):
    """Trapezoids of (P, S) values over each block of points -> (C, S)."""
    P = len(nu)
    dnu = np.zeros(P)
    dnu[:-1] = nu[1:] - nu[:-1]
    dnu[refs[1:] - 1] = 0.0
    seg = 0.5 * (values[:-1] + values[1:]) * dnu[:-1, None]
    seg = np.concatenate([seg, np.zeros((1, seg.shape[1]))])
    csum = np.zeros((P + 1, values.shape[1]))
    np.cumsum(seg, axis=0, out=csum[1:])
    return csum[refs[1:]] - csum[refs[:-1]]


def cumtrapz_blocks(values, nu, refs):
    """Cumulative trapezoids within each block, 0 at its start -> (P, S)."""
    P = len(nu)
    dnu = np.zeros(P)
    dnu[:-1] = nu[1:] - nu[:-1]
    dnu[refs[1:] - 1] = 0.0
    seg = 0.5 * (values[:-1] + values[1:]) * dnu[:-1, None]
    seg = np.concatenate([np.zeros((1, seg.shape[1])), seg])
    csum = np.cumsum(seg, axis=0)
    block_of = np.repeat(np.arange(len(refs) - 1), np.diff(refs))
    return csum - csum[refs[:-1]][block_of]


@dataclass
class Estimators:
    """Normalized continuum estimators (C, S), ff_heating (S,)."""

    photo_ion: np.ndarray
    stim_recomb: np.ndarray
    bf_heating: np.ndarray
    stim_recomb_cooling: np.ndarray
    photo_ion_statistics: np.ndarray
    ff_heating: np.ndarray

    FIELDS = ("photo_ion", "stim_recomb", "bf_heating",
              "stim_recomb_cooling", "ff_heating")


@dataclass
class State:
    t_electrons: np.ndarray
    electron_densities: np.ndarray
    level_pop: np.ndarray  # (C, S)
    lte_pop_coef: np.ndarray  # (C, S)
    chi_bf: np.ndarray  # (P, S)
    fb_emission_cdf: np.ndarray  # (P, S)
    ff_opacity_factor: np.ndarray  # (S,)
    phi_lucy: np.ndarray
    gamma: np.ndarray
    alpha_sp: np.ndarray
    alpha_stim: np.ndarray
    coll_ion_coeff: np.ndarray
    coll_recomb_coeff: np.ndarray
    coll_exc_coeff: np.ndarray  # (Lc, S)
    coll_deexc_coeff: np.ndarray
    coll_line_ids: np.ndarray
    ff_cool_rate: np.ndarray
    fb_cool_rate: np.ndarray
    coll_exc_cool_rate: np.ndarray
    coll_deexc_heat_rate: np.ndarray
    coll_ion_cool_rate: np.ndarray
    coll_ion_heat_rate: np.ndarray

    COMPARED = ("chi_bf", "fb_emission_cdf", "ff_opacity_factor",
                "phi_lucy", "gamma", "alpha_sp", "alpha_stim",
                "coll_ion_coeff", "coll_exc_coeff", "ff_cool_rate",
                "fb_cool_rate", "coll_exc_cool_rate")


class Continua:
    """The static continuum structures of ``atoms``; ``update`` is one
    iteration's (or one thermal-balance evaluation's) continuum state."""

    def __init__(self, atoms):
        pi = atoms.photo_ion
        if pi is None:
            raise ValueError("the atomic data has no continua")
        self.atoms = atoms
        self.pi = pi
        self.n = len(pi["cont_z"])
        self.refs = np.asarray(pi["block_references"], np.int64)
        self.nu = pi["nu"]
        self.x_sect = pi["x_sect"]
        self.nu_i = self.nu[self.refs[:-1]]
        self.block_of = np.repeat(np.arange(self.n), np.diff(self.refs))
        sp = {(int(z), int(i)): k for k, (z, i) in enumerate(atoms.species)}
        self.species_of = sp
        self.lower = np.array([sp[(int(z), int(i))] for z, i in
                               zip(pi["cont_z"], pi["cont_ion"])])
        self.upper = np.array([sp[(int(z), int(i) + 1)] for z, i in
                               zip(pi["cont_z"], pi["cont_ion"])])
        self.chi = np.array([
            atoms.ion_energy[(atoms.ion_z == z) & (atoms.ion_stage == i + 1)]
            [0] for z, i in zip(pi["cont_z"], pi["cont_ion"])])
        self._alpha_sp_pref = 8.0 * np.pi * self.x_sect * self.nu**2 / C**2
        self._alpha_spE_pref = (8.0 * np.pi * H * self.x_sect * self.nu**3
                                / C**2 * (1.0 - self.nu_i[self.block_of]
                                          / self.nu))
        self._gamma_pref = 4.0 * np.pi * self.x_sect / (H * self.nu)
        charge_factor = np.where(pi["cont_ion"] == 0, 0.1,
                                 np.where(pi["cont_ion"] == 1, 0.2, 0.3))
        self._collion_base = (1.55e13 * self.x_sect[self.refs[:-1]]
                              * charge_factor)
        pairs = set((int(z), int(i)) for z, i in
                    zip(pi["cont_z"], pi["cont_ion"]))
        lmask = np.array([(int(z), int(i)) in pairs for z, i in
                          zip(atoms.line_z, atoms.line_ion)])
        lid = np.nonzero(lmask)[0].astype(np.int32)
        self.coll_line_ids = lid
        self._coll_nu = atoms.line_nu[lid]
        self._coll_f_lu = atoms.line_f_lu[lid]
        self._coll_gl = atoms.level_g[atoms.line_lower[lid]]
        self._coll_gu = atoms.level_g[atoms.line_upper[lid]]
        self._coll_lower = atoms.line_lower[lid]
        self._coll_upper = atoms.line_upper[lid]
        self._coll_gbar = np.where(atoms.line_ion[lid] == 0, 0.2, 0.7)

    def phi_lucy(self, t_e):
        a = self.atoms
        b = beta_of(t_e)
        bf = a.level_g[:, None] * np.exp(-np.outer(a.level_energy, b))
        z_part = np.zeros((len(a.species), bf.shape[1]))
        np.add.at(z_part, a.level_species, bf)
        g_el = (2.0 * np.pi * M_E / (b * H * H)) ** 1.5
        phi = ((z_part[self.upper] / z_part[self.lower]) * 2.0
               * g_el[None, :] * np.exp(-np.outer(self.chi, b)))
        return bf[self.pi["level"]] / (phi * z_part[self.lower])

    def boltz_points(self, t_e):
        u = np.minimum(self.nu[:, None] * (H / K_B) / t_e[None, :], 500.0)
        return np.exp(-u)

    def update(self, plasma, t_e, t_rad, w, est: Estimators | None) -> State:
        """``plasma``: the reference's plasma (n_e, ion by species,
        level_pop) of this field."""
        n_e = plasma.n_e
        phi_lucy = self.phi_lucy(t_e)
        n_level = plasma.level_pop[self.pi["level"]]
        n_ion = plasma.ion[self.upper]
        lte_pop_coef = phi_lucy * n_e[None, :] * n_ion
        boltz = self.boltz_points(t_e)
        bo = self.block_of
        chi_bf = np.clip(self.x_sect[:, None] * (
            n_level[bo] - lte_pop_coef[bo] * boltz), 0.0, None)
        em = (self.nu**3 * self.x_sect)[:, None] * boltz
        cdf = cumtrapz_blocks(em, self.nu, self.refs)
        totals = cdf[self.refs[1:] - 1][bo]
        with np.errstate(divide="ignore", invalid="ignore"):
            fb_cdf = np.where(totals > 0, cdf / totals, 0.0)
        fb_cdf[self.refs[1:] - 1] = 1.0
        charge = self.atoms.species[:, 1].astype(np.float64)
        ff_factor = n_e * (plasma.ion * charge[:, None] ** 2).sum(axis=0)
        alpha_sp = trapz_blocks(self._alpha_sp_pref[:, None] * boltz,
                                self.nu, self.refs) * phi_lucy
        if est is not None:
            ratio = np.where(n_level > 0, lte_pop_coef / n_level, 0.0)
            gamma = est.photo_ion - ratio * est.stim_recomb
            alpha_stim = est.stim_recomb * phi_lucy
        else:
            correction = 1.0 - (np.where(n_level > 0, lte_pop_coef / n_level,
                                         0.0)[bo] * boltz)
            j_nu = w[None, :] * planck(self.nu[:, None], t_rad[None, :])
            gamma = trapz_blocks(self._gamma_pref[:, None] * j_nu
                                 * correction, self.nu, self.refs)
            alpha_stim = trapz_blocks(
                self._gamma_pref[:, None] * w[None, :]
                * planck(self.nu[:, None], t_rad[None, :]) * boltz,
                self.nu, self.refs) * phi_lucy
        u0 = np.minimum(self.nu_i[:, None] * (H / K_B) / t_e[None, :], 500.0)
        coll_ion = (self._collion_base[:, None] * (1.0 / u0) * np.exp(-u0)
                    / np.sqrt(t_e)[None, :])
        de = H * self._coll_nu
        u0l = np.minimum(de[:, None] / (K_B * t_e)[None, :], 500.0)
        q_lu = (C0_REGEMORTER * np.sqrt(t_e)[None, :] * 14.5
                * self._coll_f_lu[:, None] * (I_H / de[:, None]) ** 2
                * u0l * np.exp(-u0l) * self._coll_gbar[:, None])
        q_ul = q_lu * (self._coll_gl / self._coll_gu)[:, None] * np.exp(u0l)
        alpha_sp_e = trapz_blocks(self._alpha_spE_pref[:, None] * boltz,
                                  self.nu, self.refs) * phi_lucy
        n_lo = plasma.level_pop[self._coll_lower]
        n_up = plasma.level_pop[self._coll_upper]
        e_ion = H * self.nu_i
        return State(
            t_electrons=t_e, electron_densities=n_e, level_pop=n_level,
            lte_pop_coef=lte_pop_coef, chi_bf=chi_bf, fb_emission_cdf=fb_cdf,
            ff_opacity_factor=ff_factor / np.sqrt(t_e), phi_lucy=phi_lucy,
            gamma=gamma, alpha_sp=alpha_sp, alpha_stim=alpha_stim,
            coll_ion_coeff=coll_ion, coll_recomb_coeff=coll_ion * phi_lucy,
            coll_exc_coeff=q_lu, coll_deexc_coeff=q_ul,
            coll_line_ids=self.coll_line_ids,
            ff_cool_rate=C0_FF * np.sqrt(t_e) * ff_factor,
            fb_cool_rate=alpha_sp_e * n_e[None, :] * n_ion,
            coll_exc_cool_rate=q_lu * n_e[None, :] * n_lo * de[:, None],
            coll_deexc_heat_rate=q_ul * n_e[None, :] * n_up * de[:, None],
            coll_ion_cool_rate=(n_level * n_e[None, :] * coll_ion
                                * e_ion[:, None]),
            coll_ion_heat_rate=(n_e[None, :] ** 2 * coll_ion * phi_lucy
                                * n_ion * e_ion[:, None]),
        )

    def rate_equation_n_e(self, plasma, cs: State):
        """The electron density of the continuum species' ionization
        balance by their rate equations, the other ions kept."""
        n_e = cs.electron_densities
        ion = plasma.ion.copy()
        groups = {}
        for c in range(self.n):
            key = (int(self.pi["cont_z"][c]), int(self.pi["cont_ion"][c]))
            groups.setdefault(key, []).append(c)
        for (z, j), cs_idx in groups.items():
            cs_idx = np.asarray(cs_idx)
            low, up = self.species_of[(z, j)], self.species_of[(z, j + 1)]
            n_low = ion[low]
            with np.errstate(divide="ignore", invalid="ignore"):
                f = np.where(n_low > 0, cs.level_pop[cs_idx] / n_low, 0.0)
            ion_rate = (f * (cs.gamma[cs_idx] + cs.coll_ion_coeff[cs_idx]
                             * n_e[None, :])).sum(axis=0)
            rec = (cs.alpha_sp[cs_idx] + cs.alpha_stim[cs_idx]
                   + cs.coll_recomb_coeff[cs_idx] * n_e[None, :]).sum(axis=0)
            with np.errstate(divide="ignore", invalid="ignore"):
                ratio = np.where((rec > 0) & (n_e > 0),
                                 np.clip(ion_rate, 0.0, None) / (rec * n_e),
                                 0.0)
            total = ion[low] + ion[up]
            ion[up] = total * ratio / (1.0 + ratio)
            ion[low] = total / (1.0 + ratio)
        charge = self.atoms.species[:, 1].astype(np.float64)
        return (ion * charge[:, None]).sum(axis=0)

    def fractional_heating(self, plasma, cs: State, est: Estimators):
        """(heating - cooling) / cooling of each shell: bound-free and
        free-free heating, collisional ionization and de-excitation against
        free-bound (spontaneous and stimulated), free-free, collisional
        ionization and excitation cooling."""
        n_e = cs.electron_densities
        n_ion = plasma.ion[self.upper]
        heating = ((est.bf_heating * cs.level_pop).sum(axis=0)
                   + est.ff_heating + cs.coll_ion_heat_rate.sum(axis=0)
                   + cs.coll_deexc_heat_rate.sum(axis=0))
        fb = cs.fb_cool_rate.sum(axis=0) + (
            est.stim_recomb_cooling * cs.phi_lucy * n_e[None, :] * n_ion
        ).sum(axis=0)
        cooling = (fb + cs.ff_cool_rate + cs.coll_ion_cool_rate.sum(axis=0)
                   + cs.coll_exc_cool_rate.sum(axis=0))
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = (heating - cooling) / cooling
        return np.where(np.isfinite(frac), frac, 1e-16)
