"""Continuum (bound-free / free-free) plasma quantities for the Type IIP
workflow: host numpy, f64.

Counterpart of ``tardis_tpu/plasma/continuum.py`` (``ContinuumState``,
``ContinuumEstimators``, ``ContinuumSolver``), copied: it runs on the host
in both packages, once per iteration and once per thermal-balance
evaluation, at (continua, shells) and (points, shells) sizes.  It is the
vectorized form of the reference's legacy IIP plasma
(tardis/iip_plasma/):

- bound-free opacity table chi_bf[point, shell]
  (IIpWorkflowContinuumConnectors, iip_plasma/properties/continuum.py:1503)
- free-bound emission CDF per continuum block
  (fb_emission_cdf, :1522-1536; consumed by sample_nu_free_bound,
   transport/montecarlo/interaction_events.py:40-57)
- free-free opacity/cooling factor (ff_cooling_factor, :1515-1519;
  ff_opacity_factor = ff_cooling_factor / sqrt(T_e))
- rate coefficients: photoionization gamma (estimator-based with stimulated-
  recombination correction, or dilute-blackbody model), spontaneous
  recombination alpha_sp, collisional ionization via the Seaton
  approximation, collisional excitation via van Regemorter,
- cooling/heating rates for the k-packet block and the thermal balance
  (ThermalBalanceTest, :744-1340).

Where the atom data carries tabulated collision strengths
(``AtomData.collision``, from a carsus file's ``collision_data``), a
transition whose (lower, upper) level pair has them takes the
interpolated strengths (Przybilla & Butler 2004 A2), as the JAX package
does; van Regemorter stays the fallback for the pairs without.

All quantities are flat (C, S) / (P, S) numpy arrays in continuum_idx order
(threshold frequency descending).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tardis_torch.atomic.atom_data import AtomData
from tardis_torch.constants import C, E_CHARGE, H, K_B, M_E
from tardis_torch.plasma import lte

# (2 pi / (3 m_e k_B))^1/2 * 4 e^6 / (3 m_e h c)
# (reference opacities/opacities.py:25-27, Eq. 6.1.8 of Boissier lecture notes)
FF_OPAC_CONST = float(
    (2.0 * np.pi / (3.0 * M_E * K_B)) ** 0.5
    * 4.0
    * E_CHARGE**6
    / (3.0 * M_E * H * C)
)
# Osterbrock (1974) free-free cooling constant
# (reference iip_plasma/continuum/constants.py:13)
C0_FF = 1.426e-27
# van Regemorter constant (iip_plasma/continuum/constants.py:14)
C0_REGEMORTER = 5.465e-11
I_H = 2.1798724e-11  # hydrogen ionization energy [erg]
# BETA_COLL = (h^4 / (8 k_B m_e^3 pi^3))^1/2, the tabulated-strength rate
# prefactor (reference equilibrium/rates/collision_strengths.py:62;
# Przybilla & Butler 2004 eq. A2)
BETA_COLL = float(np.sqrt(H**4 / (8.0 * K_B * M_E**3 * np.pi**3)))


def interp_yg(collision, t_electrons: np.ndarray) -> np.ndarray:
    """yg = Upsilon / g_l linearly interpolated in T_e -> (Nc, S), clipped
    to the tabulated range (the JAX package's ``plasma/nlte.py``
    ``interp_yg``; reference YgData, plasma/properties/atomic.py:646)."""
    temps = collision.temperatures
    t = np.clip(t_electrons, temps[0], temps[-1])
    pos = np.clip(np.searchsorted(temps, t), 1, len(temps) - 1)
    f = (t - temps[pos - 1]) / (temps[pos] - temps[pos - 1])
    return collision.yg[:, pos - 1] * (1.0 - f) + collision.yg[:, pos] * f


def _trapz_blocks(values: np.ndarray, nu: np.ndarray, refs: np.ndarray):
    """Trapezoid-integrate (P, S) values over CSR frequency blocks -> (C, S).

    Counterpart of integrate_array_by_level_groups
    (reference iip_plasma/properties/continuum.py:57-107).
    """
    P = len(nu)
    dnu = np.zeros(P)
    dnu[:-1] = nu[1:] - nu[:-1]
    dnu[refs[1:] - 1] = 0.0  # no segment across block boundaries
    seg = 0.5 * (values[:-1] + values[1:]) * dnu[:-1, None]
    seg = np.concatenate([seg, np.zeros((1, seg.shape[1]))])
    csum = np.zeros((P + 1, values.shape[1]))
    np.cumsum(seg, axis=0, out=csum[1:])
    return csum[refs[1:]] - csum[refs[:-1]]


def _cumtrapz_blocks(values: np.ndarray, nu: np.ndarray, refs: np.ndarray):
    """Per-point cumulative trapezoid within each block -> (P, S)."""
    P = len(nu)
    dnu = np.zeros(P)
    dnu[:-1] = nu[1:] - nu[:-1]
    dnu[refs[1:] - 1] = 0.0
    seg = 0.5 * (values[:-1] + values[1:]) * dnu[:-1, None]
    seg = np.concatenate([np.zeros((1, seg.shape[1])), seg])
    csum = np.cumsum(seg, axis=0)
    # zero at each block start
    block_of = np.repeat(np.arange(len(refs) - 1), np.diff(refs))
    return csum - csum[refs[:-1]][block_of]


@dataclass
class ContinuumState:
    """Per-iteration continuum quantities (continuum_idx-ordered)."""

    t_electrons: np.ndarray  # (S,)
    electron_densities: np.ndarray  # (S,)
    # kernel opacity coefficients: chi_bf(nu, s) =
    #   x_sect(nu) * (level_pop[c, s] - lte_pop_coef[c, s] * exp(-h nu/k T_e))
    level_pop: np.ndarray  # (C, S) bound-level number density
    lte_pop_coef: np.ndarray  # (C, S) = phi_lucy * n_e * n_ion_next
    chi_bf: np.ndarray  # (P, S) tabulated at the block grid (clipped >= 0)
    fb_emission_cdf: np.ndarray  # (P, S) normalized cumulative per block
    ff_opacity_factor: np.ndarray  # (S,) ff_cooling_factor / sqrt(T_e)
    # rate coefficients
    phi_lucy: np.ndarray  # (C, S)
    gamma: np.ndarray  # (C, S) stim-recomb-corrected photoionization
    alpha_sp: np.ndarray  # (C, S) spontaneous recombination
    alpha_stim: np.ndarray  # (C, S) stimulated recombination
    coll_ion_coeff: np.ndarray  # (C, S) Seaton
    coll_recomb_coeff: np.ndarray  # (C, S)
    coll_exc_coeff: np.ndarray  # (Lc, S) van Regemorter q_lu [cm^3/s]
    coll_deexc_coeff: np.ndarray  # (Lc, S)
    coll_line_ids: np.ndarray  # (Lc,) line ids of collisional transitions
    # cooling/heating rates [erg s^-1 cm^-3]
    ff_cool_rate: np.ndarray  # (S,)
    fb_cool_rate: np.ndarray  # (C, S)
    coll_exc_cool_rate: np.ndarray  # (Lc, S)
    coll_deexc_heat_rate: np.ndarray  # (Lc, S)
    coll_ion_cool_rate: np.ndarray  # (C, S)
    coll_ion_heat_rate: np.ndarray  # (C, S)
    p_fb_deactivation: np.ndarray  # (C, S)

    @property
    def total_cooling_rate(self) -> np.ndarray:
        return (
            self.ff_cool_rate
            + self.fb_cool_rate.sum(axis=0)
            + self.coll_exc_cool_rate.sum(axis=0)
            + self.coll_ion_cool_rate.sum(axis=0)
        )


@dataclass
class ContinuumEstimators:
    """Normalized MC continuum estimators (continuum_idx-ordered).

    Normalization per TypeIIPWorkflow.normalize_continuum_estimators
    (reference workflows/type_iip_workflow.py:748-801) is applied by the
    transport solver before these reach the plasma.
    """

    photo_ion: np.ndarray  # (C, S) photoionization rate coeff estimate
    stim_recomb: np.ndarray  # (C, S)
    bf_heating: np.ndarray  # (C, S) [erg s^-1 per target]
    stim_recomb_cooling: np.ndarray  # (C, S)
    photo_ion_statistics: np.ndarray  # (C, S) update counts
    ff_heating: np.ndarray  # (S,)


class ContinuumSolver:
    """Precomputes static photoionization structures; `update` is per-iteration.

    Parameters
    ----------
    atom_data : prepared AtomData with ``photo_ion`` tables
    plasma_solver : the PlasmaSolver owning species/ion index maps
    """

    def __init__(self, atom_data: AtomData, plasma_solver):
        pi = atom_data.photo_ion
        if pi is None:
            raise ValueError(
                "atom_data carries no photoionization tables; continuum "
                "transport requires them"
            )
        self.atom = atom_data
        self.plasma = plasma_solver
        self.pi = pi
        self.C_cont = pi.n_continua
        self.refs = pi.block_references.astype(np.int64)
        self.nu = pi.nu
        self.x_sect = pi.x_sect
        self.nu_i = pi.nu_threshold  # (C,)
        self.block_of = np.repeat(
            np.arange(self.C_cont), np.diff(self.refs)
        )

        # next-ion density row per continuum (plasma.ion_number_density rows)
        ion_row = {}
        for s, (z, i) in enumerate(
            zip(atom_data.species_z, atom_data.species_ion)
        ):
            ion_row[(int(z), int(i))] = int(plasma_solver.species_ion_row[s])
        self.next_ion_row = np.array(
            [
                ion_row[(int(z), int(i) + 1)]
                for z, i in zip(pi.cont_z, pi.cont_ion)
            ],
            dtype=np.int64,
        )
        self.lower_species_id = np.array(
            [
                plasma_solver._species_lookup[(int(z), int(i))]
                for z, i in zip(pi.cont_z, pi.cont_ion)
            ],
            dtype=np.int64,
        )
        # Saha pair index (pair upper species = next ion) per continuum
        pair_of_upper = {
            int(u): k for k, u in enumerate(plasma_solver.pair_upper)
        }
        self.pair_idx = np.array(
            [
                pair_of_upper[
                    plasma_solver._species_lookup[(int(z), int(i) + 1)]
                ]
                for z, i in zip(pi.cont_z, pi.cont_ion)
            ],
            dtype=np.int64,
        )

        # static spectral prefactors
        # alpha_sp integrand: 8 pi x_sect nu^2 / c^2
        # (SpontRecombRateCoeff, iip_plasma/properties/continuum.py:123-142)
        self._alpha_sp_pref = 8.0 * np.pi * self.x_sect * self.nu**2 / C**2
        # energy-weighted (cooling) integrand: 8 pi h x_sect nu^3 / c^2
        # * (1 - nu_i/nu)  (ThermalBalanceTest._get_photo_ion_thermal_data)
        self._alpha_spE_pref = (
            8.0
            * np.pi
            * H
            * self.x_sect
            * self.nu**3
            / C**2
            * (1.0 - self.nu_i[self.block_of] / self.nu)
        )
        # photoionization-from-J integrand: 4 pi x_sect / (h nu)
        self._gamma_pref = 4.0 * np.pi * self.x_sect / (H * self.nu)

        # Seaton collisional-ionization base coefficient
        # (CollIonRateCoeff, iip_plasma/properties/continuum.py:462-505)
        x_sect_th = self.x_sect[self.refs[:-1]]
        charge_factor = np.where(
            pi.cont_ion == 0, 0.1, np.where(pi.cont_ion == 1, 0.2, 0.3)
        )
        self._collion_base = 1.55e13 * x_sect_th * charge_factor  # (C,)

        # collisional bound-bound transitions: all lines of continuum species
        cont_pairs = set(
            (int(z), int(i)) for z, i in zip(pi.cont_z, pi.cont_ion)
        )
        lmask = np.array(
            [
                (int(z), int(i)) in cont_pairs
                for z, i in zip(atom_data.line_z, atom_data.line_ion)
            ]
        )
        self.coll_line_ids = np.nonzero(lmask)[0].astype(np.int32)
        lid = self.coll_line_ids
        self._coll_nu = atom_data.line_nu[lid]
        self._coll_f_lu = atom_data.line_f_lu[lid]
        self._coll_gl = atom_data.level_g[atom_data.line_lower_idx[lid]]
        self._coll_gu = atom_data.level_g[atom_data.line_upper_idx[lid]]
        self._coll_lower_flat = atom_data.line_lower_idx[lid]
        self._coll_upper_flat = atom_data.line_upper_idx[lid]
        self._coll_gbar = np.where(
            atom_data.line_ion[lid] == 0, 0.2, 0.7
        )
        # the row of each transition's (lower, upper) pair in the dataset's
        # collision-strength table, -1 where it has none (reference
        # CollExcRateCoeff, iip_plasma/properties/continuum.py:527-646)
        self._coll_yg_idx = np.full(len(lid), -1, np.int64)
        co = atom_data.collision
        if co is not None and len(co):
            pair_to_row = {(int(lf), int(uf)): i for i, (lf, uf) in
                           enumerate(zip(co.lower_flat, co.upper_flat))}
            for j in range(len(lid)):
                self._coll_yg_idx[j] = pair_to_row.get(
                    (int(self._coll_lower_flat[j]),
                     int(self._coll_upper_flat[j])), -1)

    # ------------------------------------------------------------------
    def phi_lucy(self, t_electrons: np.ndarray) -> np.ndarray:
        """Saha factor per continuum: n_level*/(n_ion_next n_e) at T_e (C, S).

        (PhiLucy, reference iip_plasma/properties/level_population.py:159-184)
        """
        atom = self.atom
        pl = self.plasma
        beta_el = lte.beta_rad(t_electrons)
        bf = lte.level_boltzmann_factor(
            atom.level_energy, atom.level_g, atom.level_meta, beta_el, None
        )
        z_part = lte.partition_function(
            bf, atom.level_species_id, len(atom.species_z)
        )
        g_el = lte.g_electron(beta_el)
        phi_te = lte.phi_saha_lte(
            g_el, beta_el, z_part, pl.pair_chi, pl.pair_upper, pl.pair_lower
        )  # (n_pairs, S)
        return bf[self.pi.level_flat_idx] / (
            phi_te[self.pair_idx] * z_part[self.lower_species_id]
        )

    # ------------------------------------------------------------------
    def boltz_points(self, t_electrons: np.ndarray) -> np.ndarray:
        """exp(-h nu / k T_e) at every tabulation point -> (P, S)."""
        u = np.minimum(
            self.nu[:, None] * (H / K_B) / t_electrons[None, :], 500.0
        )
        return np.exp(-u)

    def gamma_dilute_blackbody(self, w, t_rad, correction=None):
        """Photoionization rate coeff from a dilute-BB radiation field (C, S).

        (RadiativeIonization._calculate_rate_coefficient_dilute_blackbody,
         reference iip_plasma/continuum/radiative_processes.py:82-131)
        """
        j_nu = w[None, :] * lte.intensity_black_body(
            self.nu[:, None], t_rad[None, :]
        )
        integrand = self._gamma_pref[:, None] * j_nu
        if correction is not None:
            integrand = integrand * correction
        return _trapz_blocks(integrand, self.nu, self.refs)

    # ------------------------------------------------------------------
    def update(
        self,
        plasma_state,
        estimators: ContinuumEstimators | None = None,
    ) -> ContinuumState:
        """Build the full continuum state for one iteration."""
        atom = self.atom
        t_e = plasma_state.t_electrons
        n_e = plasma_state.electron_densities
        S = len(t_e)

        phi_lucy = self.phi_lucy(t_e)  # (C, S)
        n_level = plasma_state.level_number_density[
            self.pi.level_flat_idx
        ]  # (C, S)
        n_ion = plasma_state.ion_number_density[self.next_ion_row]  # (C, S)
        lte_pop_coef = phi_lucy * n_e[None, :] * n_ion  # (C, S)

        boltz = self.boltz_points(t_e)  # (P, S)

        # -------- bound-free opacity at the tabulation points
        # chi_bf = x_sect (n_level - n_level_lte_ratio e^{-h nu/kT_e})
        # (IIpWorkflowContinuumConnectors, continuum.py:1503-1509)
        chi_bf_raw = self.x_sect[:, None] * (
            n_level[self.block_of] - lte_pop_coef[self.block_of] * boltz
        )
        chi_bf = np.clip(chi_bf_raw, 0.0, None)

        # -------- free-bound emission CDF (normalized per block)
        # integrand nu^3 x_sect e^{-h nu/kT_e} (continuum.py:1522-1536)
        em_integrand = (self.nu**3 * self.x_sect)[:, None] * boltz
        cdf = _cumtrapz_blocks(em_integrand, self.nu, self.refs)
        totals = cdf[self.refs[1:] - 1][self.block_of]
        with np.errstate(divide="ignore", invalid="ignore"):
            fb_emission_cdf = np.where(totals > 0, cdf / totals, 0.0)
        fb_emission_cdf[self.refs[1:] - 1] = 1.0

        # -------- free-free factor: n_e sum_ions n_ion q^2
        # (get_ff_heating_norm_factor / ff_cooling_factor,
        #  reference workflows/type_iip_workflow.py:851-861)
        n_rows = plasma_state.ion_number_density.shape[0]
        ion_charges = np.zeros(n_rows)
        ion_charges[self.plasma.species_ion_row] = atom.species_ion
        ff_factor = n_e * (
            plasma_state.ion_number_density * ion_charges[:, None] ** 2
        ).sum(axis=0)
        ff_opacity_factor = ff_factor / np.sqrt(t_e)

        # -------- rate coefficients
        alpha_sp = (
            _trapz_blocks(self._alpha_sp_pref[:, None] * boltz, self.nu,
                          self.refs)
            * phi_lucy
        )
        if estimators is not None:
            ratio = np.where(n_level > 0, lte_pop_coef / n_level, 0.0)
            gamma = estimators.photo_ion - ratio * estimators.stim_recomb
            alpha_stim = estimators.stim_recomb * phi_lucy
        else:
            correction = 1.0 - (
                np.where(n_level > 0, lte_pop_coef / n_level, 0.0)[
                    self.block_of
                ]
                * boltz
            )
            gamma = self.gamma_dilute_blackbody(
                plasma_state.w, plasma_state.t_rad, correction
            )
            alpha_stim = (
                _trapz_blocks(
                    self._gamma_pref[:, None]
                    * plasma_state.w[None, :]
                    * lte.intensity_black_body(
                        self.nu[:, None], plasma_state.t_rad[None, :]
                    )
                    * boltz,
                    self.nu,
                    self.refs,
                )
                * phi_lucy
            )

        u0 = np.minimum(
            self.nu_i[:, None] * (H / K_B) / t_e[None, :], 500.0
        )
        coll_ion_coeff = (
            self._collion_base[:, None]
            * (1.0 / u0)
            * np.exp(-u0)
            / np.sqrt(t_e)[None, :]
        )
        coll_recomb_coeff = coll_ion_coeff * phi_lucy

        # -------- van Regemorter bound-bound collisions
        de = H * self._coll_nu
        u0l = np.minimum(de[:, None] / (K_B * t_e)[None, :], 500.0)
        q_lu = (
            C0_REGEMORTER
            * np.sqrt(t_e)[None, :]
            * 14.5
            * self._coll_f_lu[:, None]
            * (I_H / de[:, None]) ** 2
            * u0l
            * np.exp(-u0l)
            * self._coll_gbar[:, None]
        )
        # the tabulated strengths override van Regemorter wherever the
        # dataset has them (q_lu = beta_coll / sqrt(T_e) yg exp(-dE / kT_e))
        has_yg = self._coll_yg_idx >= 0
        if has_yg.any():
            yg = interp_yg(self.atom.collision, t_e)[self._coll_yg_idx[has_yg]]
            q_lu[has_yg] = (BETA_COLL / np.sqrt(t_e)[None, :] * yg
                            * np.exp(-u0l[has_yg]))
        coll_exc_coeff = q_lu
        coll_deexc_coeff = (
            q_lu * (self._coll_gl / self._coll_gu)[:, None] * np.exp(u0l)
        )

        # -------- cooling / heating rates
        ff_cool_rate = C0_FF * np.sqrt(t_e) * ff_factor
        alpha_sp_E = (
            _trapz_blocks(self._alpha_spE_pref[:, None] * boltz, self.nu,
                          self.refs)
            * phi_lucy
        )
        fb_cool_rate = alpha_sp_E * n_e[None, :] * n_ion
        n_lower_coll = plasma_state.level_number_density[
            self._coll_lower_flat
        ]
        n_upper_coll = plasma_state.level_number_density[
            self._coll_upper_flat
        ]
        coll_exc_cool_rate = (
            coll_exc_coeff * n_e[None, :] * n_lower_coll * de[:, None]
        )
        coll_deexc_heat_rate = (
            coll_deexc_coeff * n_e[None, :] * n_upper_coll * de[:, None]
        )
        e_ion = H * self.nu_i
        coll_ion_cool_rate = (
            n_level * n_e[None, :] * coll_ion_coeff * e_ion[:, None]
        )
        coll_ion_heat_rate = (
            n_e[None, :] ** 2
            * coll_ion_coeff
            * phi_lucy
            * n_ion
            * e_ion[:, None]
        )

        cool_fb_sp = alpha_sp * n_e[None, :] * n_ion
        tot = cool_fb_sp.sum(axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            p_fb_deactivation = np.where(tot > 0, cool_fb_sp / tot, 0.0)

        return ContinuumState(
            t_electrons=t_e,
            electron_densities=n_e,
            level_pop=n_level,
            lte_pop_coef=lte_pop_coef,
            chi_bf=chi_bf,
            fb_emission_cdf=fb_emission_cdf,
            ff_opacity_factor=ff_opacity_factor,
            phi_lucy=phi_lucy,
            gamma=gamma,
            alpha_sp=alpha_sp,
            alpha_stim=alpha_stim,
            coll_ion_coeff=coll_ion_coeff,
            coll_recomb_coeff=coll_recomb_coeff,
            coll_exc_coeff=coll_exc_coeff,
            coll_deexc_coeff=coll_deexc_coeff,
            coll_line_ids=self.coll_line_ids,
            ff_cool_rate=ff_cool_rate,
            fb_cool_rate=fb_cool_rate,
            coll_exc_cool_rate=coll_exc_cool_rate,
            coll_deexc_heat_rate=coll_deexc_heat_rate,
            coll_ion_cool_rate=coll_ion_cool_rate,
            coll_ion_heat_rate=coll_ion_heat_rate,
            p_fb_deactivation=p_fb_deactivation,
        )

    # ------------------------------------------------------------------
    def rate_equation_electron_density(
        self, plasma_state, cont_state: ContinuumState
    ) -> np.ndarray:
        """Electron density implied by the radiative/collisional ionization
        balance of the continuum species (S,).

        For each continuum species the ion ratio follows the rate equations
        (the IIP plasma's NLTE ionization, in place of Saha):

            n_up / n_low = sum_c f_c (gamma_c + C_ion,c n_e)
                           / (n_e sum_c (alpha_sp,c + alpha_stim,c
                                         + C_rec,c n_e))

        with f_c the bound-level fraction within the lower ion.  Charge
        conservation then yields the new n_e (non-continuum species keep
        their current ion splits).
        """
        n_e = cont_state.electron_densities
        S = len(n_e)
        ion_nd = plasma_state.ion_number_density.copy()

        pairs = {}
        for c in range(self.C_cont):
            key = (int(self.pi.cont_z[c]), int(self.pi.cont_ion[c]))
            pairs.setdefault(key, []).append(c)

        for (z, j), cs_idx in pairs.items():
            cs_idx = np.asarray(cs_idx)
            low_row = int(
                self.plasma.species_ion_row[
                    self.plasma._species_lookup[(z, j)]
                ]
            )
            up_row = int(
                self.plasma.species_ion_row[
                    self.plasma._species_lookup[(z, j + 1)]
                ]
            )
            n_low = ion_nd[low_row]
            n_lev = cont_state.level_pop[cs_idx]  # (k, S)
            with np.errstate(divide="ignore", invalid="ignore"):
                f = np.where(n_low > 0, n_lev / n_low, 0.0)
            ion_rate = (
                f
                * (
                    cont_state.gamma[cs_idx]
                    + cont_state.coll_ion_coeff[cs_idx] * n_e[None, :]
                )
            ).sum(axis=0)
            rec_coeff = (
                cont_state.alpha_sp[cs_idx]
                + cont_state.alpha_stim[cs_idx]
                + cont_state.coll_recomb_coeff[cs_idx] * n_e[None, :]
            ).sum(axis=0)
            with np.errstate(divide="ignore", invalid="ignore"):
                ratio = np.where(
                    (rec_coeff > 0) & (n_e > 0),
                    np.clip(ion_rate, 0.0, None) / (rec_coeff * n_e),
                    0.0,
                )
            total = ion_nd[low_row] + ion_nd[up_row]
            ion_nd[up_row] = total * ratio / (1.0 + ratio)
            ion_nd[low_row] = total / (1.0 + ratio)

        n_rows = ion_nd.shape[0]
        charges = np.zeros(n_rows)
        charges[self.plasma.species_ion_row] = self.atom.species_ion
        return (ion_nd * charges[:, None]).sum(axis=0)

    # ------------------------------------------------------------------
    def heating_minus_cooling(
        self,
        plasma_state,
        cont_state: ContinuumState,
        estimators: ContinuumEstimators,
        adiabatic_cooling: bool = False,
        time_explosion: float | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """(heating - cooling, fractional) per shell for the thermal balance.

        (ThermalBalanceTest.heating_function,
         reference iip_plasma/properties/continuum.py:1204-1340):
        heating = bf_heating + ff_heating + coll_ion_heating + coll_deexc
        cooling = fb + stim-recomb + ff + coll_ion + coll_exc
        [+ adiabatic 3 n_e k_B T_e / t_exp when enabled
         (_calculate_adiabatic_cooling, :1048-1062)]
        """
        t_e = cont_state.t_electrons
        n_e = cont_state.electron_densities
        n_ion = plasma_state.ion_number_density[self.next_ion_row]

        bf_heating = (estimators.bf_heating * cont_state.level_pop).sum(
            axis=0
        )
        # ff heating estimator carries 1/sqrt(T_e) * ff_factor normalization
        # applied by the transport solver
        ff_heating = estimators.ff_heating
        ff_cooling = cont_state.ff_cool_rate
        fb_cooling = cont_state.fb_cool_rate.sum(axis=0) + (
            estimators.stim_recomb_cooling
            * cont_state.phi_lucy
            * n_e[None, :]
            * n_ion
        ).sum(axis=0)
        coll_ion_heating = cont_state.coll_ion_heat_rate.sum(axis=0)
        coll_ion_cooling = cont_state.coll_ion_cool_rate.sum(axis=0)
        coll_exc_cooling = cont_state.coll_exc_cool_rate.sum(axis=0)
        coll_deexc_heating = cont_state.coll_deexc_heat_rate.sum(axis=0)

        total_heating = (
            bf_heating + ff_heating + coll_ion_heating + coll_deexc_heating
        )
        total_cooling = (
            fb_cooling + ff_cooling + coll_ion_cooling + coll_exc_cooling
        )
        if adiabatic_cooling:
            if time_explosion is None:
                raise ValueError(
                    "adiabatic_cooling requires time_explosion"
                )
            total_cooling = total_cooling + (
                3.0 * n_e * K_B * t_e / time_explosion
            )
        balance = total_heating - total_cooling
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = balance / total_cooling
        frac = np.where(np.isfinite(frac), frac, 1e-16)
        return balance, frac
