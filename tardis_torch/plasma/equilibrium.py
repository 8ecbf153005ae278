"""Kinetic-equilibrium NLTE solver and thermal-balance solver.

Counterpart of ``tardis_tpu/plasma/equilibrium.py`` (the reference's
``tardis/plasma/equilibrium`` package: RateMatrix, LevelPopulationSolver,
IonPopulationSolver, ThermalBalanceSolver), host numpy f64 as there.  For
each treated element all levels of all its ion stages are coupled in one
statistical-equilibrium matrix per shell:

  * bound-bound radiative rates (A_ul, B_ul J, B_lu J) from the line list,
  * bound-bound collisional rates (van Regemorter, or the tabulated
    strengths where the atom data has them) scaled by n_e,
  * photoionization (gamma) and collisional ionization (n_e C_I),
  * spontaneous, stimulated and three-body recombination into each level,

with one conservation row (the populations sum to the element's number
density), solved as batched dense systems (``lstsq`` per shell where a
system is singular).  The electron density is iterated to charge
consistency.  The bound-free coefficients come from the port's
``ContinuumSolver`` (``plasma/continuum.py``), so an element needs
photoionization data to be treated.  No workflow of either package calls
this solver: it is an API.

``KineticEquilibriumSolver.apply_to_state`` writes the populations back
into a port ``PlasmaState`` and rebuilds its line tables with K3 on the
plasma solver's device, keeping the state's j_blues.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from tardis_torch.constants import K_B
from tardis_torch.plasma.continuum import (
    BETA_COLL,
    ContinuumSolver,
    interp_yg,
)
from tardis_torch.plasma.line_tables import line_tables
from tardis_torch.plasma.lte import intensity_black_body
from tardis_torch.plasma.nlte import einstein_rates, van_regemorter


@dataclass
class ElectronEnergyDistribution:
    """Electron energy distribution (cgs, per shell)."""

    energy: np.ndarray  # (S,) erg


@dataclass
class ThermalElectronEnergyDistribution(ElectronEnergyDistribution):
    """Maxwellian electrons: mean energy 3/2 k T_e, with temperature and
    number density per shell."""

    temperature: np.ndarray  # (S,) K
    number_density: np.ndarray  # (S,) cm^-3

    @classmethod
    def from_plasma_state(cls, plasma_state):
        t_e = plasma_state.t_electrons
        return cls(energy=1.5 * K_B * t_e, temperature=t_e,
                   number_density=plasma_state.electron_densities)


class KineticEquilibriumSolver:
    """Coupled level and ion statistical equilibrium of selected
    elements (by default every element with photoionization data)."""

    def __init__(self, atom_data, plasma_solver, elements=None):
        pi = atom_data.photo_ion
        if pi is None or pi.n_continua == 0:
            raise ValueError(
                "kinetic equilibrium requires photoionization data "
                "(generate the atomic set with continuum_species)")
        self.atom = atom_data
        self.plasma = plasma_solver
        self.cont = ContinuumSolver(atom_data, plasma_solver)
        cont_z = set(int(z) for z in pi.cont_z)
        if elements is None:
            elements = sorted(cont_z & set(int(z)
                                           for z in plasma_solver.element_z))
        for z in elements:
            if z not in cont_z:
                raise ValueError(f"no photoionization data for element Z={z}")
        self.elements = list(elements)
        self._elem = {z: self._element_map(z) for z in self.elements}

    def _element_map(self, z) -> dict:
        """Element ``z``'s levels ordered by (ion stage, level number), and
        its lines and continua in those local indices."""
        atom = self.atom
        pi = atom.photo_ion
        rows = np.where(atom.level_z == z)[0]
        rows = rows[np.lexsort((atom.level_number[rows],
                                atom.level_ion[rows]))]
        local = np.full(len(atom.level_z), -1, np.int64)
        local[rows] = np.arange(len(rows))
        stage_of = atom.level_ion[rows].astype(np.int64)
        # each stage's ground state: its first local index
        stages, ground = np.unique(stage_of, return_index=True)
        ground_of_stage = dict(zip(stages.tolist(), ground.tolist()))
        lids = np.where(atom.line_z == z)[0]
        cids = np.where(pi.cont_z == z)[0]
        return dict(
            rows=rows, lids=lids,
            lo=local[atom.line_lower_idx[lids]],
            up=local[atom.line_upper_idx[lids]],
            cids=cids, c_low=local[pi.level_flat_idx[cids]],
            c_up=np.array([ground_of_stage[int(j) + 1]
                           for j in pi.cont_ion[cids]], dtype=np.int64),
            stage_of=stage_of,
            e_idx=int(np.where(self.plasma.element_z == z)[0][0]),
        )

    def _bb_rates(self, em, t_rad, w, t_electrons, j_blues):
        """One element's line rates: (r_down, r_up, q_ul, q_lu), each
        (n_lines, S); the q's are collision coefficients [cm^3 / s] to be
        scaled by n_e (van Regemorter with g_bar 0.3, the tabulated
        strengths on the transitions the table covers)."""
        atom = self.atom
        lids = em["lids"]
        nu = atom.line_nu[lids]
        f_lu = atom.line_f_lu[lids]
        g_l = atom.level_g[atom.line_lower_idx[lids]]
        g_u = atom.level_g[atom.line_upper_idx[lids]]
        jb = (j_blues[lids] if j_blues is not None else
              w[None, :] * intensity_black_body(nu[:, None],
                                                t_rad[None, :]))
        r_up, r_down = einstein_rates(nu, f_lu, g_l, g_u, jb)
        q_lu, u0 = van_regemorter(nu, f_lu, t_electrons, 0.3)
        q_ul = q_lu * (g_l / g_u)[:, None] * np.exp(u0)

        coll = getattr(atom, "collision", None)
        if coll is not None and len(coll) > 0:
            pair_key = ((atom.line_lower_idx[lids].astype(np.int64) << 32)
                        | atom.line_upper_idx[lids].astype(np.int64))
            tab_key = ((coll.lower_flat.astype(np.int64) << 32)
                       | coll.upper_flat.astype(np.int64))
            order = np.argsort(tab_key)
            pos = np.clip(np.searchsorted(tab_key[order], pair_key), 0,
                          len(tab_key) - 1)
            hit = tab_key[order][pos] == pair_key
            if hit.any():
                yg = interp_yg(coll, t_electrons)[order[pos[hit]]]
                pref = BETA_COLL / np.sqrt(t_electrons)[None, :]
                q_lu[hit] = pref * yg * np.exp(-u0[hit])
                q_ul[hit] = pref * yg * (g_l[hit] / g_u[hit])[:, None]
        return r_down, r_up, q_ul, q_lu

    def solve(
        self,
        plasma_state,
        estimators=None,
        j_blues: np.ndarray | None = None,
        n_e_iterations: int = 30,
        n_e_threshold: float = 0.01,
        damping: float = 0.5,
        electron_distribution: ThermalElectronEnergyDistribution
        | None = None,
    ):
        """Level and ion populations of the treated elements and the
        electron density.

        ``estimators`` (ContinuumEstimators) replace the dilute-blackbody
        photoionization and stimulated-recombination rates where given;
        ``j_blues`` (L, S) the dilute-Planck field of the bound-bound
        rates.  Returns (level_pops, ion_pops, n_e): dicts by element Z of
        (K_z, S) level and (J_z + 1, S) stage populations, and the
        converged electron density (S,).
        """
        t_rad, w = plasma_state.t_rad, plasma_state.w
        dist = electron_distribution
        t_e = plasma_state.t_electrons if dist is None else dist.temperature
        n_e = np.array(plasma_state.electron_densities if dist is None
                       else dist.number_density, np.float64)
        S = len(t_rad)

        # the charge of the species not treated kinetically
        atom = self.atom
        charges = np.zeros(plasma_state.ion_number_density.shape[0])
        charges[self.plasma.species_ion_row] = atom.species_ion
        kinetic = np.zeros(len(charges), dtype=bool)
        kinetic[self.plasma.species_ion_row[
            np.isin(atom.species_z, self.elements)]] = True
        q_static = (plasma_state.ion_number_density
                    * np.where(kinetic, 0.0, charges)[:, None]).sum(axis=0)

        bb = {z: self._bb_rates(self._elem[z], t_rad, w, t_e, j_blues)
              for z in self.elements}
        level_pops, ion_pops = {}, {}
        for _ in range(n_e_iterations):
            cs = self.cont.update(
                dataclasses.replace(plasma_state, electron_densities=n_e),
                estimators)
            q_kin = np.zeros(S)
            for z in self.elements:
                em = self._elem[z]
                level_pops[z], ion_pops[z] = self._solve_element(
                    em, bb[z], cs, n_e, S)
                n_stages = ion_pops[z].shape[0]
                q_kin += (ion_pops[z] * np.arange(
                    n_stages, dtype=np.float64)[:, None]).sum(axis=0)
            n_e_new = np.maximum(q_static + q_kin, 1e-30)
            if np.all(np.abs(n_e_new - n_e) / np.maximum(n_e, 1e-30)
                      < n_e_threshold):
                n_e = n_e_new
                break
            n_e = damping * n_e_new + (1.0 - damping) * n_e
        return level_pops, ion_pops, n_e

    def _solve_element(self, em, bb, cs, n_e, S):
        """One element's (level populations (K, S), stage populations
        (J + 1, S)) at the electron density ``n_e``."""
        K = len(em["rows"])
        r_down, r_up, q_ul, q_lu = bb
        cids = em["cids"]
        ion_rate = cs.gamma[cids] + cs.coll_ion_coeff[cids] * n_e
        rec_rate = n_e[None, :] * (
            cs.alpha_sp[cids] + cs.alpha_stim[cids]
            + cs.coll_recomb_coeff[cids] * n_e[None, :])
        M = np.zeros((S, K, K))
        for dst, src, rates in (
                (em["lo"], em["up"], r_down + q_ul * n_e[None, :]),
                (em["up"], em["lo"], r_up + q_lu * n_e[None, :]),
                (em["c_up"], em["c_low"], ion_rate),
                (em["c_low"], em["c_up"], rec_rate)):
            np.add.at(M, (slice(None), dst, src), np.moveaxis(rates, -1, 0))
        # the diagonal: each state's total loss; row 0: conservation
        M[:, np.arange(K), np.arange(K)] -= M.sum(axis=1)
        M[:, 0, :] = 1.0
        rhs = np.zeros((S, K))
        rhs[:, 0] = self.plasma.number_density[em["e_idx"]]
        try:
            n = np.linalg.solve(M, rhs[..., None])[..., 0]
        except np.linalg.LinAlgError:
            n = np.stack([np.linalg.lstsq(M[s], rhs[s], rcond=None)[0]
                          for s in range(S)])
        n = np.clip(n.T, 0.0, None)  # (K, S)
        stage_of = em["stage_of"]
        ipop = np.stack([n[stage_of == j].sum(axis=0)
                         for j in range(stage_of.max() + 1)])
        return n, ipop

    def apply_to_state(self, plasma_state, level_pops, ion_pops, n_e):
        """A copy of ``plasma_state`` with the kinetic populations in the
        treated elements' level and ion rows, ``n_e``, and stim, tau, beta
        and the tau prefix rebuilt by K3 on the plasma solver's device; the
        j_blues stay the state's."""
        n_level = plasma_state.level_number_density.copy()
        ion_nd = plasma_state.ion_number_density.copy()
        for z in self.elements:
            n_level[self._elem[z]["rows"]] = level_pops[z]
            for j in range(ion_pops[z].shape[0]):
                sp = self.plasma._species_lookup.get((int(z), int(j)))
                if sp is not None:
                    ion_nd[self.plasma.species_ion_row[sp]] = ion_pops[z][j]
        pl = self.plasma
        lt = line_tables(
            pl.line_static,
            torch.as_tensor(n_level, dtype=torch.float64, device=pl.device),
            plasma_state.t_rad, plasma_state.w, pl.time_explosion)
        return dataclasses.replace(
            plasma_state, level_number_density=n_level,
            ion_number_density=ion_nd, electron_densities=n_e,
            stimulated_emission_factor=lt.stim, tau_sobolev=lt.tau,
            beta_sobolev=lt.beta, tau_prefix=lt.prefix)


class ThermalBalanceSolver:
    """The electron temperature where heating equals cooling (the
    continuum heating and cooling budget of the Type IIP workflow)."""

    def __init__(self, continuum_solver):
        self.cont = continuum_solver

    def solve(self, plasma_state, estimators, t_e_bounds=(0.3, 2.0),
              n_grid: int = 21) -> np.ndarray:
        """Per shell, the T_e of least |heating - cooling| / heating on a
        scan of T_e = factor * T_rad over ``t_e_bounds``."""
        best = np.full(len(plasma_state.t_rad), np.inf)
        t_best = plasma_state.t_electrons.copy()
        for f in np.linspace(t_e_bounds[0], t_e_bounds[1], n_grid):
            ps = dataclasses.replace(plasma_state,
                                     t_electrons=f * plasma_state.t_rad)
            cs = self.cont.update(ps, estimators)
            _, frac = self.cont.heating_minus_cooling(ps, cs, estimators)
            better = np.abs(frac) < best
            best = np.where(better, np.abs(frac), best)
            t_best = np.where(better, ps.t_electrons, t_best)
        return t_best
