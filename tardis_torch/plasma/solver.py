"""Plasma solve: host ionization balance, device line tables (kernel K3).

Counterpart of ``tardis_tpu/plasma/solver.py``: LTE / dilute-LTE /
nebular ionization and excitation, blackbody, dilute-blackbody or
``detailed`` radiative rates, NLTE species (``plasma/nlte.py``) and the
two helium treatments (``plasma/helium.py``).  The level populations come
from the host numpy ladder of ``plasma/lte.py`` (shells x levels, small),
with the NLTE and helium rows solved on the host in f64 as the JAX package
does; the (L, S) line tables and the per-shell tau prefix come from K3 in
f64 on the solver's device.  Under ``detailed`` rates K3 takes the
estimator j_blues where they are positive (``line_tables(...,
j_estimators=...)``).  There is one line mode: the JAX package's host /
device split and its native host pass do not exist here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tardis_torch import tracing
from tardis_torch.atomic.atom_data import AtomData
from tardis_torch.model.state import SimulationState
from tardis_torch.plasma import helium, lte
from tardis_torch.plasma.line_tables import LineStatic, line_tables
from tardis_torch.plasma.nlte import nlte_level_boltzmann_factor


@dataclass
class PlasmaState:
    t_rad: np.ndarray  # (S,)
    w: np.ndarray  # (S,)
    t_electrons: np.ndarray  # (S,)
    electron_densities: np.ndarray  # (S,)
    ion_number_density: np.ndarray  # (I_tot, S)
    level_number_density: np.ndarray  # (N, S)
    partition_function: np.ndarray  # (Sp, S)
    tau_sobolev: torch.Tensor  # (L, S) f64
    stimulated_emission_factor: torch.Tensor  # (L, S) f64
    beta_sobolev: torch.Tensor  # (L, S) f64
    j_blues: torch.Tensor  # (L, S) f64
    tau_prefix: torch.Tensor  # (S, L+1) f64 inclusive prefix, leading 0


class PlasmaSolver:
    """LTE / dilute-LTE / nebular plasma solver over flat atomic arrays."""

    def __init__(
        self,
        atom_data: AtomData,
        simulation_state: SimulationState,
        device,
        ionization: str = "lte",
        excitation: str = "lte",
        radiative_rates_type: str = "dilute-blackbody",
        link_t_rad_t_electron: float = 0.9,
        w_epsilon: float = 1e-10,
        electron_densities: np.ndarray | None = None,
        nlte_species: list | None = None,
        nlte_coronal_approximation: bool = False,
        nlte_classical_nebular: bool = False,
        helium_treatment: str = "none",
        heating_rate_data_file: str | None = None,
    ):
        if ionization not in ("lte", "nebular"):
            raise ValueError(f"ionization {ionization!r}")
        if excitation not in ("lte", "dilute-lte"):
            raise ValueError(f"excitation {excitation!r}")
        if radiative_rates_type not in ("blackbody", "dilute-blackbody",
                                        "detailed"):
            raise ValueError(
                f"radiative_rates_type {radiative_rates_type!r}")
        if helium_treatment not in ("none", "recomb-nlte", "numerical-nlte"):
            raise ValueError(f"helium_treatment {helium_treatment!r}")
        self.nlte_species = [tuple(int(v) for v in sp)
                             for sp in nlte_species or []]
        if helium_treatment != "none" and (2, 0) in self.nlte_species:
            raise ValueError(
                "helium_treatment and He in nlte_species are exclusive")
        self.atom = atom_data
        self.device = torch.device(device)
        self.ionization = ionization
        self.excitation = excitation
        self.radiative_rates_type = radiative_rates_type
        self.link_t_rad_t_electron = link_t_rad_t_electron
        self.w_epsilon = w_epsilon
        self.time_explosion = simulation_state.time_explosion
        self._fixed_electron_densities = electron_densities
        self.nlte_coronal_approximation = nlte_coronal_approximation
        self.nlte_classical_nebular = nlte_classical_nebular
        self.helium_treatment = helium_treatment
        # the reference streams this table to its external helium solver;
        # the in-framework solve takes it and does not read it
        self.heating_rate_data = (
            np.loadtxt(heating_rate_data_file, unpack=True)
            if heating_rate_data_file else None)
        self._last_n_e = None
        # the n_e the last solve's fixpoint started from: a checkpoint
        # keeps it, so a resumed run repeats that solve bit for bit
        self._n_e_seed_used = None
        self.line_static = LineStatic.from_atom_data(atom_data, self.device)
        self._build_index_maps(simulation_state)

    def _build_index_maps(self, state: SimulationState):
        atom = self.atom
        self._species_lookup = {
            (int(z), int(i)): s
            for s, (z, i) in enumerate(zip(atom.species_z, atom.species_ion))
        }
        comp = state.composition
        present = [
            (e, z)
            for e, z in enumerate(comp.atomic_numbers)
            if np.any(atom.species_z == z)
        ]
        self.element_z = np.array([z for _, z in present], dtype=np.int64)
        comp_rows = np.array([e for e, _ in present], dtype=np.int64)
        masses = np.array(
            [atom.masses[np.searchsorted(atom.atomic_numbers, z)]
             for z in self.element_z]
        )
        # (E, S) element number densities, aligned with self.element_z
        self.number_density = (
            comp.mass_fractions[comp_rows]
            * comp.density[None, :]
            / masses[:, None]
        )

        # ionization ladder: consecutive species pairs of each element
        ion_lookup = {
            (int(z), int(j)): chi
            for z, j, chi in zip(
                atom.ionization_z, atom.ionization_ion, atom.ionization_energy
            )
        }
        pairs_upper, pairs_lower, pair_chi = [], [], []
        block_start = [0]
        for z in self.element_z:
            stages = sorted(
                int(i) for i in atom.species_ion[atom.species_z == z]
            )
            for j0, j1 in zip(stages[:-1], stages[1:]):
                if j1 != j0 + 1:
                    raise ValueError(f"non-contiguous ion stages for Z={z}")
                pairs_lower.append(self._species_lookup[(int(z), j0)])
                pairs_upper.append(self._species_lookup[(int(z), j1)])
                pair_chi.append(ion_lookup[(int(z), j1)])
            block_start.append(len(pairs_upper))
        self.pair_upper = np.array(pairs_upper, dtype=np.int64)
        self.pair_lower = np.array(pairs_lower, dtype=np.int64)
        self.pair_chi = np.array(pair_chi, dtype=np.float64)
        self.element_block_start = np.array(block_start, dtype=np.int64)

        ion_row = {}
        for e, z in enumerate(self.element_z):
            stages = sorted(
                int(i) for i in atom.species_ion[atom.species_z == z]
            )
            base = self.element_block_start[e] + e
            for k, j in enumerate(stages):
                ion_row[(int(z), j)] = base + k
        self.species_ion_row = np.array(
            [ion_row[(int(z), int(i))]
             for z, i in zip(atom.species_z, atom.species_ion)],
            dtype=np.int64,
        )

        self._zeta_tables = None
        if self.ionization == "nebular":
            tables = []
            for z in self.element_z:
                stages = sorted(
                    int(i) for i in atom.species_ion[atom.species_z == z]
                )
                for j in stages[1:]:
                    tables.append((atom.zeta_data or {}).get((int(z), j)))
            self._zeta_tables = tables

    def _zeta(self, t_rad: np.ndarray) -> np.ndarray:
        out = np.ones((len(self.pair_chi), len(t_rad)))
        for i, zd in enumerate(self._zeta_tables):
            if zd is None:
                continue
            ts, vals = zd
            out[i] = np.interp(t_rad, ts, vals, left=np.nan, right=np.nan)
        out[np.isnan(out)] = 1.0
        return out

    def update(self, t_rad: np.ndarray, w: np.ndarray,
               j_blues=None) -> PlasmaState:
        """Recompute the plasma state for the given radiation field.

        ``j_blues`` (L, S), the lines' mean intensities at their blue
        wings, as a numpy array or a tensor: under ``detailed`` rates the
        estimators, which K3 takes where they are positive (else
        ``w_epsilon`` W B_nu(T_rad)); the NLTE species and the numerical
        helium solve read them in place of the dilute-Planck field.  The
        Type IIP thermal balance sets ``link_t_rad_t_electron`` to a
        per-shell array and ``_fixed_electron_densities`` to its n_e.
        """
        atom = self.atom
        seed_n_e = self._last_n_e
        beta = lte.beta_rad(t_rad)
        t_electrons = self.link_t_rad_t_electron * t_rad
        beta_el = lte.beta_rad(t_electrons)
        jb_host = None
        if j_blues is not None and (
                self.nlte_species
                or self.helium_treatment == "numerical-nlte"):
            if isinstance(j_blues, torch.Tensor):
                with tracing.sync("plasma.j_blues"):
                    jb_host = j_blues.cpu().numpy()
            else:
                jb_host = np.asarray(j_blues, np.float64)

        w_excitation = w if self.excitation == "dilute-lte" else None
        bf = lte.level_boltzmann_factor(
            atom.level_energy, atom.level_g, atom.level_meta, beta,
            w_excitation,
        )
        if self.nlte_species:
            # the NLTE rows replace the species' LTE rows before the
            # partition function; collisions take the previous solve's n_e
            with tracing.span("tardis.nlte"):
                jb_nlte = (lte.dilute_planck_j_blues(atom.line_nu, t_rad, w)
                           if jb_host is None else jb_host)
                for species in self.nlte_species:
                    idx, rows = nlte_level_boltzmann_factor(
                        atom, species, t_rad, w, jb_nlte,
                        electron_densities=self._last_n_e,
                        t_electrons=t_electrons,
                        coronal_approximation=self.nlte_coronal_approximation,
                        classical_nebular=self.nlte_classical_nebular,
                    )
                    bf[idx] = rows
        z_part = lte.partition_function(
            bf, atom.level_species_id, len(atom.species_z)
        )
        g_el = lte.g_electron(beta)
        phi = lte.phi_saha_lte(
            g_el, beta, z_part, self.pair_chi, self.pair_upper,
            self.pair_lower,
        )
        if self.ionization == "nebular":
            delta = lte.radiation_field_correction(
                self.pair_chi, w, t_rad, t_electrons, beta, beta_el
            )
            zeta = self._zeta(t_rad)
            phi = lte.phi_saha_nebular(phi, w, zeta, delta, t_rad,
                                       t_electrons)
        he = 2 in self.element_z
        he_override = None
        if self.helium_treatment == "recomb-nlte" and he:
            with tracing.span("tardis.helium"):
                ion_density, n_e, he_override = self._recomb_helium(
                    bf, g_el, beta, w, t_rad, t_electrons, phi,
                    (zeta, delta) if self.ionization == "nebular" else None)
        else:
            ion_density, n_e, _ = lte.ion_number_density(
                phi,
                self.element_block_start,
                self.number_density,
                n_electron_init=self._last_n_e,
                electron_densities=self._fixed_electron_densities,
            )
        self._n_e_seed_used = seed_n_e
        self._last_n_e = n_e
        n_level = lte.level_number_density(
            bf, z_part, ion_density[self.species_ion_row],
            atom.level_species_id,
        )
        if he_override is not None:
            self._set_helium_levels(n_level, *he_override)
        if self.helium_treatment == "numerical-nlte" and he:
            # the numerical solve overwrites the helium level and ion rows
            with tracing.span("tardis.helium"):
                jb_he = (lte.dilute_planck_j_blues(atom.line_nu, t_rad, w)
                         if jb_host is None else jb_host)
                e_he = int(np.where(self.element_z == 2)[0][0])
                rows_he, he_pops, he3_pop, he_ion = (
                    helium.helium_numerical_nlte(
                        atom, t_rad, w, t_electrons, n_e, jb_he,
                        self.number_density[e_he],
                        heating_rate_data=self.heating_rate_data))
                self._set_helium_levels(n_level, rows_he, he_pops, he3_pop)
                for stage in range(3):
                    sp = self._species_lookup.get((2, stage))
                    if sp is not None:
                        ion_density[self.species_ion_row[sp]] = he_ion[stage]

        jb_w = np.ones_like(w) if self.radiative_rates_type == "blackbody" \
            else w
        j_est = None
        if self.radiative_rates_type == "detailed" and j_blues is not None:
            with tracing.sync("plasma.j_estimators"):
                j_est = torch.as_tensor(j_blues, dtype=torch.float64,
                                        device=self.device).contiguous()
        with tracing.sync("plasma.level_pop"):
            level_pop = torch.as_tensor(n_level, dtype=torch.float64,
                                        device=self.device)
        lt = line_tables(
            self.line_static, level_pop, t_rad, jb_w, self.time_explosion,
            j_estimators=j_est, w_epsilon=self.w_epsilon,
        )
        return PlasmaState(
            t_rad=t_rad,
            w=w,
            t_electrons=t_electrons,
            electron_densities=n_e,
            ion_number_density=ion_density,
            level_number_density=n_level,
            partition_function=z_part,
            tau_sobolev=lt.tau,
            stimulated_emission_factor=lt.stim,
            beta_sobolev=lt.beta,
            j_blues=lt.j_blues,
            tau_prefix=lt.prefix,
        )

    def _recomb_helium(self, bf, g_el, beta, w, t_rad, t_electrons, phi,
                       nebular):
        """The n_e fixpoint with helium in the recombination approximation:
        (ion_density, n_e, (helium rows, their populations, He III))."""
        e_he = int(np.where(self.element_z == 2)[0][0])
        b0 = self.element_block_start[e_he]
        n_he_pairs = self.element_block_start[e_he + 1] - b0
        chi_he1 = float(self.pair_chi[b0])
        zeta22 = delta22 = np.ones_like(t_rad)
        chi_he2 = np.inf  # no He III channel in the atomic data
        if n_he_pairs > 1:
            chi_he2 = float(self.pair_chi[b0 + 1])
            if nebular is not None:
                zeta, delta = nebular
                zeta22, delta22 = zeta[b0 + 1], delta[b0 + 1]
        rows, rel, he3_rel, stage = helium.helium_relative_population(
            self.atom, bf, g_el, beta, w, t_rad, t_electrons, chi_he1,
            chi_he2, zeta22, delta22)
        if n_he_pairs < 2:
            he3_rel = np.zeros_like(he3_rel)
        ion_density, n_e, _, (pop, he3) = helium.ion_number_density_he_nlte(
            phi, self.element_block_start, self.number_density, e_he, rel,
            he3_rel, stage, n_electron_init=self._last_n_e,
            electron_densities=self._fixed_electron_densities)
        return ion_density, n_e, (rows, pop, he3)

    def _set_helium_levels(self, n_level, rows, pops, he3):
        """Write the helium level rows, and He III's ground level (its other
        levels empty)."""
        n_level[rows] = pops
        sp = self._species_lookup.get((2, 2))
        if sp is not None:
            rows3 = np.where(self.atom.level_species_id == sp)[0]
            if len(rows3):
                n_level[rows3] = 0.0
                n_level[rows3[0]] = he3
