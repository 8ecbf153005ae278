"""Plasma solve: host ionization balance, device line tables (kernel K3).

Counterpart of ``tardis_tpu/plasma/solver.py`` for LTE / dilute-LTE /
nebular plasmas with blackbody or dilute-blackbody radiative rates.  The
level populations come from the host numpy ladder of ``plasma/lte.py``
(shells x levels, small); the (L, S) line tables and the per-shell tau
prefix come from K3 in f64 on the solver's device.  There is one line mode:
the JAX package's host / device split and its native host pass do not
exist here.

Not ported (raise ``NotImplementedError``): NLTE species, ``detailed``
radiative rates and the helium treatments.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tardis_torch.atomic.atom_data import AtomData
from tardis_torch.model.state import SimulationState
from tardis_torch.plasma import lte
from tardis_torch.plasma.line_tables import LineStatic, line_tables


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
    ):
        if ionization not in ("lte", "nebular"):
            raise ValueError(f"ionization {ionization!r}")
        if excitation not in ("lte", "dilute-lte"):
            raise ValueError(f"excitation {excitation!r}")
        if radiative_rates_type == "detailed":
            raise NotImplementedError(
                "plasma.radiative_rates_type 'detailed' is not ported"
            )
        if radiative_rates_type not in ("blackbody", "dilute-blackbody"):
            raise ValueError(
                f"radiative_rates_type {radiative_rates_type!r}"
            )
        self.atom = atom_data
        self.device = torch.device(device)
        self.ionization = ionization
        self.excitation = excitation
        self.radiative_rates_type = radiative_rates_type
        self.link_t_rad_t_electron = link_t_rad_t_electron
        self.w_epsilon = w_epsilon
        self.time_explosion = simulation_state.time_explosion
        self._fixed_electron_densities = electron_densities
        self._last_n_e = None
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
               j_blues: np.ndarray | None = None) -> PlasmaState:
        """Recompute the plasma state for the given radiation field.

        ``j_blues`` (L, S), the estimator mean intensities at the lines'
        blue wings, is read only by ``detailed`` radiative rates, which
        are refused; it is taken for the JAX package's signature.  The
        Type IIP thermal balance sets ``link_t_rad_t_electron`` to a
        per-shell array and ``_fixed_electron_densities`` to its n_e.
        """
        atom = self.atom
        beta = lte.beta_rad(t_rad)
        t_electrons = self.link_t_rad_t_electron * t_rad
        beta_el = lte.beta_rad(t_electrons)

        w_excitation = w if self.excitation == "dilute-lte" else None
        bf = lte.level_boltzmann_factor(
            atom.level_energy, atom.level_g, atom.level_meta, beta,
            w_excitation,
        )
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
            phi = lte.phi_saha_nebular(phi, w, self._zeta(t_rad), delta,
                                       t_rad, t_electrons)
        ion_density, n_e, _ = lte.ion_number_density(
            phi,
            self.element_block_start,
            self.number_density,
            n_electron_init=self._last_n_e,
            electron_densities=self._fixed_electron_densities,
        )
        self._last_n_e = n_e
        n_level = lte.level_number_density(
            bf, z_part, ion_density[self.species_ion_row],
            atom.level_species_id,
        )

        jb_w = np.ones_like(w) if self.radiative_rates_type == "blackbody" \
            else w
        lt = line_tables(
            self.line_static,
            torch.as_tensor(n_level, dtype=torch.float64, device=self.device),
            t_rad, jb_w, self.time_explosion,
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
