"""Simulation state: geometry + composition + radiation-field state.

Counterpart of the reference's ``SimulationState``
(tardis/model/base.py:35): holds the ejecta model (shell
velocities/densities/abundances as numpy cgs arrays) plus the mutable
radiation-field state (t_radiative, dilution_factor, t_inner) that the
convergence loop updates each iteration.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from tardis_torch.atomic.atom_data import SYMBOL_TO_Z
from tardis_torch.config.reader import parse_quantity
from tardis_torch.constants import B_WIEN, C, SIGMA_SB
from tardis_torch.model.decay import (
    fold_isotopes_into_elements,
    parse_isotope,
)
from tardis_torch.model.density import calculate_density
from tardis_torch.model.geometry import Radial1DGeometry


@dataclass
class Composition:
    """Elemental mass fractions and derived number densities per shell."""

    atomic_numbers: np.ndarray  # (E,)
    mass_fractions: np.ndarray  # (E, S) normalized
    density: np.ndarray  # (S,) g/cm^3

    def number_density(self, masses_g: np.ndarray) -> np.ndarray:
        """Number density per element per shell [1/cm^3].

        ``masses_g`` must align with ``atomic_numbers``.
        """
        return self.mass_fractions * self.density[None, :] / masses_g[:, None]


@dataclass
class SimulationState:
    geometry: Radial1DGeometry
    composition: Composition
    time_explosion: float  # s
    luminosity_requested: float  # erg/s
    t_inner: float  # K
    t_radiative: np.ndarray  # (S,) K
    dilution_factor: np.ndarray  # (S,)
    extra: dict = field(default_factory=dict)

    @property
    def no_of_shells(self) -> int:
        return self.geometry.no_of_shells

    @property
    def r_inner(self) -> np.ndarray:
        return self.geometry.r_inner

    @property
    def volume(self) -> np.ndarray:
        return self.geometry.volume

    @classmethod
    def from_config(cls, config, atom_data=None) -> "SimulationState":
        """Build the state from a validated config tree.

        Mirrors ``parse_simulation_state``
        (tardis/io/model/parse_simulation_state.py:9): a ``csvy_model``,
        a ``file`` structure read by ``io/model_readers.py``, or the
        'specific' structure type with uniform (isotope entries decayed
        to ``time_explosion``) or file abundances.
        """
        # top-level csvy_model key (reference SimulationState.from_csvy,
        # model/base.py:322) or structure.type 'file' with a filetype
        # (reference parse_geometry_configuration.py) dispatch to readers
        if config.get("csvy_model"):
            from tardis_torch.io.csvy import simulation_state_from_csvy

            return simulation_state_from_csvy(config.csvy_model, config)
        structure = config.model.structure
        if structure.get("type") == "file":
            return cls._from_file_structure(structure, config)
        vel = structure.velocity
        edges = np.linspace(vel.start, vel.stop, vel.num + 1)
        # density evaluated at the UNTRIMMED shell centres (the boundary
        # masking below trims shells geometrically without changing their
        # density, matching the reference's
        # parse_geometry_configuration boundary handling)
        v_mid_full = 0.5 * (edges[:-1] + edges[1:])
        density_full = calculate_density(
            structure.density, v_mid_full, config.supernova.time_explosion
        )

        # --- v_inner_boundary / v_outer_boundary masking (reference
        # parse_geometry_configuration.py: shells outside the window are
        # dropped; the partially-covered boundary shells are trimmed to
        # the boundary velocity)
        vib = structure.get("v_inner_boundary") or 0.0
        vob = structure.get("v_outer_boundary") or np.inf
        if vib > 0.0 or np.isfinite(vob):
            if vib >= vob:
                raise ValueError(
                    "v_inner_boundary must be < v_outer_boundary"
                )
            keep = (edges[1:] > vib) & (edges[:-1] < vob)
            if not keep.any():
                raise ValueError(
                    "no shells inside the v_inner/outer_boundary window"
                )
            idx = np.nonzero(keep)[0]
            new_edges = np.concatenate(
                [edges[idx[0] : idx[-1] + 2]]
            ).copy()
            new_edges[0] = max(new_edges[0], vib)
            new_edges[-1] = min(new_edges[-1], vob)
            edges = new_edges
            density_full = density_full[keep]
            keep_shells = keep
        else:
            keep_shells = np.ones(len(v_mid_full), bool)

        geometry = Radial1DGeometry.from_velocity_grid(
            edges, config.supernova.time_explosion
        )
        density = density_full
        S = geometry.no_of_shells

        abund_cfg = dict(config.model.abundances)
        abund_type = abund_cfg.pop("type", "uniform")
        if abund_type == "file":
            elements, mass_fractions = cls._read_abundance_file(
                abund_cfg, len(keep_shells), config
            )
            mass_fractions = mass_fractions[:, keep_shells]
        elif abund_type == "uniform":
            elements = []
            fractions = []
            isotopes = {}
            for sym, frac in abund_cfg.items():
                if sym in ("filename", "filetype", "model_isotope_time_0"):
                    continue
                z = SYMBOL_TO_Z.get(sym)
                if z is None:
                    if parse_isotope(sym) is not None:
                        isotopes[sym] = float(frac)
                        continue
                    raise ValueError(f"Unknown element symbol '{sym}'")
                elements.append(z)
                fractions.append(float(frac))
            if isotopes:
                # isotope entries decay along their chains from
                # model_isotope_time_0 to time_explosion and their products
                # fold into the elemental fractions (the reference's
                # IsotopeAbundances.decay; the file and csvy readers too);
                # the time is a quantity ("5 day") or seconds, where the
                # JAX package takes seconds only
                t0 = parse_quantity(
                    abund_cfg.get("model_isotope_time_0", 0.0))
                t_exp = config.supernova.time_explosion
                elements, fractions = fold_isotopes_into_elements(
                    elements, fractions, isotopes, max(t_exp - t0, 0.0)
                )
                fractions = np.asarray(fractions, np.float64).reshape(
                    len(elements)
                )
            order = np.argsort(elements)
            elements = np.asarray(elements)[order]
            fractions = np.asarray(fractions)[order]
            norm = fractions.sum()
            if not np.isclose(norm, 1.0, atol=1e-8):
                fractions = fractions / norm
            mass_fractions = np.repeat(fractions[:, None], S, axis=1)
        else:
            raise NotImplementedError(
                f"abundance type '{abund_type}'"
            )
        composition = Composition(
            atomic_numbers=np.asarray(elements),
            mass_fractions=mass_fractions,
            density=density,
        )

        # --- inner boundary temperature
        L = config.supernova.luminosity_requested
        r_inner0 = geometry.r_inner[0]
        if config.plasma.initial_t_inner > 0:
            t_inner = float(config.plasma.initial_t_inner)
        else:
            # Stefan-Boltzmann from requested luminosity
            t_inner = float((L / (4.0 * np.pi * r_inner0**2 * SIGMA_SB)) ** 0.25)

        # --- radiative temperature profile (Wien-scaled from t_inner,
        # reference io/model/parse_radiation_field_configuration.py:144-168)
        if config.plasma.initial_t_rad > 0:
            t_radiative = np.full(S, float(config.plasma.initial_t_rad))
        else:
            lambda_wien_inner = B_WIEN / t_inner
            t_radiative = B_WIEN / (
                lambda_wien_inner
                * (1.0 + (geometry.v_middle - geometry.v_inner[0]) / C)
            )

        dilution_factor = geometry.geometric_dilution_factor()

        return cls(
            geometry=geometry,
            composition=composition,
            time_explosion=geometry.time_explosion,
            luminosity_requested=L,
            t_inner=t_inner,
            t_radiative=t_radiative,
            dilution_factor=dilution_factor,
        )

    @classmethod
    def _read_abundance_file(cls, abund_cfg, n_shells_full, config):
        """``abundances: {type: file}`` for specific-structure models.

        simple_ascii (reference readers/generic_readers.py
        read_simple_ascii_mass_fractions): whitespace table whose FIRST
        data row describes the centre of the model (unused); each later
        row is ``shell_index X_Z1 X_Z2 ...`` with one column per atomic
        number starting at Z=1.  artis: one row per shell, 30 elemental
        columns after the index (readers/artis.py).
        """
        filename = abund_cfg.get("filename")
        if not filename:
            raise ValueError("abundances type 'file' requires 'filename'")
        filetype = abund_cfg.get("filetype") or "simple_ascii"
        data = np.atleast_2d(np.loadtxt(filename))
        if filetype == "simple_ascii":
            mf = data[1:, 1:].T  # drop centre row + index column -> (Z, S)
        elif filetype == "artis":
            mf = (data[:, 1:] if data.shape[1] == 31 else data).T
        else:
            raise NotImplementedError(
                f"abundance filetype '{filetype}'"
            )
        if mf.shape[1] != n_shells_full:
            raise ValueError(
                f"abundance file has {mf.shape[1]} shells; the model "
                f"structure has {n_shells_full}"
            )
        zs = np.arange(1, mf.shape[0] + 1)
        present = mf.sum(axis=1) > 0
        mf = np.asarray(mf[present], np.float64)
        zs = zs[present]
        norm = mf.sum(axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            mf = np.where(norm > 0, mf / norm, 0.0)
        return zs, mf

    @classmethod
    def _from_file_structure(cls, structure, config) -> "SimulationState":
        """structure: {type: file, filename, filetype} dispatch
        (reference io/model/parse_geometry_configuration.py + readers/).

        ``v_inner_boundary`` / ``v_outer_boundary`` apply to file-based
        structures too: the reader builds the full model, then the state is
        trimmed to the velocity window.
        """
        filetype = structure.get("filetype", "csvy")
        filename = structure.filename

        def _windowed(state):
            vib = structure.get("v_inner_boundary") or 0.0
            vob = structure.get("v_outer_boundary") or np.inf
            if vib > 0.0 or np.isfinite(vob):
                state = state.masked_to_velocity_window(vib, vob, config)
            return state

        if filetype == "csvy":
            from tardis_torch.io.csvy import simulation_state_from_csvy

            return _windowed(simulation_state_from_csvy(filename, config))
        if filetype in ("artis", "simple_ascii"):
            from tardis_torch.io.model_readers import (
                simulation_state_from_artis,
            )

            abund = config.model.abundances
            if abund.get("type") != "file":
                raise ValueError(
                    f"{filetype} density files require a file-type "
                    "abundances section"
                )
            return _windowed(
                simulation_state_from_artis(filename, abund.filename,
                                            config)
            )
        if filetype in ("cmfgen", "cmfgen_model"):
            from tardis_torch.io.model_readers import (
                simulation_state_from_cmfgen,
            )

            return _windowed(simulation_state_from_cmfgen(filename, config))
        if filetype == "blondin_toymodel":
            from tardis_torch.io.model_readers import (
                simulation_state_from_blondin,
            )

            return _windowed(
                simulation_state_from_blondin(filename, config)
            )
        raise ValueError(f"unknown model filetype {filetype!r}")

    def masked_to_velocity_window(self, vib: float, vob: float,
                                  config) -> "SimulationState":
        """Trim a built state to the [v_inner_boundary, v_outer_boundary]
        window (reference parse_geometry_configuration boundary handling):
        shells outside are dropped, partially-covered edge shells are
        trimmed to the boundary velocity, and t_inner is recomputed from
        the requested luminosity at the new inner radius (unless pinned by
        plasma.initial_t_inner)."""
        import dataclasses

        g = self.geometry
        if vib >= vob:
            raise ValueError("v_inner_boundary must be < v_outer_boundary")
        keep = (g.v_outer > vib) & (g.v_inner < vob)
        if not keep.any():
            raise ValueError(
                "no shells inside the v_inner/outer_boundary window"
            )
        idx = np.nonzero(keep)[0]
        edges = np.concatenate(
            [g.v_inner[idx[0] : idx[-1] + 1], [g.v_outer[idx[-1]]]]
        ).copy()
        edges[0] = max(edges[0], vib)
        edges[-1] = min(edges[-1], vob)
        geometry = Radial1DGeometry.from_velocity_grid(
            edges, self.time_explosion
        )
        composition = Composition(
            atomic_numbers=self.composition.atomic_numbers,
            mass_fractions=self.composition.mass_fractions[:, keep],
            density=self.composition.density[keep],
        )
        initial_t_inner = float(
            config.plasma.get("initial_t_inner", -1)
            if config is not None else -1
        )
        if initial_t_inner > 0:
            t_inner = initial_t_inner
        else:
            t_inner = float(
                (
                    self.luminosity_requested
                    / (4.0 * np.pi * geometry.r_inner[0] ** 2 * SIGMA_SB)
                ) ** 0.25
            )
        return dataclasses.replace(
            self,
            geometry=geometry,
            composition=composition,
            t_inner=t_inner,
            t_radiative=self.t_radiative[keep],
            dilution_factor=self.dilution_factor[keep],
        )

    def t_inner_from_luminosity(self, emitted_luminosity: float, exponent=-0.5):
        """Updated t_inner estimate from the emitted/requested luminosity ratio
        (reference simulation/base.py:222-232)."""
        ratio = emitted_luminosity / self.luminosity_requested
        return self.t_inner * ratio**exponent
