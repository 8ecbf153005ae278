"""Programmatic custom-abundance editor.

Counterpart of ``tardis_tpu/visualization/custom_abundance.py`` (the
reference's ``CustomAbundanceWidget``, tardis/visualization/widgets/
custom_abundance.py), whose ipywidgets GUI is a terminal-first API with
the same capabilities: load an abundance / density profile from a config,
a CSVY file or a finished simulation; edit per-shell abundances (single
shells or velocity ranges, with optional normalization); resample the
shell grid; plot the profile; and export a runnable CSVY model file.  The
profile is a handful of host arrays of shell length, read through the
port's own ``config``, ``model`` and ``io/csvy.py``; matplotlib is
imported inside ``plot``.
"""

from __future__ import annotations

import numpy as np

from tardis_torch.atomic.atom_data import ATOMIC_SYMBOLS, SYMBOL_TO_Z


def _symbol(z: int) -> str:
    return ATOMIC_SYMBOLS[z - 1]


def _z_of(element) -> int:
    if isinstance(element, (int, np.integer)):
        return int(element)
    return SYMBOL_TO_Z[str(element).capitalize()]


class CustomAbundanceEditor:
    """Holds velocity edges [cm/s], per-shell density [g/cm^3] and a
    (element -> mass-fraction array) mapping; every editing method keeps
    shapes consistent (n_shells = len(velocity) - 1)."""

    def __init__(self, velocity, density, abundances, time_0=None):
        self.velocity = np.asarray(velocity, dtype=np.float64)
        self.density = np.asarray(density, dtype=np.float64)
        self.abundances = {
            _z_of(k): np.asarray(v, dtype=np.float64)
            for k, v in abundances.items()
        }
        self.time_0 = time_0  # seconds, density/abundance reference epoch
        n = self.n_shells
        if len(self.density) != n:
            raise ValueError("density must have n_shells entries")
        for z, fr in self.abundances.items():
            if len(fr) != n:
                raise ValueError(f"abundance {_symbol(z)} wrong length")

    # ------------------------------------------------------------------
    @property
    def n_shells(self) -> int:
        return len(self.velocity) - 1

    @property
    def elements(self):
        return sorted(self.abundances)

    @classmethod
    def from_simulation_state(cls, state):
        comp = state.composition
        ab = {
            int(z): comp.mass_fractions[i].copy()
            for i, z in enumerate(comp.atomic_numbers)
        }
        velocity = np.concatenate(
            [state.geometry.v_inner[:1], state.geometry.v_outer]
        )
        return cls(velocity, comp.density.copy(), ab,
                   time_0=state.time_explosion)

    @classmethod
    def from_simulation(cls, sim):
        return cls.from_simulation_state(sim.state)

    @classmethod
    def from_config(cls, config, atom_data=None):
        from tardis_torch.model.state import SimulationState

        return cls.from_simulation_state(SimulationState.from_config(config))

    @classmethod
    def from_csvy(cls, path: str, time_explosion: float):
        from tardis_torch.config.reader import config_from_dict

        cfg = config_from_dict(
            {
                "supernova": {
                    "luminosity_requested": "9 log_lsun",
                    "time_explosion": f"{time_explosion / 86400.0} day",
                },
                "csvy_model": path,
                "montecarlo": {"seed": 1, "no_of_packets": 1,
                               "iterations": 1},
                "spectrum": {"start": "500 angstrom",
                             "stop": "20000 angstrom", "num": 20},
            }
        )
        from tardis_torch.io.csvy import simulation_state_from_csvy

        return cls.from_simulation_state(
            simulation_state_from_csvy(path, cfg)
        )

    # ------------------------------------------------------------------
    def _shell_slice(self, shells=None, velocity_range=None):
        if shells is not None and velocity_range is not None:
            raise ValueError("give shells OR velocity_range, not both")
        if velocity_range is not None:
            lo, hi = velocity_range
            centers = 0.5 * (self.velocity[:-1] + self.velocity[1:])
            return np.where((centers >= lo) & (centers <= hi))[0]
        if shells is None:
            return np.arange(self.n_shells)
        return np.atleast_1d(np.asarray(shells, dtype=int))

    def set_abundance(self, element, value, shells=None,
                      velocity_range=None, normalize=False):
        """Set the mass fraction of `element` on the selected shells.

        With ``normalize=True`` the OTHER elements are rescaled so each
        edited shell sums to 1 (the widget's locked-element semantics)."""
        z = _z_of(element)
        idx = self._shell_slice(shells, velocity_range)
        if z not in self.abundances:
            self.abundances[z] = np.zeros(self.n_shells)
        value = np.broadcast_to(np.asarray(value, np.float64), idx.shape)
        if (value < 0).any() or (value > 1).any():
            raise ValueError("mass fractions must be within [0, 1]")
        self.abundances[z][idx] = value
        if normalize:
            self._renormalize_others(z, idx)
        return self

    def _renormalize_others(self, z_locked, idx):
        others = [z for z in self.abundances if z != z_locked]
        if not others:
            return
        other_sum = np.sum([self.abundances[z][idx] for z in others], axis=0)
        target = 1.0 - self.abundances[z_locked][idx]
        scale = np.where(other_sum > 0, target / np.where(
            other_sum > 0, other_sum, 1.0), 0.0)
        for z in others:
            self.abundances[z][idx] *= scale

    def normalize(self, shells=None):
        """Rescale all elements so every selected shell sums to 1
        (widget's ``on_btn_norm``)."""
        idx = self._shell_slice(shells)
        total = np.sum([fr[idx] for fr in self.abundances.values()], axis=0)
        if (total <= 0).any():
            raise ValueError("cannot normalize an all-zero shell")
        for z in self.abundances:
            self.abundances[z][idx] /= total
        return self

    def check_normalization(self, atol=1e-8) -> np.ndarray:
        """Boolean per shell: abundances sum to 1."""
        total = np.sum(list(self.abundances.values()), axis=0)
        return np.abs(total - 1.0) < atol

    def set_density(self, value, shells=None, velocity_range=None):
        idx = self._shell_slice(shells, velocity_range)
        self.density[idx] = value
        return self

    def resample(self, n_shells: int):
        """Re-grid to `n_shells` uniform-velocity shells, interpolating
        density (log-space) and abundances at shell centers (the widget's
        shell-number editing)."""
        new_edges = np.linspace(self.velocity[0], self.velocity[-1],
                                n_shells + 1)
        old_c = 0.5 * (self.velocity[:-1] + self.velocity[1:])
        new_c = 0.5 * (new_edges[:-1] + new_edges[1:])
        self.density = np.exp(
            np.interp(new_c, old_c, np.log(self.density))
        )
        self.abundances = {
            z: np.interp(new_c, old_c, fr)
            for z, fr in self.abundances.items()
        }
        self.velocity = new_edges
        return self.normalize()

    # ------------------------------------------------------------------
    def plot(self, ax=None):
        """Step plot of mass fractions vs velocity (the widget's main
        figure), density on a twin log axis."""
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        v_km_s = self.velocity / 1e5
        for z in self.elements:
            ax.step(v_km_s[:-1], self.abundances[z], where="post",
                    label=_symbol(z))
        ax.set_xlabel("velocity [km/s]")
        ax.set_ylabel("mass fraction")
        ax.legend(loc="best", fontsize="small")
        ax2 = ax.twinx()
        ax2.step(v_km_s[:-1], self.density, where="post", color="gray",
                 linestyle=":", label="density")
        ax2.set_yscale("log")
        ax2.set_ylabel("density [g/cm^3]")
        return ax

    # ------------------------------------------------------------------
    def to_csvy(self, path: str, t_rad=None, dilution_factor=None):
        """Write a runnable CSVY model file (widget's ``to_csvy`` /
        ``write_yaml_portion`` + ``write_csv_portion``)."""
        bad = ~self.check_normalization()
        if bad.any():
            raise ValueError(
                f"shells {np.where(bad)[0].tolist()} do not sum to 1; "
                "call .normalize() first"
            )
        names = ["velocity", "density"] + [
            _symbol(z) for z in self.elements
        ]
        fields = [
            "    - {name: velocity, unit: km/s}",
            "    - {name: density, unit: g/cm^3}",
        ] + [f"    - {{name: {_symbol(z)}}}" for z in self.elements]
        if t_rad is not None:
            names.append("t_rad")
            fields.append("    - {name: t_rad, unit: K}")
        if dilution_factor is not None:
            names.append("dilution_factor")
            fields.append("    - {name: dilution_factor}")

        t0_day = (self.time_0 or 0.0) / 86400.0
        header = (
            "---\n"
            "name: custom_abundance_model\n"
            f"model_density_time_0: {t0_day} day\n"
            f"model_isotope_time_0: {t0_day} day\n"
            "datatype:\n"
            "  fields:\n" + "\n".join(fields) + "\n---\n"
        )
        n_edges = len(self.velocity)
        rows = [",".join(names)]
        for i in range(n_edges):
            j = max(i - 1, 0)  # row 0 = inner edge; data rows carry shells
            row = [repr(float(self.velocity[i] / 1e5)),
                   repr(float(self.density[j]))]
            for z in self.elements:
                row.append(repr(float(self.abundances[z][j])))
            if t_rad is not None:
                row.append(repr(float(np.asarray(t_rad)[j])))
            if dilution_factor is not None:
                row.append(repr(float(np.asarray(dilution_factor)[j])))
            rows.append(",".join(row))
        with open(path, "w") as f:
            f.write(header + "\n".join(rows) + "\n")
        return path
