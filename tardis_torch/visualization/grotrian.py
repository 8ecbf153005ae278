"""Grotrian (energy-level / transition) diagrams.

Counterpart of ``tardis_tpu/visualization/grotrian.py`` (the reference's
Grotrian widget, tardis/visualization/widgets/grotrian.py): for one ion,
the energy-level ladder with near-degenerate levels merged
(``level_diff_threshold``, relative energy), bar widths from the
standardized log level populations of a shell (or the shell average), and
arrows for the last-interaction absorptions (up) and emissions (down)
between merged levels, the arrow width a standardized log packet count
and the colour the mean transition wavelength; a wavelength window, the
shell and a linear or log energy scale.

The level ladder and the transition counts (``_compute_level_data``,
``_compute_transitions``) are taken in torch on the device the transport
result lives on: K1's last-interaction rows stay there, the line and
level tables are copied there, and the transitions are counted with one
``unique`` over (lower, upper) pairs; only the ladder and the per-pair
counts and mean wavelengths reach the host, the pairs in the order of
their first packet.  The diagram is drawn from those host values, with
matplotlib imported inside ``display`` or plotly inside ``display_ply``.
``plot_grotrian`` is the one-call wrapper.
"""

from __future__ import annotations

import numpy as np
import torch

from tardis_torch.atomic.atom_data import ATOMIC_SYMBOLS
from tardis_torch.utils.base import (
    species_string_to_tuple,
    species_tuple_to_string,
)
from tardis_torch.visualization.sdec import on_device

EV = 1.602176634e-12
C_CGS = 2.99792458e10


def standardize(x, log=True, zero_undefined_offset=1e-3):
    """Map positive values to [0, 1] on a (log) scale (the reference's
    ``standardize``, used for widths)."""
    x = np.asarray(x, np.float64)
    if len(x) == 0:
        return x
    if log:
        x = np.log10(np.maximum(x, zero_undefined_offset * np.nanmax(x)))
    lo, hi = np.nanmin(x), np.nanmax(x)
    if hi <= lo:
        return np.ones_like(x)
    return (x - lo) / (hi - lo)


class GrotrianPlot:
    """Energy-level diagram for one ion with transition traffic arrows."""

    def __init__(self, sim, atomic_number=None, ion_number=None):
        res = sim.last_transport_result
        if res is None or res._li is None:
            raise ValueError(
                "Grotrian plot needs a finished simulation with "
                "last-interaction tracking"
            )
        self.sim = sim
        self.atom = sim.atom_data
        self.device = res._li.device
        self._max_levels = 10
        self._min_wavelength = None  # Angstrom
        self._max_wavelength = None
        self._level_diff_threshold = 0.01  # relative energy merge window
        self._shell = None
        self._y_scale = "linear"
        if atomic_number is None:
            atomic_number = int(self.atom.species_z[0])
            ion_number = int(self.atom.species_ion[0])
        self.set_ion(atomic_number, ion_number or 0)

    @classmethod
    def from_simulation(cls, sim, atomic_number=None, ion_number=None):
        return cls(sim, atomic_number, ion_number)

    # -- configuration --------------------------------------------------
    def set_ion(self, atomic_number: int, ion_number: int):
        atom = self.atom
        rows = np.where(
            (atom.level_z == atomic_number) & (atom.level_ion == ion_number)
        )[0]
        if len(rows) == 0:
            raise ValueError(
                f"species Z={atomic_number} ion={ion_number} not in the "
                "atomic data"
            )
        self.atomic_number = int(atomic_number)
        self.ion_number = int(ion_number)
        self._level_rows = rows

    @property
    def atomic_symbol(self):
        return ATOMIC_SYMBOLS[self.atomic_number - 1]

    @property
    def max_levels(self):
        return self._max_levels

    @max_levels.setter
    def max_levels(self, value):
        if value < 2:
            raise ValueError("max_levels must be >= 2")
        self._max_levels = int(value)

    @property
    def level_diff_threshold(self):
        return self._level_diff_threshold

    @level_diff_threshold.setter
    def level_diff_threshold(self, value):
        if not 0 <= value < 1:
            raise ValueError("level_diff_threshold must be in [0, 1)")
        self._level_diff_threshold = float(value)

    @property
    def min_wavelength(self):
        return self._min_wavelength

    @min_wavelength.setter
    def min_wavelength(self, value):
        self._min_wavelength = value

    @property
    def max_wavelength(self):
        return self._max_wavelength

    @max_wavelength.setter
    def max_wavelength(self, value):
        self._max_wavelength = value

    @property
    def shell(self):
        return self._shell

    @shell.setter
    def shell(self, value):
        if value is not None and not (
            0 <= value < self.sim.state.no_of_shells
        ):
            raise ValueError("shell out of range")
        self._shell = value

    @property
    def y_scale(self):
        return self._y_scale

    @y_scale.setter
    def y_scale(self, value):
        if value not in ("linear", "log"):
            raise ValueError("y_scale must be 'linear' or 'log'")
        self._y_scale = value

    # -- data -------------------------------------------------------------
    def _compute_level_data(self):
        """The merged level ladder (``merged_energies``, eV), the map from
        level number to merged level (``level_mapping``) and the bar
        widths from the merged levels' populations."""
        rows = self._level_rows[: self.max_levels]
        e = on_device(self.atom.level_energy[rows], self.device,
                      torch.float64) / EV
        # a level joins the current merged level while its energy lies
        # within the threshold of the mean over the ids equal to it (a walk
        # over at most max_levels levels; the ids not yet walked are 0, so
        # the first merged level's mean takes them in, as the JAX
        # package's does)
        merged = torch.zeros(len(rows), dtype=torch.long, device=self.device)
        mid = 0
        for k in range(1, len(rows)):
            ref = max(float(e[merged == mid].mean()), 1e-12)
            if (float(e[k]) - ref) / max(ref, 1e-12) \
                    > self._level_diff_threshold:
                mid += 1
            merged[k] = mid
        n_merged = mid + 1
        counts = torch.bincount(merged, minlength=n_merged)
        merged_e = torch.zeros(n_merged, dtype=torch.float64,
                               device=self.device).index_add_(0, merged, e)
        merged_e = merged_e / counts
        pops = None
        ps = getattr(self.sim, "plasma_state", None)
        if ps is not None:
            lp = on_device(ps.level_number_density[rows], self.device,
                           torch.float64)
            lp = lp[:, self._shell] if self._shell is not None \
                else lp.mean(dim=1)
            pops = torch.zeros(n_merged, dtype=torch.float64,
                               device=self.device).index_add_(0, merged, lp)
            pops = pops.cpu().numpy()
        merged = merged.cpu().numpy()
        self.level_mapping = {
            int(self.atom.level_number[r]): int(m)
            for r, m in zip(rows, merged)
        }
        self.merged_energies = merged_e.cpu().numpy()
        self.level_widths = (None if pops is None
                             else 0.75 + 3.5 * standardize(pops))
        self.level_populations = pops

    def _compute_transitions(self):
        """Absorption (``excite_lines``) and emission (``deexcite_lines``)
        packet counts between merged levels: {(lower, upper): (count, mean
        wavelength Angstrom, arrow width)}, counted on the device, the
        pairs in the order of their first packet."""
        atom = self.atom
        li = self.sim.last_transport_result._li
        mask = li[:, 0] == 2
        if self._shell is not None:
            mask = mask & (li[:, 3] == self._shell)
        line_z = on_device(atom.line_z, self.device, torch.long)
        line_ion = on_device(atom.line_ion, self.device, torch.long)
        line_nu = on_device(atom.line_nu, self.device, torch.float64)
        level_number = on_device(atom.level_number, self.device, torch.long)
        lower = level_number[on_device(atom.line_lower_idx, self.device,
                                       torch.long)]
        upper = level_number[on_device(atom.line_upper_idx, self.device,
                                       torch.long)]
        mapping = torch.full((int(atom.level_number.max()) + 2,), -1,
                             dtype=torch.long, device=self.device)
        for number, m in self.level_mapping.items():
            mapping[number] = m
        n_merged = len(self.merged_energies)
        out = {}
        for column, name in ((1, "excite"), (2, "deexcite")):
            lines = li[mask, column].long()
            lines = lines[(lines >= 0) & (lines < atom.n_lines)]
            lines = lines[(line_z[lines] == self.atomic_number)
                          & (line_ion[lines] == self.ion_number)]
            lam = C_CGS / line_nu[lines] * 1e8
            ml, mh = mapping[lower[lines]], mapping[upper[lines]]
            keep = (ml >= 0) & (mh >= 0) & (ml != mh)
            code = ml[keep] * n_merged + mh[keep]
            pair, inv, count = torch.unique(code, return_inverse=True,
                                            return_counts=True)
            wsum = torch.zeros(pair.shape[0], dtype=torch.float64,
                               device=self.device).index_add_(
                0, inv, lam[keep])
            # pairs in the order their first packet comes, as the JAX
            # package's dict fills (the plots draw them in that order)
            first = torch.full_like(pair, code.shape[0]).scatter_reduce_(
                0, inv, torch.arange(code.shape[0], device=self.device),
                "amin")
            order = torch.argsort(first)
            pair, count = pair[order].cpu().numpy(), count[order].cpu().numpy()
            mean = wsum[order].cpu().numpy() / count
            out[name] = {(int(p // n_merged), int(p % n_merged)):
                         (int(c), float(w))
                         for p, c, w in zip(pair, count, mean)}
        # wavelength-range filter (defaults from the data)
        all_lam = [w for d in out.values() for (_, w) in d.values()]
        if all_lam:
            lo_w = (self._min_wavelength if self._min_wavelength is not None
                    else min(all_lam))
            hi_w = (self._max_wavelength if self._max_wavelength is not None
                    else max(all_lam))
            out = {name: {k: v for k, v in d.items()
                          if lo_w <= v[1] <= hi_w}
                   for name, d in out.items()}
            self._wl_range = (lo_w, hi_w)
        else:
            self._wl_range = (0.0, 1.0)
        counts = [v[0] for d in out.values() for v in d.values()]
        widths = standardize(counts) if counts else np.array([])
        i = 0
        for d in out.values():
            for k in list(d):
                n, w = d[k]
                d[k] = (n, w, 0.5 + 3.5 * widths[i])
                i += 1
        self.excite_lines = out["excite"]
        self.deexcite_lines = out["deexcite"]

    # -- rendering ----------------------------------------------------------
    def display(self, ax=None):
        """Matplotlib rendering; returns the axis."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib import cm, colors

        self._compute_level_data()
        self._compute_transitions()
        if ax is None:
            _, ax = plt.subplots(figsize=(8, 7))
        n = len(self.merged_energies)
        e_plot = self.merged_energies.copy()
        if self._y_scale == "log":
            e_plot = np.log10(np.maximum(e_plot, e_plot[e_plot > 0].min()
                                         if (e_plot > 0).any() else 1e-3))
        for m, e in enumerate(e_plot):
            lw = 3.0 if self.level_widths is None else self.level_widths[m]
            ax.hlines(e, 0.08, 0.92, lw=lw, color="k")
            ax.text(0.94, e, f"{m}", va="center", fontsize=8)
        cmap = plt.get_cmap("rainbow")
        lo_w, hi_w = self._wl_range
        norm = colors.Normalize(lo_w, max(hi_w, lo_w + 1e-6))
        for d, sign, x0 in ((self.excite_lines, +1, 0.16),
                            (self.deexcite_lines, -1, 0.56)):
            for (ml, mh), (_, lam, width) in d.items():
                x = x0 + 0.3 * (ml + mh) / max(2 * n - 2, 1)
                y_from = e_plot[ml if sign > 0 else mh]
                y_to = e_plot[mh if sign > 0 else ml]
                ax.annotate("", xy=(x, y_to), xytext=(x, y_from),
                            arrowprops=dict(arrowstyle="->", lw=width,
                                            color=cmap(norm(lam)),
                                            alpha=0.85))
        sm = cm.ScalarMappable(norm=norm, cmap=cmap)
        plt.colorbar(sm, ax=ax, label="Wavelength [$\\AA$]", shrink=0.8)
        ax.set_xlim(0, 1)
        ax.set_xticks([])
        ax.set_ylabel("Level energy [eV]" if self._y_scale == "linear"
                      else "log10 level energy [eV]")
        shell_tag = "" if self._shell is None else f" (shell {self._shell})"
        ax.set_title("Grotrian diagram: " + species_tuple_to_string(
            (self.atomic_number, self.ion_number)) + shell_tag)
        return ax

    def display_ply(self):
        """Plotly rendering: a line a merged level (``level_widths``), an
        annotation arrow a transition.  Requires plotly; raises ImportError
        otherwise."""
        import plotly.graph_objects as go

        self._compute_level_data()
        self._compute_transitions()
        fig = go.Figure()
        n = len(self.merged_energies)
        for m, e in enumerate(self.merged_energies):
            lw = 3.0 if self.level_widths is None else self.level_widths[m]
            fig.add_trace(go.Scatter(
                x=[0.08, 0.92], y=[e, e], mode="lines",
                line=dict(color="black", width=lw), showlegend=False,
                hovertemplate=f"level {m}: {e:.3f} eV<extra></extra>"))
        for d, x0, color in ((self.excite_lines, 0.16, "#2E86AB"),
                             (self.deexcite_lines, 0.56, "#C73E1D")):
            for (ml, mh), (_, _, width) in d.items():
                x = x0 + 0.3 * (ml + mh) / max(2 * n - 2, 1)
                fig.add_annotation(
                    x=x, y=self.merged_energies[mh],
                    ax=x, ay=self.merged_energies[ml],
                    xref="x", yref="y", axref="x", ayref="y",
                    arrowwidth=width, arrowcolor=color,
                    showarrow=True, arrowhead=2)
        fig.update_layout(
            title="Grotrian diagram: " + species_tuple_to_string(
                (self.atomic_number, self.ion_number)),
            yaxis_title="Level energy [eV]",
            xaxis=dict(visible=False),
        )
        return fig


def plot_grotrian(sim, species: str, max_levels: int = 10,
                  shell: int | None = None, ax=None):
    """One-call Grotrian diagram (a wrapper over GrotrianPlot)."""
    z, ion = species_string_to_tuple(species)
    g = GrotrianPlot(sim, z, ion)
    g.max_levels = max_levels
    g.shell = shell
    return g.display(ax=ax)
