"""Interactive line-info widget (ipywidgets).

Counterpart of ``tardis_tpu/visualization/widgets/line_info.py`` (the
reference's ``LineInfoWidget``,
tardis/visualization/widgets/line_info.py): select a
wavelength range on the spectrum, see which species' line interactions the
escaping packets in that range last underwent, then drill into the last
line-interaction counts for one species, grouped by absorption ("in") or
emission ("out") lines.  The analysis layer is
``tardis_torch.analysis.line_info.LineInfo`` (same DataFrames as the
reference's get_species_interactions / get_last_line_counts); the UI layer
uses ipywidgets sliders + toggles + HTML tables and a matplotlib spectrum
(instead of the reference's bokeh/panel stack); matplotlib and
ipywidgets are imported inside the functions that draw.
"""

from __future__ import annotations

import numpy as np

from tardis_torch.analysis.line_info import LineInfo

FILTER_MODES = ("packet_out_nu", "packet_in_nu")
GROUP_MODES = ("both", "exc", "de-exc")


class LineInfoWidget:
    """Interactive wavelength-range line-interaction browser."""

    def __init__(self, sim):
        self.sim = sim
        self.info = LineInfo.from_simulation(sim)
        sp = sim.spectrum_real
        if sp is None:
            raise ValueError("run the simulation first (no spectrum)")
        self.wavelength = np.asarray(sp.wavelength) * 1e8  # cm -> Angstrom
        self.lum_lambda = np.asarray(sp.luminosity_nu)

    @classmethod
    def from_simulation(cls, sim):
        return cls(sim)

    # -- analysis passthrough (reference line_info.py:171-426) ---------
    def get_species_interactions(self, wavelength_range,
                                 filter_mode="packet_out_nu"):
        return self.info.get_species_interactions(
            wavelength_range, filter_mode=filter_mode
        )

    def get_last_line_counts(self, species, wavelength_range=None,
                             filter_mode="packet_out_nu",
                             group_mode="both"):
        return self.info.get_last_line_counts(
            species, wavelength_range=wavelength_range,
            filter_mode=filter_mode, group_mode=group_mode,
        )

    # -- UI ------------------------------------------------------------
    def plot_spectrum(self, wavelength_range=None, ax=None):
        """Matplotlib spectrum with the selected range shaded."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots(figsize=(9, 4))
        ax.plot(self.wavelength, self.lum_lambda, lw=0.9, color="#2E86AB")
        if wavelength_range is not None:
            ax.axvspan(*wavelength_range, color="#F18F01", alpha=0.25)
        ax.set_xlabel("Wavelength [$\\AA$]")
        ax.set_ylabel("Luminosity density")
        return ax

    def display(self):
        """Build and return the linked widget layout (ipywidgets.VBox)."""
        import ipywidgets as w

        lam_lo = float(self.wavelength.min())
        lam_hi = float(self.wavelength.max())
        rng = w.FloatRangeSlider(
            value=[lam_lo, min(lam_lo * 3, lam_hi)],
            min=lam_lo, max=lam_hi, step=(lam_hi - lam_lo) / 500,
            description="λ range [Å]", continuous_update=False,
            layout=w.Layout(width="600px"),
        )
        filter_btns = w.ToggleButtons(
            options=FILTER_MODES, description="Filter",
            tooltips=[
                "filter by emitted (escaping) packet frequency",
                "filter by the frequency at the last absorption",
            ],
        )
        group_dd = w.Dropdown(
            options=GROUP_MODES, value="both", description="Group",
        )
        species_sel = w.Select(
            options=[], description="Species", rows=8,
            layout=w.Layout(width="250px"),
        )
        species_out = w.HTML()
        counts_out = w.HTML()

        def refresh_species(*_):
            df = self.get_species_interactions(
                tuple(rng.value), filter_mode=filter_btns.value
            )
            species_out.value = df.to_html(
                max_rows=30, border=0, float_format="%.4f"
            )
            species_sel.options = list(df.index)
            if len(df.index):
                species_sel.value = df.index[0]

        def refresh_counts(*_):
            if species_sel.value is None:
                counts_out.value = ""
                return
            df = self.get_last_line_counts(
                species_sel.value,
                wavelength_range=tuple(rng.value),
                filter_mode=filter_btns.value,
                group_mode=group_dd.value,
            )
            counts_out.value = df.to_html(max_rows=40, border=0)

        rng.observe(lambda ch: (refresh_species(), refresh_counts()),
                    names="value")
        filter_btns.observe(
            lambda ch: (refresh_species(), refresh_counts()),
            names="value",
        )
        group_dd.observe(refresh_counts, names="value")
        species_sel.observe(refresh_counts, names="value")
        refresh_species()
        refresh_counts()

        return w.VBox(
            [
                rng,
                filter_btns,
                w.HBox(
                    [
                        w.VBox([species_out]),
                        w.VBox([species_sel, group_dd, counts_out]),
                    ]
                ),
            ]
        )
