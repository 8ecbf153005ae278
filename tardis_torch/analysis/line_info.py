"""Line-info analysis: which species and lines shape a spectral window.

Counterpart of ``tardis_tpu/analysis/line_info.py`` (the reference's
``LineInfoWidget`` analysis, tardis/visualization/widgets/line_info.py:
25-740, without its UI): ``get_species_interactions`` and
``get_last_line_counts`` return the JAX package's DataFrames.  Both read
``LastLineInteraction``'s device reductions: the species fractions from
its line counts, the last-line counts from the distinct (in line, out
line) pairs of the window's packets with their counts, so no per-packet
row leaves the device.
"""

from __future__ import annotations

import numpy as np

from tardis_torch.analysis.last_interaction import LastLineInteraction
from tardis_torch.utils.base import species_tuple_to_string

FILTER_MODES = ("packet_out_nu", "packet_in_nu")
GROUP_MODES = ("both", "exc", "de-exc")


class LineInfo:
    """Species / line breakdown of escaped packets in a wavelength window."""

    def __init__(self, transport_result, atom_data):
        self.result = transport_result
        self.atom = atom_data

    @classmethod
    def from_simulation(cls, sim):
        return cls(sim.last_transport_result, sim.atom_data)

    def get_species_interactions(
        self,
        wavelength_range,  # (start_angstrom, end_angstrom)
        filter_mode: str = FILTER_MODES[0],
    ):
        """Fraction of line-interacting packets per species in the window
        (reference line_info.py:171-252)."""
        import pandas as pd

        if filter_mode not in FILTER_MODES:
            raise ValueError(f"filter_mode must be one of {FILTER_MODES}")
        lli = LastLineInteraction(
            self.result, self.atom, packet_filter_mode=filter_mode
        )
        lli.set_wavelength_range(
            wavelength_range[0] * 1e-8, wavelength_range[1] * 1e-8
        )
        counts = lli.species_counts()
        total = counts.sum()
        frac = counts / total if total > 0 else counts
        return pd.DataFrame(
            {"Fraction of packets interacting": frac.values},
            index=pd.Index(counts.index, name="Species"),
        )

    def get_last_line_counts(
        self,
        species: str,  # e.g. 'Si II'
        wavelength_range=None,
        filter_mode: str = FILTER_MODES[0],
        group_mode: str = GROUP_MODES[0],
    ):
        """Packet counts per last line of the given species
        (reference line_info.py:253-427); group_mode selects absorption
        ('exc'), emission ('de-exc'), or paired transitions ('both')."""
        import pandas as pd

        if group_mode not in GROUP_MODES:
            raise ValueError(f"group_mode must be one of {GROUP_MODES}")
        lli = LastLineInteraction(
            self.result, self.atom, packet_filter_mode=filter_mode
        )
        if wavelength_range is not None:
            lli.set_wavelength_range(
                wavelength_range[0] * 1e-8, wavelength_range[1] * 1e-8
            )
        in_line, out_line, counts = lli.line_pairs()
        atom = self.atom
        z_in = atom.line_z[np.clip(in_line, 0, atom.n_lines - 1)]
        ion_in = atom.line_ion[np.clip(in_line, 0, atom.n_lines - 1)]
        want = species_tuple_to_string
        sel = np.array(
            [want((z, i)) == species for z, i in zip(z_in, ion_in)], bool
        )
        in_line, out_line, counts = in_line[sel], out_line[sel], counts[sel]

        def describe(line_ids):
            wl = 2.99792458e18 / atom.line_nu[line_ids]  # Angstrom
            return np.array(
                [f"{w:.2f} A" for w in wl]
            )

        if group_mode == "exc":
            labels = [
                f"exc. {d}" for d in describe(in_line)
            ]
        elif group_mode == "de-exc":
            labels = [
                f"de-exc. {d}" for d in describe(out_line)
            ]
        else:
            labels = [
                f"exc. {a} -> de-exc. {b}"
                for a, b in zip(describe(in_line), describe(out_line))
            ]
        # the pairs come in the order of their first packet, so repeating
        # each label by its count gives pandas the per-packet sequence's
        # first appearances and counts: the same table, ties included
        ser = pd.Series(labels).repeat(counts).value_counts()
        return pd.DataFrame(
            {"No. of packets": ser.values},
            index=pd.Index(ser.index, name=f"Last interaction: {species}"),
        )
