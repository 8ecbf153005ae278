"""Last-line-interaction analysis.

Counterpart of ``tardis_tpu/analysis/last_interaction.py`` (the
reference's ``LastLineInteraction``, tardis/analysis.py:18): filter the
escaped packets by a wavelength window and tabulate the lines and species
of their last interaction.

K1's last-interaction rows and packet outputs stay on the device
(``TransportResult._li``, ``._out``): the window mask and the count of
each line are taken there, and only the distinct line ids and their
counts come back to the host.  The frequencies are compared in f64 from
the rows' f32, as the JAX package compares them, so the same rows give the
same tables.
"""

from __future__ import annotations

import numpy as np
import torch

from tardis_torch.atomic.atom_data import ATOMIC_SYMBOLS
from tardis_torch.constants import C
from tardis_torch.transport.tables import NU_UNIT

# the columns of K1's last-interaction rows
TYPE, IN_LINE, OUT_LINE, SHELL, IN_NU = range(5)
LINE_INTERACTION = 2


class LastLineInteraction:
    def __init__(self, transport_result, atom_data,
                 packet_filter_mode: str = "packet_out_nu"):
        if transport_result._li is None:
            raise ValueError(
                "transport was run without last-interaction tracking"
            )
        self.result = transport_result
        self.atom = atom_data
        self.packet_filter_mode = packet_filter_mode
        self.wavelength_start = 0.0
        self.wavelength_end = np.inf

    @classmethod
    def from_simulation(cls, sim, **kwargs):
        return cls(sim.last_transport_result, sim.atom_data, **kwargs)

    def set_wavelength_range(self, start_cm: float, end_cm: float):
        self.wavelength_start = start_cm
        self.wavelength_end = end_cm
        return self

    def _mask(self) -> torch.Tensor:
        """Per packet, on the rows' device: escaped, last interaction a
        line, frequency inside the window."""
        li = self.result._li
        nu_signed = self.result._out[:, 0]
        emitted = nu_signed > 0
        line_mask = li[:, TYPE] == LINE_INTERACTION
        if self.packet_filter_mode == "packet_out_nu":
            nu = nu_signed.double().abs() * NU_UNIT
        else:  # packet_in_nu: lab nu just before the last interaction
            nu = li[:, IN_NU].double() * NU_UNIT
        nu_min = C / self.wavelength_end if self.wavelength_end > 0 else 0.0
        nu_max = (
            C / self.wavelength_start if self.wavelength_start > 0 else np.inf
        )
        return emitted & line_mask & (nu > nu_min) & (nu < nu_max)

    def line_counts(self, which: str = "in"):
        """The distinct last lines of the masked packets, absorbed
        (``which="in"``) or emitted (``"out"``), and how many packets each
        holds: two host arrays, the line ids ascending (int32, as the JAX
        package's rows) and their counts (int64), reduced on the rows'
        device."""
        column = {"in": IN_LINE, "out": OUT_LINE}[which]
        line_ids = self.result._li[self._mask(), column].long()
        uniq, counts = torch.unique(line_ids[line_ids >= 0],
                                    return_counts=True)
        return uniq.cpu().numpy().astype(np.int32), counts.cpu().numpy()

    @property
    def last_line_in(self):
        """Counts per absorbed line (Z, ion, line id)."""
        return self._line_table(*self.line_counts("in"))

    @property
    def last_line_out(self):
        """Counts per emitted line."""
        return self._line_table(*self.line_counts("out"))

    def _line_table(self, uniq, counts):
        import pandas as pd

        atom = self.atom
        df = pd.DataFrame(
            {
                "line_id": uniq,
                "count": counts,
                "atomic_number": atom.line_z[uniq],
                "ion_number": atom.line_ion[uniq],
                "wavelength_AA": (C / atom.line_nu[uniq]) * 1e8,
            }
        )
        df["species"] = [
            f"{ATOMIC_SYMBOLS[z - 1]} {_roman(i + 1)}"
            for z, i in zip(df.atomic_number, df.ion_number)
        ]
        return df.sort_values("count", ascending=False).reset_index(drop=True)

    def species_counts(self):
        df = self.last_line_out
        return df.groupby("species")["count"].sum().sort_values(
            ascending=False
        )

    def line_pairs(self):
        """The distinct (in line, out line) pairs of the masked packets, in
        the order of their first packet, with their counts: three host
        int64 arrays."""
        m = self._mask()
        li = self.result._li
        pairs = torch.stack((li[m, IN_LINE].long(), li[m, OUT_LINE].long()))
        if pairs.shape[1] == 0:
            empty = np.zeros(0, np.int64)
            return empty, empty, empty
        uniq, inverse, counts = torch.unique(
            pairs, dim=1, return_inverse=True, return_counts=True)
        first = torch.full((uniq.shape[1],), pairs.shape[1],
                           dtype=torch.int64, device=pairs.device)
        first.scatter_reduce_(0, inverse, torch.arange(
            pairs.shape[1], device=pairs.device), reduce="amin")
        order = torch.argsort(first)
        uniq, counts = uniq[:, order].cpu().numpy(), counts[order]
        return uniq[0], uniq[1], counts.cpu().numpy()


_ROMAN = [
    "I", "II", "III", "IV", "V", "VI", "VII", "VIII", "IX", "X",
    "XI", "XII", "XIII", "XIV", "XV", "XVI", "XVII", "XVIII", "XIX", "XX",
]


def _roman(n: int) -> str:
    return _ROMAN[n - 1] if 1 <= n <= len(_ROMAN) else str(n)
