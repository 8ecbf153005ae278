"""Interactive shell-info widget (ipywidgets).

Counterpart of ``tardis_tpu/visualization/widgets/shell_info.py`` (the
reference's shell-info widget tier,
tardis/visualization/widgets/shell_info.py): a linked
four-table browser — shells (T_rad, W) -> elemental abundances in the
selected shell -> ion fractions of the selected element -> level fractions
of the selected ion — backed either by a live Simulation or by a saved HDF
file.  The data layer (BaseShellInfo.shells_data / element_count /
ion_count / level_count) matches the reference's DataFrame shapes and
scientific-notation formatting; the UI layer uses ipywidgets Select boxes
and HTML tables instead of qgrid.  The tables read the host arrays of
the port's plasma state (populations are host numpy there) or the port's
HDF file (``io/hdf.py``); pandas, h5py and ipywidgets are imported inside
the functions that use them.
"""

from __future__ import annotations

import numpy as np

from tardis_torch.atomic.atom_data import ATOMIC_SYMBOLS
from tardis_torch.utils.base import species_tuple_to_string


def _symbol(z: int) -> str:
    return ATOMIC_SYMBOLS[int(z) - 1]


class BaseShellInfo:
    """Data layer: flat arrays -> the reference's table DataFrames.

    Parameters mirror the flat-array layout of the plasma state:
    ``ion_*`` arrays index the rows of ``ion_number_density`` and
    ``level_*`` arrays the rows of ``level_number_density``.
    """

    def __init__(
        self,
        t_radiative,
        dilution_factor,
        atomic_numbers,  # (E,)
        abundance,  # (E, S) mass fractions
        number_density,  # (E, S) element number densities
        ion_number_density,  # (I, S)
        ion_z,  # (I,)
        ion_stage,  # (I,)
        level_number_density=None,  # (N, S)
        level_z=None,
        level_ion=None,
        level_number=None,
    ):
        self.t_radiative = np.asarray(t_radiative)
        self.dilution_factor = np.asarray(dilution_factor)
        self.atomic_numbers = np.asarray(atomic_numbers, int)
        self.abundance = np.asarray(abundance)
        self.number_density = np.asarray(number_density)
        self.ion_number_density = np.asarray(ion_number_density)
        self.ion_z = np.asarray(ion_z, int)
        self.ion_stage = np.asarray(ion_stage, int)
        self.level_number_density = (
            None if level_number_density is None
            else np.asarray(level_number_density)
        )
        self.level_z = None if level_z is None else np.asarray(level_z, int)
        self.level_ion = (
            None if level_ion is None else np.asarray(level_ion, int)
        )
        self.level_number = (
            None if level_number is None else np.asarray(level_number, int)
        )

    # -- tables (reference shell_info.py:52-172) -----------------------
    def shells_data(self):
        import pandas as pd

        df = pd.DataFrame(
            {
                "Rad. Temp.": self.t_radiative,
                "Dilution Factor": self.dilution_factor,
            }
        )
        df.index = range(1, len(self.t_radiative) + 1)
        df.index.name = "Shell No."
        return df.map(lambda x: f"{x:.6e}")

    def element_count(self, shell_num: int):
        import pandas as pd

        ab = self.abundance[:, shell_num - 1]
        df = pd.DataFrame(
            {
                "Element": [_symbol(z) for z in self.atomic_numbers],
                f"Frac. Ab. (Shell {shell_num})": [
                    f"{a:.6e}" for a in np.nan_to_num(ab)
                ],
            },
            index=pd.Index(self.atomic_numbers, name="Z"),
        )
        return df

    def ion_count(self, atomic_num: int, shell_num: int):
        import pandas as pd

        rows = self.ion_z == atomic_num
        stages = self.ion_stage[rows]
        dens = self.ion_number_density[rows, shell_num - 1]
        e_idx = list(self.atomic_numbers).index(atomic_num)
        total = self.number_density[e_idx, shell_num - 1]
        frac = np.nan_to_num(dens / total if total > 0 else dens * 0.0)
        return pd.DataFrame(
            {
                "Species": [
                    species_tuple_to_string((atomic_num, int(s)))
                    for s in stages
                ],
                f"Frac. Ab. (Z={atomic_num})": [
                    f"{f:.6e}" for f in frac
                ],
            },
            index=pd.Index(stages, name="Ion"),
        )

    def level_count(self, ion: int, atomic_num: int, shell_num: int):
        import pandas as pd

        if self.level_number_density is None:
            return pd.DataFrame(
                columns=[f"Frac. Ab. (Ion={ion})"],
                index=pd.Index([], name="Level"),
            )
        rows = (self.level_z == atomic_num) & (self.level_ion == ion)
        lvl = self.level_number_density[rows, shell_num - 1]
        irow = (self.ion_z == atomic_num) & (self.ion_stage == ion)
        ion_total = float(self.ion_number_density[irow, shell_num - 1].sum())
        frac = np.nan_to_num(lvl / ion_total if ion_total > 0 else lvl * 0.0)
        return pd.DataFrame(
            {f"Frac. Ab. (Ion={ion})": [f"{f:.6e}" for f in frac]},
            index=pd.Index(self.level_number[rows], name="Level"),
        )


class SimulationShellInfo(BaseShellInfo):
    """Shell info backed by a live Simulation object."""

    def __init__(self, sim):
        st = sim.state
        ps = sim.plasma_state
        solver = sim.plasma_solver
        atom = sim.atom_data
        if ps is None:
            raise ValueError("run the simulation (or solve plasma) first")
        ion_z, ion_stage = [], []
        for e, z in enumerate(solver.element_z):
            n_rows = (
                solver.element_block_start[e + 1]
                - solver.element_block_start[e]
                + 1
            )
            ion_z.extend([int(z)] * n_rows)
            ion_stage.extend(range(n_rows))
        masses = np.array(
            [atom.masses[list(atom.atomic_numbers).index(z)]
             for z in st.composition.atomic_numbers]
        )
        super().__init__(
            st.t_radiative,
            st.dilution_factor,
            st.composition.atomic_numbers,
            st.composition.mass_fractions,
            st.composition.number_density(masses),
            ps.ion_number_density,
            ion_z,
            ion_stage,
            level_number_density=ps.level_number_density,
            level_z=atom.level_z,
            level_ion=atom.level_ion,
            level_number=atom.level_number,
        )


class HDFShellInfo(BaseShellInfo):
    """Shell info backed by a saved simulation HDF (io/hdf.py layout)."""

    def __init__(self, hdf_fpath: str, name: str = "simulation"):
        import h5py

        with h5py.File(hdf_fpath, "r") as f:
            g = f[name]
            ss = g["simulation_state"]
            pl = g["plasma"]
            atomic_numbers = ss["atomic_numbers"][()]
            abundance = ss["abundance"][()]
            density = ss["density"][()]
            ion_nd = pl["ion_number_density"][()]
            ion_z = pl["ion_z"][()]
            ion_stage = pl["ion_stage"][()]
            lvl = (
                pl["level_number_density"][()]
                if "level_number_density" in pl else None
            )
            lz = pl["level_z"][()] if "level_z" in pl else None
            li = pl["level_ion"][()] if "level_ion" in pl else None
            ln = pl["level_number"][()] if "level_number" in pl else None
            t_rad = ss["t_radiative"][()]
            w = ss["dilution_factor"][()]
        from tardis_torch.atomic.atom_data import ATOMIC_MASSES
        from tardis_torch.constants import M_U

        masses = np.array(
            [ATOMIC_MASSES[z - 1] for z in atomic_numbers]
        ) * M_U
        number_density = abundance * density[None, :] / masses[:, None]
        super().__init__(
            t_rad, w, atomic_numbers, abundance, number_density,
            ion_nd, ion_z, ion_stage,
            level_number_density=lvl, level_z=lz, level_ion=li,
            level_number=ln,
        )


class ShellInfoWidget:
    """Linked four-table ipywidgets browser (reference ShellInfoWidget)."""

    def __init__(self, shell_info_data: BaseShellInfo):
        self.data = shell_info_data

    # -- helpers -------------------------------------------------------
    @staticmethod
    def _table_html(df) -> str:
        return df.to_html(
            max_rows=40, classes="tardis-shell-info", border=0
        )

    def display(self):
        """Build and return the linked widget layout (ipywidgets.HBox)."""
        import ipywidgets as w

        d = self.data
        shells = list(range(1, len(d.t_radiative) + 1))
        shell_sel = w.Select(
            options=shells, value=1, description="Shell",
            rows=12, layout=w.Layout(width="150px"),
        )
        elem_sel = w.Select(
            options=[(_symbol(z), int(z)) for z in d.atomic_numbers],
            value=int(d.atomic_numbers[0]), description="Element",
            rows=12, layout=w.Layout(width="170px"),
        )
        ion_sel = w.Select(
            options=[0], value=0, description="Ion", rows=12,
            layout=w.Layout(width="150px"),
        )
        shells_out = w.HTML()
        elem_out = w.HTML()
        ion_out = w.HTML()
        level_out = w.HTML()

        def refresh_ions(*_):
            z = elem_sel.value
            stages = sorted(d.ion_stage[d.ion_z == z])
            ion_sel.options = [int(s) for s in stages]
            if stages:
                ion_sel.value = int(stages[0])

        def refresh(*_):
            shell = shell_sel.value
            z = elem_sel.value
            ion = ion_sel.value if ion_sel.value is not None else 0
            shells_out.value = self._table_html(d.shells_data())
            elem_out.value = self._table_html(d.element_count(shell))
            ion_out.value = self._table_html(d.ion_count(z, shell))
            level_out.value = self._table_html(
                d.level_count(ion, z, shell)
            )

        shell_sel.observe(refresh, names="value")
        elem_sel.observe(lambda ch: (refresh_ions(), refresh()),
                         names="value")
        ion_sel.observe(refresh, names="value")
        refresh_ions()
        refresh()

        return w.HBox(
            [
                w.VBox([shell_sel, shells_out]),
                w.VBox([elem_sel, elem_out]),
                w.VBox([ion_sel, ion_out]),
                w.VBox([level_out]),
            ]
        )


def shell_info_from_simulation(sim) -> ShellInfoWidget:
    """Widget from a live simulation (reference shell_info.py:384)."""
    return ShellInfoWidget(SimulationShellInfo(sim))


def shell_info_from_hdf(hdf_fpath: str) -> ShellInfoWidget:
    """Widget from a saved HDF (reference shell_info.py:400)."""
    return ShellInfoWidget(HDFShellInfo(hdf_fpath))
