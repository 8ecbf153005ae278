"""Per-shell diagnostic tables.

Counterpart of ``tardis_tpu/analysis/shell_info.py`` (the DataFrame side
of the reference's shell-info widgets,
tardis/visualization/widgets/shell_info.py): per-shell radiation-field
state, electron densities, and per-species ion fractions.  Host tables:
the plasma state's populations are host arrays in the port too.
"""

from __future__ import annotations

import numpy as np

from tardis_torch.atomic.atom_data import ATOMIC_SYMBOLS


def shell_info_table(sim):
    import pandas as pd

    st = sim.state
    ps = sim.plasma_state
    df = pd.DataFrame(
        {
            "v_inner[km/s]": st.geometry.v_inner / 1e5,
            "v_outer[km/s]": st.geometry.v_outer / 1e5,
            "t_rad[K]": st.t_radiative,
            "w": st.dilution_factor,
            "density[g/cm3]": st.composition.density,
        }
    )
    if ps is not None:
        df["n_e[1/cm3]"] = ps.electron_densities
        df["t_electron[K]"] = ps.t_electrons
    df.index.name = "shell"
    return df


def ion_fraction_table(sim, atomic_number: int):
    """Ion-stage fractions per shell for one element."""
    import pandas as pd

    ps = sim.plasma_state
    solver = sim.plasma_solver
    if ps is None:
        raise ValueError("run the simulation (or solve plasma) first")
    e_list = list(solver.element_z)
    if atomic_number not in e_list:
        raise ValueError(f"element Z={atomic_number} not in simulation")
    e = e_list.index(atomic_number)
    ion_block_start = solver.element_block_start + np.arange(
        len(e_list) + 1
    )
    rows = slice(ion_block_start[e], ion_block_start[e + 1])
    dens = ps.ion_number_density[rows]
    total = dens.sum(axis=0)
    frac = dens / np.where(total > 0, total, 1.0)
    sym = ATOMIC_SYMBOLS[atomic_number - 1]
    return pd.DataFrame(
        frac.T,
        columns=[f"{sym}{'+' * i}" for i in range(frac.shape[0])],
    )
