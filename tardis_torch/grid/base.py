"""Parameter-grid runner.

Counterpart of ``tardis_tpu/grid/base.py`` (the reference's
``TardisGrid``, tardis/grid/base.py:35-146): a DataFrame of parameter
overrides (dotted config paths as columns), one simulation per row.
Every row's simulation runs on ``device``: the card unless the grid is
given another (``device="cpu"``).  pandas is imported inside the
functions that build a grid.
"""

from __future__ import annotations

import copy

import numpy as np

from tardis_torch.config.reader import ConfigDict, config_from_dict


def _apply_override(raw_config: dict, dotted_key: str, value):
    keys = dotted_key.split(".")
    d = raw_config
    for k in keys[:-1]:
        d = d.setdefault(k, {})
    d[keys[-1]] = value


class TardisGrid:
    """Run a family of simulations over a parameter grid."""

    def __init__(self, config: dict, grid, atom_data=None, device=None):
        self.base_config = config
        self.grid = grid
        self.atom_data = atom_data
        self.device = device
        self.results = [None] * len(grid)

    def grid_row_to_config(self, row_index: int) -> ConfigDict:
        raw = copy.deepcopy(self.base_config)
        for col, value in self.grid.iloc[row_index].items():
            _apply_override(raw, col, value)
        return config_from_dict(raw)

    def run_sim_from_grid(self, row_index: int, **kwargs):
        from tardis_torch.simulation.base import Simulation

        config = self.grid_row_to_config(row_index)
        sim = Simulation.from_config(config, atom_data=self.atom_data,
                                     device=self.device)
        sim.run()
        self.results[row_index] = sim
        return sim

    def grid_row_to_simulation_state(self, row_index: int,
                                     atom_data=None):
        """SimulationState for one grid row without running the MC loop
        (reference grid/base.py:94-113)."""
        from tardis_torch.model.state import SimulationState

        del atom_data  # config-driven states need no atomic data here
        return SimulationState.from_config(
            self.grid_row_to_config(row_index)
        )

    def save_grid(self, filename: str):
        """Write the parameter table as CSV (reference grid/base.py:133)."""
        self.grid.to_csv(filename)

    @classmethod
    def from_axes(cls, config: dict, axesdict: dict, atom_data=None,
                  device=None):
        """Full Cartesian product of {dotted_key: values} axes
        (reference grid/base.py:146-170)."""
        import pandas as pd

        axes = list(axesdict)
        mesh = np.meshgrid(*[np.asarray(axesdict[a]) for a in axes],
                           indexing="ij")
        grid = pd.DataFrame(
            {a: m.reshape(-1) for a, m in zip(axes, mesh)}
        )
        return cls(config, grid, atom_data=atom_data, device=device)

    def run(self):
        for i in range(len(self.grid)):
            self.run_sim_from_grid(i)
        return self.results
