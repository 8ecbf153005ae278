"""Iteration-by-iteration history reader.

Counterpart of ``tardis_tpu/analysis/history.py`` (the reference's
``TARDISHistory``, tardis/analysis.py:275-470), on the port's HDF layout:
the per-iteration radiation-field state lies under
``/<name>/iterations/{t_radiative,dilution_factor,t_inner,...}`` as
stacked (n_iterations x n_shells) tables, written by
:func:`tardis_torch.io.hdf.simulation_to_hdf`.  h5py and pandas are
imported inside the methods that read and tabulate.
"""

from __future__ import annotations

import numpy as np


class TARDISHistory:
    """Read back the per-iteration convergence history of a run.

    Each ``load_*`` method returns a DataFrame with one ``iterNNN`` column
    per iteration (shells as the index), matching the orientation of the
    reference's ``load_t_rads``/``load_ws`` (analysis.py:327-362).
    """

    def __init__(self, hdf5_fname: str, name: str = "simulation"):
        self.hdf5_fname = hdf5_fname
        self.name = name
        import h5py

        with h5py.File(hdf5_fname, "r") as store:
            key = f"/{name}/iterations/t_inner"
            if key not in store:
                raise KeyError(
                    f"{hdf5_fname} has no iteration history under /{name}"
                )
            self.iterations = np.arange(store[key].shape[0])

    # ------------------------------------------------------------------
    def _select(self, iterations):
        if iterations is None:
            return self.iterations
        if np.isscalar(iterations):
            return np.atleast_1d(self.iterations[iterations])
        return self.iterations[iterations]

    def _load_stacked(self, field: str, iterations):
        import h5py
        import pandas as pd

        its = self._select(iterations)
        with h5py.File(self.hdf5_fname, "r") as store:
            table = store[f"/{self.name}/iterations/{field}"][()]
        # stacked layout: row = iteration, column = shell -> transpose
        return pd.DataFrame(
            {f"iter{int(i):03d}": table[int(i)] for i in its}
        )

    def _load_scalar_series(self, field: str, iterations) -> np.ndarray:
        import h5py

        its = self._select(iterations)
        with h5py.File(self.hdf5_fname, "r") as store:
            series = store[f"/{self.name}/iterations/{field}"][()]
        return series[its.astype(int)]

    # ------------------------------------------------------------------
    def load_t_rads(self, iterations=None):
        return self._load_stacked("t_radiative", iterations)

    def load_ws(self, iterations=None):
        return self._load_stacked("dilution_factor", iterations)

    def load_electron_densities(self, iterations=None):
        return self._load_stacked("electron_densities", iterations)

    def load_t_inner(self, iterations=None) -> np.ndarray:
        return self._load_scalar_series("t_inner", iterations)

    def load_luminosities(self, iterations=None):
        """Emitted / reabsorbed luminosity per iteration (erg/s)."""
        import pandas as pd

        emitted = self._load_scalar_series("emitted_luminosity", iterations)
        out = {"emitted": emitted}
        try:
            out["reabsorbed"] = self._load_scalar_series(
                "reabsorbed_luminosity", iterations
            )
        except KeyError:
            pass
        return pd.DataFrame(out)

    # ------------------------------------------------------------------
    def plot_t_rads(self, ax=None, cmap_name: str = "viridis"):
        """Overplot T_rad(shell) for every iteration, color-graded by
        iteration (analogue of the reference's convergence inspection)."""
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        t_rads = self.load_t_rads()
        cmap = plt.get_cmap(cmap_name)
        n = len(t_rads.columns)
        for k, col in enumerate(t_rads.columns):
            ax.plot(t_rads.index, t_rads[col],
                    color=cmap(k / max(n - 1, 1)), label=col)
        ax.set_xlabel("shell")
        ax.set_ylabel("T_rad [K]")
        return ax
