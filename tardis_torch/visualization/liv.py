"""Last-interaction-velocity (LIV) plot.

Counterpart of ``tardis_tpu/visualization/liv.py`` (the reference's
``LIVPlotter``, tardis/visualization/tools/liv_plot.py): the distribution
of the velocity at which escaping packets last interacted in a line, split
by species, with species filtering like the SDEC plot (ions "Si II",
elements "Ca", ion ranges "S I-III"), ``nelements`` top-N selection of the
most line-interacting elements, a packet wavelength window
(``packet_wvl_range``, Angstrom), velocity re-binning (``num_bins`` over
the shell grid) and real or virtual packets.

The interaction arrays and the grouping (``_interaction_arrays``,
``_prepare``) are taken in torch on the device the transport result lives
on: K1's rows stay there, each group is one mask over them, and only each
group's velocities reach the host (``plot_data``).  The step plots are
drawn from those host arrays, with matplotlib imported inside
``generate_plot_mpl`` or plotly inside ``generate_plot_ply``.
"""

from __future__ import annotations

import numpy as np
import torch

from tardis_torch.atomic.atom_data import ATOMIC_SYMBOLS
from tardis_torch.constants import C
from tardis_torch.transport.tables import NU_UNIT
from tardis_torch.visualization.sdec import (
    _parse_species_list,
    _roman,
    on_device,
)


class LIVPlotter:
    """Velocity distribution of last line interactions, by species."""

    def __init__(self, sim):
        res = sim.last_transport_result
        if res is None or res._li is None:
            raise ValueError(
                "LIV plot needs a finished simulation with last-interaction "
                "tracking (montecarlo.tracking.track_last_interaction)"
            )
        self.sim = sim
        self.res = res
        self.atom = sim.atom_data
        self.device = res._out.device

    @classmethod
    def from_simulation(cls, sim):
        return cls(sim)

    @classmethod
    def from_workflow(cls, workflow):
        return cls(workflow.sim)

    # ------------------------------------------------------------------
    def _interaction_arrays(self, packets_mode):
        """(velocity km/s, Z, ion, lab nu Hz) of the last line
        interactions, tensors on the result's device."""
        t_exp = self.sim.state.time_explosion
        if packets_mode == "virtual":
            vp = self.res.vpackets
            if vp is None:
                raise ValueError(
                    "virtual packets_mode needs virtual-packet tracking "
                    "(spectrum.virtual.virtual_packet_logging)"
                )
            dev, f64 = self.device, torch.float64
            m = on_device(vp["virt_packet_last_interaction_type"], dev) == 2
            out_line = on_device(
                vp["virt_packet_last_line_interaction_out_id"], dev,
                torch.long)[m]
            r = on_device(vp["virt_packet_initial_rs"], dev, f64)[m]
            nus = on_device(vp["virt_packet_nus"], dev, f64)[m]
        else:
            li = self.res._li
            m = (self.res._out[:, 0] > 0) & (li[:, 0] == 2)
            out_line = li[m, 2].long()
            r = li[m, 5].double() * self.res.length_unit
            nus = li[m, 4].double() * NU_UNIT
        v = r / t_exp / 1e5  # km/s
        lid = out_line.clamp(0, self.atom.n_lines - 1)
        z = on_device(self.atom.line_z, self.device, torch.long)[lid]
        ion = on_device(self.atom.line_ion, self.device, torch.long)[lid]
        return v, z, ion, nus

    # ------------------------------------------------------------------
    def _prepare(self, packets_mode, packet_wvl_range, species_list,
                 nelements, num_bins):
        """``plot_data`` (each group's velocities, km/s, in packet order),
        the groups' labels and the velocity bin edges."""
        v, z, ion, nus = self._interaction_arrays(packets_mode)
        if v.numel() == 0:
            raise ValueError(
                "No line interactions found in the packet data. The LIV "
                "plot requires packets that underwent line interactions."
            )
        if packet_wvl_range is not None:
            lo_a, hi_a = packet_wvl_range  # Angstrom
            lam = C / nus * 1e8
            m = (lam >= lo_a) & (lam <= hi_a)
            v, z, ion = v[m], z[m], ion[m]
        if nelements is not None:
            zs, counts = torch.unique(z, return_counts=True)
            # the JAX package's np.argsort(-counts): ties by element
            order = np.argsort(-counts.cpu().numpy())
            species_list = [ATOMIC_SYMBOLS[zz - 1]
                            for zz in zs.cpu().numpy()[order][:nelements]]
        species_filter = _parse_species_list(species_list)

        # a packet goes to (Z, ion) where the filter names its ion, else to
        # (Z, None) where the filter names its element (no filter: every
        # packet by element)
        groups = {}
        pairs = torch.unique(torch.stack([z, ion], dim=1), dim=0).tolist()
        for zi, ii in pairs:
            if species_filter is None or (
                    (zi, ii) not in species_filter
                    and (zi, None) in species_filter):
                key = (zi, None)
            elif (zi, ii) in species_filter:
                key = (zi, ii)
            else:
                continue
            groups.setdefault(key, []).append(ii)
        if not groups:
            raise ValueError(
                f"No valid species found for plotting. Requested: "
                f"{species_list}"
            )
        keys = sorted(groups, key=lambda k: (k[0], -1 if k[1] is None
                                             else k[1]))
        ions = {k: on_device(groups[k], self.device, torch.long) for k in keys}
        self.plot_data = [
            v[(z == k[0]) & torch.isin(ion, ions[k])].cpu().numpy()
            for k in keys]
        self._species_name = [
            ATOMIC_SYMBOLS[k[0] - 1] if k[1] is None
            else f"{ATOMIC_SYMBOLS[k[0] - 1]} {_roman(k[1])}" for k in keys]

        geo = self.sim.state.geometry
        bin_edges = np.concatenate([[geo.v_inner[0]], geo.v_outer]) / 1e5
        if num_bins:
            if num_bins < 1:
                raise ValueError("Number of bins must be positive")
            num_bins = min(num_bins, len(bin_edges) - 1)
            bin_edges = np.linspace(bin_edges[0], bin_edges[-1],
                                    num_bins + 1)
        self.bin_edges = bin_edges

    def _set_colors(self, cmapname):
        """``plot_colors``: one RGBA tuple a group from ``cmapname``."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        cmap = plt.get_cmap(cmapname, len(self.plot_data))
        self.plot_colors = [cmap(i) for i in range(len(self.plot_data))]

    @staticmethod
    def _step_data(data, bin_edges):
        """Histogram -> step-plot x / y."""
        hist, _ = np.histogram(data, bins=bin_edges)
        x = np.repeat(bin_edges, 2)[1:-1]
        y = np.repeat(hist, 2)
        return x, y

    # ------------------------------------------------------------------
    def generate_plot_mpl(
        self,
        packets_mode: str = "real",
        packet_wvl_range=None,
        species_list=None,
        nelements=None,
        num_bins=None,
        log_scale: bool = False,
        cmapname: str = "jet",
        ax=None,
        save_path=None,
    ):
        """Matplotlib step plot, one line a group."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self._prepare(packets_mode, packet_wvl_range, species_list,
                      nelements, num_bins)
        self._set_colors(cmapname)
        if ax is None:
            _, ax = plt.subplots(figsize=(10, 5))
        for data, color, name in zip(
            self.plot_data, self.plot_colors, self._species_name
        ):
            x, y = self._step_data(data, self.bin_edges)
            ax.plot(x, y, color=color, label=name, drawstyle="default",
                    linewidth=1.5)
        if log_scale:
            ax.set_yscale("log")
        ax.set_xlabel("Last Interaction Velocity [km/s]")
        ax.set_ylabel("Packet Count")
        ax.legend(fontsize=9)
        ax.figure.tight_layout()
        if save_path:
            ax.figure.savefig(save_path, dpi=120)
        return ax

    def generate_plot_ply(
        self,
        packets_mode: str = "real",
        packet_wvl_range=None,
        species_list=None,
        nelements=None,
        num_bins=None,
        log_scale: bool = False,
        cmapname: str = "jet",
        fig=None,
    ):
        """Interactive plotly step plot, one line a group, on ``fig`` or a
        new figure.  Requires plotly (and matplotlib for the colour map);
        raises ImportError otherwise."""
        import plotly.graph_objects as go
        from matplotlib.colors import to_hex

        self._prepare(packets_mode, packet_wvl_range, species_list,
                      nelements, num_bins)
        self._set_colors(cmapname)
        if fig is None:
            fig = go.Figure()
        for data, color, name in zip(
            self.plot_data, self.plot_colors, self._species_name
        ):
            x, y = self._step_data(data, self.bin_edges)
            fig.add_trace(go.Scatter(
                x=x, y=y, mode="lines", name=name,
                line=dict(color=to_hex(color), width=1.5)))
        fig.update_layout(
            xaxis_title="Last Interaction Velocity [km/s]",
            yaxis_title="Packet Count",
            yaxis_type="log" if log_scale else "linear",
            height=500,
        )
        return fig
