"""R-packet trajectory plot.

Counterpart of ``tardis_tpu/visualization/rpacket.py`` (the reference's
``RPacketPlotter``, tardis/visualization/tools/rpacket_plot.py): 2-D
projected trajectories of tracked packets through the shell structure,
colour-coded by interaction type, from K1's r-packet tracker
(``montecarlo.tracking.track_rpacket``: (r, nu, energy, shell, event type,
mu after the event) per event).

The polar-angle propagation follows the reference's geometry
(rpacket_plot.py:450-531): at each step theta advances by acos(mu_prev),
corrected by asin(r_prev sin(acos mu_prev) / r) on the inbound or
outbound branch chosen by the radius change.  Each step's advance depends
only on the step's own two events, so ``get_coordinates_multiple_packets``
takes every plotted packet's angles at once as a cumulative sum over the
tracker rows, in torch on the device they live on (the JAX package loops
over the steps in numpy; the sums agree to rounding).

The figures are drawn from those host arrays: the animated plotly figure
(``generate_plot``, plotly imported inside it) and a static matplotlib one
(``generate_plot_mpl``, matplotlib imported inside it).
"""

from __future__ import annotations

import numpy as np
import torch

# event-type codes of K1's tracker: 1 e-scatter, 2 line, 3 boundary,
# 4 continuum process; 0 past the packet's last event
_INTERACTION_PROPS = {
    0: {"text": "No Interaction", "color": "#2E86AB", "opacity": 0.8},
    3: {"text": "Boundary", "color": "#A23B72", "opacity": 0.8},
    2: {"text": "Line Interaction", "color": "#F18F01", "opacity": 0.8},
    1: {"text": "E-Scattering", "color": "#C73E1D", "opacity": 0.8},
    4: {"text": "Continuum", "color": "#6A4C93", "opacity": 0.8},
}

_THEMES = {
    "light": dict(
        plot_bgcolor="#fafafa", paper_bgcolor="#fafafa", font_color="#000",
        shells_line_color="black", photosphere_fillcolor="darkgrey",
        packet_line_color="darkslategrey", gridcolor="#fafafa",
    ),
    "dark": dict(
        plot_bgcolor="#000", paper_bgcolor="#000", font_color="#fafafa",
        shells_line_color="#555", photosphere_fillcolor="#222",
        packet_line_color="#888", gridcolor="#111",
    ),
}


class RPacketPlotter:
    """2-D r-packet trajectory visualization."""

    def __init__(self, sim, no_of_packets: int = 15):
        if no_of_packets <= 0:
            raise ValueError("no_of_packets must be positive")
        res = sim.last_transport_result
        if res is None or res._tracker is None:
            raise AttributeError(
                "There is no rpacket_tracker in the simulation object. "
                "Enable montecarlo.tracking.track_rpacket in the "
                "configuration first."
            )
        self.sim = sim
        self.res = res
        self.no_of_packets = min(no_of_packets, res._tracker.shape[0])

    @classmethod
    def from_simulation(cls, sim, no_of_packets: int = 15):
        return cls(sim, no_of_packets=no_of_packets)

    # ------------------------------------------------------------------
    def _steps(self):
        """The plotted packets' tracker rows with their events first:
        (r km/s, mu, type, valid) as (P, K) tensors on the tracker's
        device, and each packet's event count."""
        tr = self.res._tracker[:self.no_of_packets]
        types = tr[:, :, 4].long()
        valid = types != 0
        order = torch.argsort((~valid).int(), dim=1, stable=True)

        def take(x):
            return torch.gather(x, 1, order)

        t_exp = self.sim.state.time_explosion
        r = take(tr[:, :, 0]).double() * self.res.length_unit * 1e-5 / t_exp
        return r, take(tr[:, :, 5]).double(), take(types), take(valid), \
            valid.sum(dim=1)

    def _packet_steps(self, p):
        """Valid (r km/s, mu, type) sequences of packet p (host arrays)."""
        r, mu, types, _, n = self._steps()
        k = int(n[p])
        return (r[p, :k].cpu().numpy(), mu[p, :k].cpu().numpy(),
                types[p, :k].cpu().numpy().astype(np.int8))

    @staticmethod
    def get_coordinates_with_theta_init(r, mu, types, theta0=0.0):
        """2-D coordinates of one packet's steps (host arrays)."""
        x, y = _coordinates(torch.as_tensor(r)[None], torch.as_tensor(mu)[
            None], torch.full((1,), float(theta0), dtype=torch.float64))
        return x[0].numpy(), y[0].numpy(), types

    def get_coordinates_multiple_packets(self):
        """Coordinates of every plotted packet (launch angles uniform in
        [0, 2 pi)), taken on the tracker's device: lists of host arrays
        (x, y, types), one entry a packet."""
        r, mu, types, valid, n = self._steps()
        thetas = torch.linspace(0, 2 * np.pi, self.no_of_packets + 1,
                                dtype=torch.float64, device=r.device)
        x, y = _coordinates(r, mu, thetas[:-1])
        x, y, types, n = (t.cpu().numpy() for t in (x, y, types, n))
        return ([x[p, :n[p]] for p in range(len(n))],
                [y[p, :n[p]] for p in range(len(n))],
                [types[p, :n[p]].astype(np.int8) for p in range(len(n))])

    @staticmethod
    def get_equal_array_size(xs, ys, tys):
        """Pad every trajectory to the longest length (for frame sync)."""
        m = max(len(x) for x in xs) if xs else 0
        for i in range(len(xs)):
            pad = m - len(xs[i])
            if pad > 0:
                xs[i] = np.append(xs[i], np.full(pad, xs[i][-1]))
                ys[i] = np.append(ys[i], np.full(pad, ys[i][-1]))
                tys[i] = np.append(tys[i], np.full(pad, tys[i][-1]))
        return xs, ys, tys, m

    # ------------------------------------------------------------------
    def _shell_velocities(self):
        geo = self.sim.state.geometry
        t_exp = self.sim.state.time_explosion
        return np.concatenate([[geo.r_inner[0]], geo.r_outer]) * 1e-5 / t_exp

    def generate_plot(self, theme: str = "light"):
        """Animated plotly figure: the shells, each packet's trajectory as a
        line and its events as markers, a legend entry an interaction type,
        one frame a step with a step slider and play / pause buttons.
        Requires plotly; raises ImportError otherwise."""
        import plotly.graph_objects as go

        th = _THEMES[theme]
        xs, ys, tys = self.get_coordinates_multiple_packets()
        xs, ys, tys, m = self.get_equal_array_size(xs, ys, tys)
        shells_v = self._shell_velocities()
        vmax = shells_v[-1] * 1.05

        fig = go.Figure()
        # the photosphere, then the shells
        for k, v in enumerate(shells_v):
            fig.add_shape(
                type="circle", xref="x", yref="y",
                x0=-v, y0=-v, x1=v, y1=v,
                line=dict(color=th["shells_line_color"],
                          width=1.5 if k == 0 else 0.5),
                fillcolor=th["photosphere_fillcolor"] if k == 0 else None,
                opacity=1.0 if k == 0 else 0.6,
            )
        # each packet's whole trajectory: a line trace and a marker trace
        for p in range(len(xs)):
            fig.add_trace(go.Scatter(
                x=xs[p], y=ys[p], mode="lines",
                line=dict(color=th["packet_line_color"], width=1.2),
                name=f"packet {p}", showlegend=False))
            props = [_INTERACTION_PROPS.get(c, _INTERACTION_PROPS[0])
                     for c in np.asarray(tys[p], int)]
            fig.add_trace(go.Scatter(
                x=xs[p], y=ys[p], mode="markers", showlegend=False,
                marker=dict(color=[q["color"] for q in props], size=5,
                            opacity=0.8),
                text=[q["text"] for q in props],
                hovertemplate="%{text}<br>vx=%{x:.0f} km/s"
                "<br>vy=%{y:.0f} km/s<extra></extra>"))
        # a legend entry an interaction type, boundaries left out
        for code, props in _INTERACTION_PROPS.items():
            if code == 3:
                continue
            fig.add_trace(go.Scatter(
                x=[None], y=[None], mode="markers",
                marker=dict(color=props["color"], size=7),
                name=props["text"], showlegend=True))

        # one frame a step: every trajectory up to that step
        fig.frames = [
            go.Frame(
                data=[trace for p in range(len(xs)) for trace in (
                    go.Scatter(x=xs[p][: s + 1], y=ys[p][: s + 1],
                               mode="lines"),
                    go.Scatter(x=xs[p][: s + 1], y=ys[p][: s + 1],
                               mode="markers"))],
                name=str(s))
            for s in range(m)
        ]
        slider_steps = [
            {"args": [[str(s)], {"frame": {"duration": 0, "redraw": False},
                                 "mode": "immediate"}],
             "label": str(s), "method": "animate"}
            for s in range(m)
        ]
        fig.update_layout(
            width=700, height=700,
            plot_bgcolor=th["plot_bgcolor"],
            paper_bgcolor=th["paper_bgcolor"],
            font=dict(color=th["font_color"]),
            title="R-packet trajectories",
            xaxis=dict(title="velocity [km/s]", range=[-vmax, vmax],
                       gridcolor=th["gridcolor"]),
            yaxis=dict(title="velocity [km/s]", range=[-vmax, vmax],
                       scaleanchor="x", gridcolor=th["gridcolor"]),
            updatemenus=[{
                "type": "buttons",
                "buttons": [
                    {"label": "Play", "method": "animate",
                     "args": [None, {
                         "frame": {"duration": 500, "redraw": False},
                         "fromcurrent": True,
                         "transition": {"duration": 300,
                                        "easing": "quadratic-in-out"}}]},
                    {"label": "Pause", "method": "animate",
                     "args": [[None], {
                         "frame": {"duration": 0, "redraw": False},
                         "mode": "immediate",
                         "transition": {"duration": 0}}]},
                ],
            }],
            sliders=[{"active": 0, "steps": slider_steps,
                      "currentvalue": {"prefix": "Step: "}}],
        )
        return fig

    def generate_plot_mpl(self, save_path=None, theme: str = "light"):
        """Static matplotlib rendering of the trajectories."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        th = _THEMES[theme]
        xs, ys, tys = self.get_coordinates_multiple_packets()
        shells_v = self._shell_velocities()
        fig, ax = plt.subplots(figsize=(7, 7))
        for k, v in enumerate(shells_v):
            ax.add_patch(plt.Circle(
                (0, 0), v, fill=(k == 0), lw=1.5 if k == 0 else 0.4,
                color=th["photosphere_fillcolor"] if k == 0
                else th["shells_line_color"]))
        for p in range(len(xs)):
            ax.plot(xs[p], ys[p], lw=0.8, color=th["packet_line_color"])
            codes = np.asarray(tys[p], int)
            for code, props in _INTERACTION_PROPS.items():
                sel = codes == code
                if sel.any() and code not in (0, 3):
                    ax.scatter(xs[p][sel], ys[p][sel], s=8,
                               color=props["color"], zorder=3,
                               label=props["text"] if p == 0 else None)
        vmax = shells_v[-1] * 1.05
        ax.set_xlim(-vmax, vmax)
        ax.set_ylim(-vmax, vmax)
        ax.set_aspect("equal")
        ax.set_xlabel("velocity [km/s]")
        ax.set_ylabel("velocity [km/s]")
        ax.set_title("R-packet trajectories")
        handles, _ = ax.get_legend_handles_labels()
        if handles:
            ax.legend(loc="upper right", fontsize=8)
        if save_path:
            fig.savefig(save_path, dpi=120, bbox_inches="tight")
        return fig


def _coordinates(r, mu, theta0):
    """(x, y) of (P, K) steps: theta_0 = ``theta0`` (P,), theta_i =
    theta_i-1 + acos(mu_i-1) + (r_i < r_i-1 ? asin(s) - pi : -asin(s)) with
    s = r_i-1 sin(acos mu_i-1) / r_i clipped to [-1, 1].  Entries past a
    packet's last step are garbage the caller cuts off."""
    acos_mu = torch.arccos(mu[:, :-1].clamp(-1.0, 1.0))
    s = (r[:, :-1] * torch.sin(acos_mu) / r[:, 1:]).clamp(-1.0, 1.0)
    inward = r[:, 1:] < r[:, :-1]
    step = torch.where(inward, acos_mu - np.pi + torch.arcsin(s),
                       acos_mu + torch.arcsin(-s))
    theta = torch.cat([theta0[:, None],
                       theta0[:, None] + torch.cumsum(step, dim=1)], dim=1)
    return r * torch.cos(theta), r * torch.sin(theta)
