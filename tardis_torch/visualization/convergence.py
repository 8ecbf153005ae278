"""Convergence diagnostics plotting.

Counterpart of ``tardis_tpu/visualization/convergence.py`` (the
reference's live ``ConvergencePlots``,
tardis/visualization/tools/convergence_plot.py):

- :class:`ConvergencePlots` — a plotter fed from the simulation's
  callback hook (``sim.add_callback(cp.update)``), mirroring the
  reference's fetch_data / update cycle (convergence_plot.py:150-433 and
  its wiring in simulation/base.py:329-350).  It draws t_rad(v), W(v),
  t_inner and luminosity traces that accumulate as iterations complete,
  on matplotlib's Agg backend: each redraw makes a new figure, written as
  a PNG frame when ``frame_dir`` is given and shown in a notebook (IPython
  ``clear_output`` then ``display``) when ``display`` is true.  The
  simulation calls its callbacks after every convergence iteration and
  after the final one, whose call repeats the last convergence
  iteration's state and luminosity.
- :func:`plot_convergence` — the post-hoc variant from the stored history
  (``StandardTARDISWorkflow(show_convergence_plots=True)`` draws it after
  the final iteration).

matplotlib and IPython are imported inside the functions that draw.
"""

from __future__ import annotations

import numpy as np


class ConvergencePlots:
    """Live convergence plotting via the iteration callback hook.

    Usage::

        cp = ConvergencePlots()
        sim.add_callback(cp.update)
        sim.run_convergence()
        cp.figure  # accumulated traces
    """

    def __init__(self, frame_dir: str | None = None, display: bool = False):
        self.frame_dir = frame_dir
        self.display = display
        self.iterations = []
        self.t_rad_traces = []
        self.w_traces = []
        self.t_inner_trace = []
        self.l_emitted_trace = []
        self.l_requested = None
        self.v_mid = None
        self.figure = None

    def fetch_data(self, sim):
        """Record the current iteration's state (reference fetch_data)."""
        self.v_mid = np.asarray(sim.state.geometry.v_middle) / 1e5
        self.t_rad_traces.append(np.asarray(sim.state.t_radiative).copy())
        self.w_traces.append(np.asarray(sim.state.dilution_factor).copy())
        self.t_inner_trace.append(float(sim.state.t_inner))
        if sim.history:
            self.l_emitted_trace.append(
                float(sim.history[-1].emitted_luminosity)
            )
        self.l_requested = float(sim.state.luminosity_requested)
        self.iterations.append(len(self.iterations))

    def update(self, sim):
        """Callback entry point: fetch state and redraw."""
        self.fetch_data(sim)
        self.redraw()

    def redraw(self):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        if self.figure is not None:
            plt.close(self.figure)
        fig, axes = plt.subplots(2, 2, figsize=(11, 7))
        n = len(self.t_rad_traces)
        for i in range(n):
            alpha = 0.3 + 0.7 * (i + 1) / n
            axes[0, 0].plot(self.v_mid, self.t_rad_traces[i],
                            alpha=alpha, color="C0")
            axes[0, 1].plot(self.v_mid, self.w_traces[i],
                            alpha=alpha, color="C1")
        axes[0, 0].set_xlabel("v [km/s]")
        axes[0, 0].set_ylabel("T_rad [K]")
        axes[0, 1].set_xlabel("v [km/s]")
        axes[0, 1].set_ylabel("W")
        it = np.arange(len(self.t_inner_trace))
        axes[1, 0].plot(it, self.t_inner_trace, "o-")
        axes[1, 0].set_xlabel("iteration")
        axes[1, 0].set_ylabel("t_inner [K]")
        if self.l_emitted_trace:
            axes[1, 1].plot(
                np.arange(len(self.l_emitted_trace)),
                self.l_emitted_trace, "o-", label="emitted",
            )
        if self.l_requested:
            axes[1, 1].axhline(self.l_requested, ls="--", color="k",
                               label="requested")
        axes[1, 1].set_xlabel("iteration")
        axes[1, 1].set_ylabel("L [erg/s]")
        axes[1, 1].legend()
        fig.tight_layout()
        self.figure = fig
        if self.frame_dir:
            import os

            os.makedirs(self.frame_dir, exist_ok=True)
            fig.savefig(
                f"{self.frame_dir}/convergence_{len(self.iterations):03d}.png",
                dpi=100,
            )
        if self.display:  # pragma: no cover - notebook path
            try:
                from IPython import display as ipd

                ipd.clear_output(wait=True)
                ipd.display(fig)
            except ImportError:
                pass
        return fig


def plot_convergence(sim, save_path: str | None = None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    hist = sim.history
    if not hist:
        raise ValueError("no iteration history to plot")
    v_mid = sim.state.geometry.v_middle / 1e5  # km/s

    fig, axes = plt.subplots(2, 2, figsize=(11, 7))
    for i, h in enumerate(hist):
        alpha = 0.3 + 0.7 * (i + 1) / len(hist)
        axes[0, 0].plot(v_mid, h.t_radiative, alpha=alpha, color="C0")
        axes[0, 1].plot(v_mid, h.dilution_factor, alpha=alpha, color="C1")
    axes[0, 0].set_xlabel("v [km/s]")
    axes[0, 0].set_ylabel("T_rad [K]")
    axes[0, 1].set_xlabel("v [km/s]")
    axes[0, 1].set_ylabel("W")

    iters = np.arange(len(hist))
    axes[1, 0].plot(iters, [h.t_inner for h in hist], "o-")
    axes[1, 0].set_xlabel("iteration")
    axes[1, 0].set_ylabel("t_inner [K]")
    axes[1, 1].plot(iters, [h.emitted_luminosity for h in hist], "o-",
                    label="emitted")
    axes[1, 1].axhline(sim.state.luminosity_requested, ls="--", color="k",
                       label="requested")
    axes[1, 1].set_xlabel("iteration")
    axes[1, 1].set_ylabel("L [erg/s]")
    axes[1, 1].legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
    return fig
