"""Composable workflow API.

Counterpart of ``tardis_tpu/workflows/simple.py`` (the reference's
simple_tardis_workflow.py:36-540 and standard_tardis_workflow.py:16): the
convergence loop of ``Simulation`` exposed as overridable stages
(solve_plasma / solve_montecarlo / solve_simulation_state /
solve_spectrum), so custom workflows subclass and replace single stages.
Runs on the card unless ``device="cpu"`` is passed; with a list of
devices the simulation lives on the first and the classic event loop
splits its packets over all of them, as the JAX workflows' default
``TransportSolver(mesh="auto")`` does over every visible device.
``StandardTARDISWorkflow(show_convergence_plots=True)`` draws the
convergence plots (``visualization/convergence.py``) after the final
iteration, as the JAX workflow does.
"""

from __future__ import annotations

import logging

import torch

from tardis_torch.config.reader import ConfigDict, config_from_dict
from tardis_torch.simulation.base import Simulation

logger = logging.getLogger(__name__)


class SimpleTARDISWorkflow:
    """Stage-decomposed convergence workflow."""

    def __init__(self, config, atom_data=None, device=None):
        if not isinstance(config, ConfigDict):
            config = config_from_dict(config)
        self.sim = Simulation.from_config(config, atom_data=atom_data,
                                          device=device)
        self.completed = False

    # --- stages (override points) -------------------------------------
    def solve_plasma(self, estimator_j_blues=None):
        self.sim._solve_plasma(estimator_j_blues)
        return self.sim.plasma_state

    def solve_montecarlo(self, n_packets, iteration):
        return self.sim.iterate(n_packets, iteration)

    def solve_simulation_state(self, transport_result, iteration):
        return self.sim.advance_state(transport_result, iteration)

    def solve_spectrum(self):
        self.sim.run_final()
        return self.sim.spectrum_real

    # --- the iteration loop -------------------------------------------
    @torch.no_grad()
    def run(self):
        sim = self.sim
        for iteration in range(sim.iterations - 1):
            result = self.solve_montecarlo(sim.no_of_packets, iteration)
            converged = self.solve_simulation_state(result, iteration)
            sim.iterations_executed += 1
            if converged and sim.stop_if_converged:
                break
        self.solve_spectrum()
        self.completed = True
        return self

    # convenience accessors matching the reference attribute names
    @property
    def simulation_state(self):
        return self.sim.state

    @property
    def spectrum_solver(self):
        return self.sim

    @property
    def transport_state(self):
        return self.sim.last_transport_result


class StandardTARDISWorkflow(SimpleTARDISWorkflow):
    """Adds per-iteration logging, an iteration progress bar, a packet bar
    and, with ``show_convergence_plots``, the convergence plots after the
    final iteration (reference standard_tardis_workflow.py:16)."""

    def __init__(self, config, atom_data=None, show_convergence_plots=False,
                 show_progress_bars=True, device=None):
        super().__init__(config, atom_data, device)
        self.show_convergence_plots = show_convergence_plots
        self.show_progress_bars = show_progress_bars
        # the in-run packet bar rides the same flag: it advances once per
        # K1 launch (per shard under packet parallelism)
        self.sim.transport.show_packet_progress = bool(show_progress_bars)

    @torch.no_grad()
    def run(self):
        sim = self.sim
        iterator = range(sim.iterations - 1)
        if self.show_progress_bars:
            try:
                from tqdm.auto import tqdm

                iterator = tqdm(iterator, desc="iterations")
            except ImportError:  # pragma: no cover
                pass
        for iteration in iterator:
            result = self.solve_montecarlo(sim.no_of_packets, iteration)
            converged = self.solve_simulation_state(result, iteration)
            sim.iterations_executed += 1
            rec = sim.history[-1]
            logger.info(
                "iter %d: t_inner=%.1f L=%.3e/%.3e",
                iteration,
                rec.t_inner,
                rec.emitted_luminosity,
                sim.state.luminosity_requested,
            )
            if converged and sim.stop_if_converged:
                break
        self.solve_spectrum()
        if self.show_convergence_plots:
            self.plot_convergence()
        self.completed = True
        return self

    def plot_convergence(self):
        from tardis_torch.visualization.convergence import plot_convergence

        return plot_convergence(self.sim)
