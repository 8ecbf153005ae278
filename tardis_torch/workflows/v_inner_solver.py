"""Inner-velocity solver workflow.

Counterpart of ``tardis_tpu/workflows/v_inner_solver.py`` (the
reference's ``InnerVelocitySolverWorkflow``,
tardis/workflows/v_inner_solver.py:23-312): each iteration the
Rosseland-mean integrated optical depth profile (``get_tau_integ``, on
the device that holds K3's tau table) is interpolated to find the
velocity where tau reaches its target (2/3: the photosphere), and the
inner boundary moves there, damped, before the next iteration.

As in the JAX package the shell count stays fixed: the grid is rebuilt
from the moved inner edge and the density, abundances, t_rad and W are
re-interpolated onto it.  Everything the port derives from the grid is
rebuilt from the new one: the plasma solver's element number densities
(``_build_index_maps``), and, because the plasma state is dropped, the
line tables, the transport tables and the packet pool of the next
iteration, which are built per run from ``sim.state``.

The JAX workflow turns off its device line-plasma mode, whose states
carry no host tau table; the port has one line mode, and its final
iteration re-solves the plasma because the boundary move leaves none
(``Simulation.run_final``).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from tardis_torch.model.geometry import Radial1DGeometry
from tardis_torch.workflows.simple import SimpleTARDISWorkflow
from tardis_torch.workflows.util import get_tau_integ

logger = logging.getLogger(__name__)


class InnerVelocitySolverWorkflow(SimpleTARDISWorkflow):
    def __init__(self, config, atom_data=None, tau: float = 2.0 / 3.0,
                 mean_optical_depth: str = "rosseland",
                 damping_factor: float = 0.5, device=None):
        super().__init__(config, atom_data, device)
        self.log_tau_target = np.log(tau)
        self.mean_optical_depth = mean_optical_depth
        self.damping_factor = damping_factor
        self.v_inner_history: list[float] = []

    def estimate_v_inner(self) -> float:
        """Velocity where the integrated mean optical depth hits the target
        (reference v_inner_solver.py:148-190)."""
        sim = self.sim
        tau_integ = np.log(
            np.clip(
                get_tau_integ(
                    sim.plasma_state, sim.atom_data, sim.state
                )[self.mean_optical_depth],
                1e-300,
                None,
            )
        )
        v_inner_grid = sim.state.geometry.v_inner
        # tau decreases outward: interpolate v(log tau)
        order = np.argsort(tau_integ)
        est = np.interp(
            self.log_tau_target, tau_integ[order], v_inner_grid[order]
        )
        return float(np.clip(est, v_inner_grid[0], v_inner_grid[-1]))

    def advance_v_inner(self):
        sim = self.sim
        if sim.plasma_state is None:
            self.solve_plasma()
        est = self.estimate_v_inner()
        old = sim.state.geometry.v_inner[0]
        new = old + self.damping_factor * (est - old)
        self.v_inner_history.append(new)
        # the grid rebuilt with the moved inner edge, same shell count
        geo = sim.state.geometry
        edges = np.linspace(new, geo.v_outer[-1], geo.no_of_shells + 1)
        v_mid_old = geo.v_middle
        new_geo = Radial1DGeometry.from_velocity_grid(
            edges, geo.time_explosion
        )
        # density, abundances and the radiation field re-interpolated
        # onto it
        comp = sim.state.composition
        comp.density = np.interp(new_geo.v_middle, v_mid_old, comp.density)
        comp.mass_fractions = np.stack(
            [
                np.interp(new_geo.v_middle, v_mid_old, comp.mass_fractions[i])
                for i in range(comp.mass_fractions.shape[0])
            ]
        )
        sim.state.t_radiative = np.interp(
            new_geo.v_middle, v_mid_old, sim.state.t_radiative
        )
        sim.state.dilution_factor = np.interp(
            new_geo.v_middle, v_mid_old, sim.state.dilution_factor
        )
        sim.state.geometry = new_geo
        # the element number densities follow the new density
        sim.plasma_solver._build_index_maps(sim.state)
        sim.plasma_state = None
        logger.info("v_inner moved %.1f -> %.1f km/s", old / 1e5, new / 1e5)

    @torch.no_grad()
    def run(self):
        sim = self.sim
        for iteration in range(sim.iterations - 1):
            result = self.solve_montecarlo(sim.no_of_packets, iteration)
            self.solve_simulation_state(result, iteration)
            self.advance_v_inner()
            sim.iterations_executed += 1
        self.solve_spectrum()
        self.completed = True
        return self
