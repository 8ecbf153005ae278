"""Nonhomologous-expansion workflow.

Counterpart of ``tardis_tpu/workflows/nonhomologous.py``: the standard
convergence workflow with the geometry promoted to an arbitrary
piecewise-linear velocity law and the transport solver swapped for the
nonhomologous one (K7).  The geometry starts homologous (r = v t_exp);
callers may assign any ``geometry.v_inner`` / ``v_outer`` arrays before
``run()``.  Runs on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

from tardis_torch.model.geometry import NonhomologousRadial1DGeometry
from tardis_torch.transport.solver import NonhomologousTransportSolver
from tardis_torch.workflows.simple import StandardTARDISWorkflow


class NonhomologousTARDISWorkflow(StandardTARDISWorkflow):
    def __init__(self, config, atom_data=None, show_convergence_plots=False,
                 show_progress_bars=True, device=None):
        super().__init__(config, atom_data=atom_data,
                         show_convergence_plots=show_convergence_plots,
                         show_progress_bars=show_progress_bars,
                         device=device)
        sim = self.sim
        sim.state.geometry = NonhomologousRadial1DGeometry.from_homologous(
            sim.state.geometry)
        old = sim.transport
        if old.enable_full_relativity:
            raise NotImplementedError(
                "Full relativity not supported for non-homology.")
        sim.transport = NonhomologousTransportSolver(
            line_interaction_type=old.line_interaction_type,
            disable_electron_scattering=old.disable_electron_scattering,
            disable_line_scattering=old.disable_line_scattering,
            track_last_interaction=old.track_last_interaction,
            track_rpacket_length=old.track_rpacket_length,
            inner_boundary_albedo=old.inner_boundary_albedo,
        )

    @property
    def geometry(self) -> NonhomologousRadial1DGeometry:
        return self.sim.state.geometry
