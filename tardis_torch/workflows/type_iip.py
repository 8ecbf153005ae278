"""Type IIP (continuum) workflow: continuum transport and thermal balance.

Counterpart of ``tardis_tpu/workflows/type_iip.py`` (the reference's
TypeIIPWorkflow, workflows/type_iip_workflow.py:41-1011).  Per iteration:

1. plasma solve (with the current per-shell link_t_rad_t_electron and the
   rate-equation electron densities; K3 builds the line tables);
2. continuum state (``plasma/continuum.py``) and the absorbing-Markov
   macro atom (``opacities/continuum_macro.py``), host numpy f64;
3. Monte Carlo transport through K1's continuum instantiation (full
   relativity, the relativistic pool under ``packet_source: auto``);
4. continuum-estimator normalization and radiation-field damping
   (:748-801);
5. T_rad / W / t_inner convergence updates;
6. thermal balance: per-shell least squares over (electron fraction,
   link_t_rad_t_electron) zeroing the fractional heating and the
   rate-equation electron-density change (:532-722), each evaluation a
   plasma solve (K3) and a continuum-state update.

The final iteration runs transport at ``last_no_of_packets`` and builds
the real-packet spectrum.  Runs on the card unless ``device="cpu"``;
with a list of devices the transport of step 3 splits its packets over
them (``simulation/base.py``).
Each stage runs inside a ``torch.profiler.record_function`` span:
``tardis.continuum_plasma``, ``tardis.continuum_macro`` and
``tardis.thermal_balance`` beside the simulation's own.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from torch.profiler import record_function

from tardis_torch.constants import SIGMA_SB
from tardis_torch.opacities.continuum_macro import solve_continuum_macro_state
from tardis_torch.plasma.continuum import ContinuumEstimators, ContinuumSolver
from tardis_torch.spectrum.base import real_packet_spectrum
from tardis_torch.workflows.simple import SimpleTARDISWorkflow

logger = logging.getLogger(__name__)


class TypeIIPWorkflow(SimpleTARDISWorkflow):
    def __init__(self, config, atom_data=None, thermal_balance_max_nfev=25,
                 device=None):
        super().__init__(config, atom_data, device)
        sim = self.sim
        if sim.atom_data.photo_ion is None:
            raise ValueError(
                "Type IIP workflow requires photoionization data in the "
                "atomic dataset"
            )
        if sim.transport.line_interaction_type != "macroatom":
            raise ValueError("IIP mode requires line_interaction_type="
                             "'macroatom' (as in the reference)")
        self.cont_solver = ContinuumSolver(sim.atom_data, sim.plasma_solver)
        self.cont_state = None
        self.cont_estimators: ContinuumEstimators | None = None
        # initial link guess: W^0.25 (reference :612-628)
        sim.plasma_solver.link_t_rad_t_electron = (
            sim.state.dilution_factor**0.25
        )
        self.thermal_balance_max_nfev = thermal_balance_max_nfev
        self._damping = np.ones(sim.state.no_of_shells)
        ci = sim.config.plasma.get("continuum_interaction", {}) or {}
        self.enable_two_photon = bool(ci.get("enable_two_photon_decay",
                                             False))
        # adiabatic k-packet cooling channel + thermal-balance term
        # (reference enable_adiabatic_cooling, schemas/plasma.yml:89)
        self.enable_adiabatic_cooling = bool(
            ci.get("enable_adiabatic_cooling", False)
        )

    # ------------------------------------------------------------------
    def solve_montecarlo(self, n_packets, iteration):
        sim = self.sim
        if sim.plasma_state is None:
            self.solve_plasma()
        with record_function("tardis.continuum_plasma"):
            self.cont_state = self.cont_solver.update(
                sim.plasma_state, self.cont_estimators
            )
        with record_function("tardis.continuum_macro"):
            macro = solve_continuum_macro_state(
                sim.atom_data, sim.plasma_state, self.cont_state,
                sim.plasma_state.j_blues,
                enable_two_photon=self.enable_two_photon,
                enable_adiabatic_cooling=self.enable_adiabatic_cooling,
                time_explosion=sim.state.time_explosion,
            )
        result = sim.transport.run_iteration(
            sim.state,
            sim.plasma_state,
            sim.atom_data,
            n_packets=n_packets,
            seed=sim.seed,
            iteration=iteration,
            need_line_estimators=False,
            lum_nu_window=sim._lum_nu_window(),
            continuum_state=self.cont_state,
            continuum_macro=macro,
        )
        sim.last_transport_result = result
        self._update_continuum_estimators(result)
        return result

    # ------------------------------------------------------------------
    def _update_continuum_estimators(self, result):
        """Apply the radiation-field damping factor (reference :803-829)."""
        sim = self.sim
        est = result.continuum
        J_model = (
            sim.state.dilution_factor
            * sim.state.t_radiative**4
            * SIGMA_SB
            / np.pi
        )
        J_estim = result.j_estimator / (
            4.0 * np.pi * result.time_of_simulation * sim.state.volume
        )
        with np.errstate(divide="ignore", invalid="ignore"):
            damping = np.where(J_estim > 0, J_model / J_estim, 1.0)
        self._damping = damping
        self.cont_estimators = ContinuumEstimators(
            photo_ion=est.photo_ion * damping[None, :],
            stim_recomb=est.stim_recomb * damping[None, :],
            bf_heating=est.bf_heating * damping[None, :],
            stim_recomb_cooling=est.stim_recomb_cooling * damping[None, :],
            photo_ion_statistics=est.photo_ion_statistics,
            ff_heating=est.ff_heating * damping,
        )

    # ------------------------------------------------------------------
    def solve_thermal_balance(self):
        """Least-squares solve for (n_e fraction, link) per shell
        (reference :612-722)."""
        from scipy.optimize import least_squares
        from scipy.sparse import block_diag

        sim = self.sim
        pl = sim.plasma_solver
        S = sim.state.no_of_shells
        t_rad = sim.state.t_radiative
        w = sim.state.dilution_factor

        max_n_e = self._max_electron_density()

        link0 = np.broadcast_to(
            np.asarray(pl.link_t_rad_t_electron, float), (S,)
        ).copy()
        n_e0 = sim.plasma_state.electron_densities
        x0 = np.empty(2 * S)
        x0[::2] = np.clip(n_e0 / max_n_e, 1e-10, 1.0)
        x0[1::2] = np.clip(link0, 1500.0 / t_rad.min(), 1.5)

        def residuals(x):
            frac = x[::2]
            link = x[1::2]
            n_e = frac * max_n_e
            pl.link_t_rad_t_electron = link
            pl._fixed_electron_densities = n_e
            ps = pl.update(t_rad, w, j_blues=sim.plasma_state.j_blues)
            cs = self.cont_solver.update(ps, self.cont_estimators)
            n_e_rate = self.cont_solver.rate_equation_electron_density(
                ps, cs
            )
            _, frac_heat = self.cont_solver.heating_minus_cooling(
                ps, cs, self.cont_estimators,
                adiabatic_cooling=self.enable_adiabatic_cooling,
                time_explosion=sim.state.time_explosion,
            )
            res = np.empty(2 * S)
            with np.errstate(divide="ignore", invalid="ignore"):
                res[::2] = (n_e_rate - n_e) / np.maximum(n_e, 1e-300)
            res[1::2] = frac_heat
            return np.where(np.isfinite(res), res, 1e3)

        lower = np.empty(2 * S)
        upper = np.empty(2 * S)
        lower[::2], upper[::2] = 1e-10, 1.0
        lower[1::2], upper[1::2] = 1500.0 / t_rad.min(), 1.5
        x0 = np.clip(x0, lower, upper)
        with record_function("tardis.thermal_balance"):
            result = least_squares(
                residuals,
                x0,
                bounds=(lower, upper),
                jac_sparsity=block_diag([np.ones((2, 2))] * S),
                xtol=1e-12,
                ftol=1e-10,
                max_nfev=self.thermal_balance_max_nfev,
                method="trf",
            )
        # apply the solution persistently (the plasma solver keeps the
        # per-shell link and fixed n_e for later updates)
        frac = result.x[::2]
        link = result.x[1::2]
        pl.link_t_rad_t_electron = link
        pl._fixed_electron_densities = frac * max_n_e
        sim._solve_plasma()
        logger.info(
            "thermal balance: link=%.3f..%.3f cost=%.3e",
            link.min(), link.max(), result.cost,
        )
        return result

    def _max_electron_density(self):
        pl = self.sim.plasma_solver
        return (pl.number_density * pl.element_z[:, None]).sum(axis=0)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def run(self):
        sim = self.sim
        for iteration in range(sim.iterations - 1):
            result = self.solve_montecarlo(sim.no_of_packets, iteration)
            converged = self.solve_simulation_state(result, iteration)
            self.solve_thermal_balance()
            sim.iterations_executed += 1
            if converged and sim.stop_if_converged:
                break
        # final iteration with the last packet count (spectra)
        result = self.solve_montecarlo(
            sim.last_no_of_packets, sim.iterations - 1
        )
        with record_function("tardis.spectrum"):
            sim.spectrum_real = real_packet_spectrum(
                result.output_nu,
                result.output_energy,
                result.emitted_mask,
                sim.spectrum_nu_edges,
                result.time_of_simulation,
            )
        self.completed = True
        return self
