"""Simulation orchestration: the classic convergence loop and final run.

Counterpart of ``tardis_tpu/simulation/base.py`` (``Simulation``,
``run_convergence``, ``run_final``, ``integrate_spectrum``, ``run_tardis``).
Each iteration solves the plasma (K3 line tables), builds the macro-atom
chain tables, samples the packet pool (K2) and runs the event loop (K1);
``advance_state`` inverts the estimators and applies the damped updates.
``run_final`` runs one more transport at ``last_no_of_packets``: with
``no_of_virtual_packets`` > 0, K1 writes spawn records and the vpacket
volley (K4) builds the virtual spectrum; it builds the real-packet spectrum
and, with ``spectrum.method: integrated``, the formal-integral spectrum
(host source function, rays on K5).

Each stage runs inside a ``torch.profiler.record_function`` span named
``tardis.<stage>`` (plasma, macro_chain, transport_tables, packet_source,
transport_loop, vpacket_volley, finalize, radiation_field, spectrum,
source_function, formal_integral); a span costs a few microseconds when no
profiler is recording, and ``chip_smoke.py`` reads them.

Everything runs on one device, the card unless the caller passes another.
Options outside this slice raise ``NotImplementedError`` naming the option
(see ``check_supported``): tracking, full relativity, the reflective inner
boundary, nonhomologous expansion, non-simple packet sources, continuum,
NLTE, detailed rates, helium, vpacket biasing, the macro-atom random-walk
fallback, HDF atom data and more than one device.  Checkpoint / resume is
not ported.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from tardis_torch.atomic.synthetic import make_synthetic_atom_data
from tardis_torch.config.reader import ConfigDict
from tardis_torch.constants import C
from tardis_torch.cuda import resolve_device
from tardis_torch.model.state import SimulationState
from tardis_torch.plasma.solver import PlasmaSolver
from tardis_torch.simulation.convergence import (
    ConvergenceState,
    make_convergence_solvers,
)
from tardis_torch.spectrum.base import (
    Spectrum,
    frequency_grid,
    real_packet_spectrum,
)
from tardis_torch.spectrum.formal_integral import FormalIntegralSolver
from tardis_torch.transport.solver import (
    TransportResult,
    TransportSolver,
    solve_radiation_field,
)

logger = logging.getLogger(__name__)


@dataclass
class IterationRecord:
    """Per-iteration plasma / radiation state."""

    t_radiative: np.ndarray
    dilution_factor: np.ndarray
    t_inner: float
    electron_densities: np.ndarray
    emitted_luminosity: float
    reabsorbed_luminosity: float


# the JAX package's accepted values; every one runs the rays on the
# simulation's device
INTEGRATED_COMPUTE = ("jax", "cpu", "gpu", "automatic", "")


def check_supported(config: ConfigDict) -> None:
    """Raise ``NotImplementedError`` for every option this slice refuses."""
    mc = config.montecarlo
    plasma = config.plasma
    tracking = mc.get("tracking", {}) or {}
    virtual = config.spectrum.get("virtual", {}) or {}
    refused = [
        ("spectrum.virtual.enable_biasing",
         bool(virtual.get("enable_biasing", False))),
        ("montecarlo.tracking.track_last_interaction",
         bool(tracking.get("track_last_interaction", False))),
        ("montecarlo.tracking.track_rpacket",
         bool(tracking.get("track_rpacket", False))),
        ("montecarlo.enable_full_relativity",
         bool(mc.get("enable_full_relativity", False))),
        ("montecarlo.enable_reflective_inner_boundary",
         bool(mc.get("enable_reflective_inner_boundary", False))),
        ("montecarlo.enable_nonhomologous_expansion",
         bool(mc.get("enable_nonhomologous_expansion", False))),
        ("montecarlo.packet_source other than simple",
         mc.get("packet_source", "auto") not in ("auto", "simple")),
        ("plasma.continuum_interaction.species",
         bool((plasma.get("continuum_interaction", {}) or {})
              .get("species"))),
        ("plasma.nlte.species",
         bool((plasma.get("nlte", {}) or {}).get("species"))),
        ("plasma.radiative_rates_type: detailed",
         plasma.get("radiative_rates_type") == "detailed"),
        ("plasma.helium_treatment",
         plasma.get("helium_treatment", "none") not in ("none", None)),
    ]
    for name, hit in refused:
        if hit:
            raise NotImplementedError(f"{name} is not ported yet")
    compute = str((config.spectrum.get("integrated", {}) or {})
                  .get("compute", "jax")).lower()
    if compute not in INTEGRATED_COMPUTE:
        raise ValueError(
            f"spectrum.integrated.compute={compute!r}: one device path "
            "serves every value; accepted are " + ", ".join(
                repr(c) for c in INTEGRATED_COMPUTE)
        )


class Simulation:
    def __init__(self, config: ConfigDict, simulation_state: SimulationState,
                 atom_data, plasma_solver: PlasmaSolver,
                 transport_solver: TransportSolver):
        self.config = config
        self.state = simulation_state
        self.atom_data = atom_data
        self.plasma_solver = plasma_solver
        self.transport = transport_solver

        mc = config.montecarlo
        self.iterations = mc.iterations
        self.no_of_packets = mc.no_of_packets
        self.last_no_of_packets = mc.last_no_of_packets
        self.seed = mc.seed
        strategy = mc.convergence_strategy
        self.convergence_solvers = make_convergence_solvers(strategy)
        self.convergence_state = ConvergenceState(
            hold_iterations=int(strategy.get("hold_iterations", 3))
        )
        self.stop_if_converged = bool(strategy.get("stop_if_converged", False))
        self.lock_t_inner_cycles = int(strategy.get("lock_t_inner_cycles", 1))
        self.t_inner_update_exponent = float(
            strategy.get("t_inner_update_exponent", -0.5)
        )
        sn = config.supernova
        self.lum_wavelength_start = sn.get("luminosity_wavelength_start", 0.0)
        self.lum_wavelength_end = sn.get("luminosity_wavelength_end",
                                         float("inf"))

        self.plasma_state = None
        self.history: list[IterationRecord] = []
        self.iterations_executed = 0
        self.last_transport_result: TransportResult | None = None
        self.spectrum_real: Spectrum | None = None
        self.spectrum_virtual: Spectrum | None = None
        self.spectrum_integrated: Spectrum | None = None
        spec = config.spectrum
        self.spectrum_nu_edges = frequency_grid(spec.start, spec.stop,
                                                spec.num)
        self._callbacks = []

    @classmethod
    def from_config(cls, config: ConfigDict, atom_data=None,
                    device=None) -> "Simulation":
        device = resolve_device(device)
        check_supported(config)
        state = SimulationState.from_config(config)
        lit = config.plasma.line_interaction_type
        if atom_data is None:
            if config.atom_data not in (None, "synthetic"):
                raise NotImplementedError(
                    "atom_data files: the HDF loader is not ported yet"
                )
            atom_data = make_synthetic_atom_data()
        if atom_data.species_z is None:
            atom_data = atom_data.prepare(
                selected_atoms=list(state.composition.atomic_numbers),
                line_interaction_type=lit,
            )
        plasma_solver = PlasmaSolver(
            atom_data,
            state,
            device,
            ionization=config.plasma.ionization,
            excitation=config.plasma.excitation,
            radiative_rates_type=config.plasma.radiative_rates_type,
            link_t_rad_t_electron=config.plasma.get(
                "link_t_rad_t_electron", 0.9),
            w_epsilon=config.plasma.get("w_epsilon", 1e-10),
        )
        transport_solver = TransportSolver(
            line_interaction_type=lit,
            disable_electron_scattering=config.plasma.get(
                "disable_electron_scattering", False),
            disable_line_scattering=config.plasma.get(
                "disable_line_scattering", False),
            vpacket_tracking=bool(
                (config.spectrum.get("virtual", {}) or {})
                .get("virtual_packet_logging", False)),
        )
        return cls(config, state, atom_data, plasma_solver, transport_solver)

    def add_callback(self, fn):
        """fn(simulation) is called after each iteration."""
        self._callbacks.append(fn)

    def _solve_plasma(self):
        with record_function("tardis.plasma"):
            self.plasma_state = self.plasma_solver.update(
                self.state.t_radiative, self.state.dilution_factor
            )

    def _lum_nu_window(self):
        """(nu_min, nu_max) of the luminosity wavelength window [Hz]."""
        lam_lo, lam_hi = self.lum_wavelength_start, self.lum_wavelength_end
        nu_min = C / lam_hi if lam_hi > 0 and np.isfinite(lam_hi) else 0.0
        nu_max = C / lam_lo if lam_lo > 0 else np.inf
        return nu_min, nu_max

    def iterate(self, n_packets: int, iteration: int) -> TransportResult:
        """One plasma solve (if needed) and Monte Carlo transport run."""
        if self.plasma_state is None:
            self._solve_plasma()
        result = self.transport.run_iteration(
            self.state, self.plasma_state, self.atom_data,
            n_packets=n_packets, seed=self.seed, iteration=iteration,
            need_line_estimators=False,
            lum_nu_window=self._lum_nu_window(),
        )
        self.last_transport_result = result
        return result

    def advance_state(self, result: TransportResult, iteration: int) -> bool:
        """Invert estimators, check convergence, apply damped updates and
        re-solve the plasma."""
        with record_function("tardis.radiation_field"):
            est_t_rad, est_w, _ = solve_radiation_field(
                result, self.state, self.atom_data,
                w_epsilon=self.plasma_solver.w_epsilon,
            )
        nu_min, nu_max = self._lum_nu_window()
        emitted = result.emitted_luminosity(nu_min, nu_max)
        reabsorbed = result.reabsorbed_luminosity()
        est_t_inner = self.state.t_inner * (
            emitted / self.state.luminosity_requested
        ) ** self.t_inner_update_exponent

        solvers = self.convergence_solvers
        S = self.state.no_of_shells
        t_rad_conv = solvers["t_rad"].get_convergence_status(
            self.state.t_radiative, est_t_rad, S)
        w_conv = solvers["w"].get_convergence_status(
            self.state.dilution_factor, est_w, S)
        t_inner_conv = solvers["t_inner"].get_convergence_status(
            self.state.t_inner, est_t_inner, 1)
        converged = self.convergence_state.update(
            t_rad_conv and w_conv and t_inner_conv
        )
        self.state.t_radiative = solvers["t_rad"].converge(
            self.state.t_radiative, est_t_rad)
        self.state.dilution_factor = solvers["w"].converge(
            self.state.dilution_factor, est_w)
        if (iteration + 1) % self.lock_t_inner_cycles == 0:
            self.state.t_inner = float(
                solvers["t_inner"].converge(self.state.t_inner, est_t_inner)
            )
        self.history.append(IterationRecord(
            t_radiative=self.state.t_radiative.copy(),
            dilution_factor=self.state.dilution_factor.copy(),
            t_inner=self.state.t_inner,
            electron_densities=self.plasma_state.electron_densities.copy(),
            emitted_luminosity=emitted,
            reabsorbed_luminosity=reabsorbed,
        ))
        logger.info(
            "iteration %d: L_emitted=%.4e L_requested=%.4e t_inner=%.1f",
            iteration, emitted, self.state.luminosity_requested,
            self.state.t_inner,
        )
        self._solve_plasma()
        return converged

    def run_convergence(self):
        for iteration in range(self.iterations_executed, self.iterations - 1):
            result = self.iterate(self.no_of_packets, iteration)
            converged = self.advance_state(result, iteration)
            self.iterations_executed += 1
            for cb in self._callbacks:
                cb(self)
            if converged and self.stop_if_converged:
                break
        return self

    def run_final(self):
        """Final high-statistics iteration and its spectra: real packets,
        virtual packets (if any) and the formal integral (if asked for)."""
        iteration = self.iterations_executed
        # the plasma is solved once more at the final (t_rad, W), as the
        # JAX package's final host-mode solve does (its n_e fixpoint
        # restarts from the previous n_e, which refines n_e slightly)
        self._solve_plasma()
        result = self.transport.run_iteration(
            self.state, self.plasma_state, self.atom_data,
            n_packets=self.last_no_of_packets, seed=self.seed,
            iteration=iteration,
            n_vpackets=int(self.config.montecarlo.get(
                "no_of_virtual_packets", 0)),
            spectrum_nu_edges=self.spectrum_nu_edges,
            vpacket_spawn_nu_range=self._vpacket_spawn_nu_range(),
        )
        self.last_transport_result = result
        self.iterations_executed += 1
        with record_function("tardis.spectrum"):
            self.spectrum_real = real_packet_spectrum(
                result.output_nu, result.output_energy, result.emitted_mask,
                self.spectrum_nu_edges, result.time_of_simulation,
            )
            if result.virt_energy_hist is not None:
                self.spectrum_virtual = Spectrum(
                    nu_edges=result.virt_nu_edges,
                    luminosity_nu=(result.virt_energy_hist
                                   / result.time_of_simulation
                                   / np.diff(result.virt_nu_edges)),
                )
        if self.config.spectrum.get("method") == "integrated":
            self.integrate_spectrum()
        for cb in self._callbacks:
            cb(self)
        return self

    def _vpacket_spawn_nu_range(self):
        """``montecarlo.virtual_spectrum_spawn_range`` (wavelengths, cm) as
        (nu_min, nu_max) in Hz."""
        rng = self.config.montecarlo.get("virtual_spectrum_spawn_range", {})
        start = float(rng.get("start", 0.0))
        end = float(rng.get("end", float("inf")))
        nu_hi = C / start if start > 0 else float("inf")
        nu_lo = C / end if np.isfinite(end) and end > 0 else 0.0
        return (nu_lo, nu_hi)

    def integrate_spectrum(self) -> Spectrum:
        """The formal-integral spectrum from the last iteration's line
        estimators; the rays run on the simulation's device (K5)."""
        if self.last_transport_result is None:
            raise RuntimeError("run the simulation before integrating")
        integ = self.config.spectrum.get("integrated", {}) or {}
        solver = FormalIntegralSolver(
            n_points=int(integ.get("points", 1000)),
            interpolate_shells=int(integ.get("interpolate_shells", 0)),
        )
        self.spectrum_integrated = solver.solve(
            self.spectrum_nu_edges, self.state, self.plasma_state,
            self.last_transport_result, self.atom_data,
            line_interaction_type=self.transport.line_interaction_type,
            device=self.plasma_solver.device,
        )
        return self.spectrum_integrated

    def run(self):
        self.run_convergence()
        self.run_final()
        return self


def run_tardis(config_or_path, atom_data=None, device=None,
               callbacks=()) -> Simulation:
    """Top-level API: build, converge and run the final iteration.

    ``device`` defaults to the CUDA card and raises where there is none;
    pass ``device="cpu"`` for the plain PyTorch versions of the kernels.
    Each of ``callbacks`` is called with the simulation after every
    iteration.
    """
    from tardis_torch.config.reader import config_from_dict, config_from_yaml

    if isinstance(device, (list, tuple)):
        if len(device) > 1:
            raise NotImplementedError("more than one device is not ported")
        device = device[0] if device else None
    device = resolve_device(device)
    if isinstance(config_or_path, str):
        config = config_from_yaml(config_or_path)
    elif isinstance(config_or_path, ConfigDict):
        config = config_or_path
    else:
        config = config_from_dict(config_or_path)
    with torch.no_grad():
        sim = Simulation.from_config(config, atom_data=atom_data,
                                     device=device)
        for cb in callbacks:
            sim.add_callback(cb)
        return sim.run()
