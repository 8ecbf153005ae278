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

Each stage runs inside a span named ``tardis.<stage>`` (from_config,
plasma, macro_chain or macro_walk, transport_tables, packet_source,
transport_loop, vpacket_volley, readback, finalize, advance,
radiation_field, spectrum, source_function, formal_integral), opened by
``tracing.span`` (``tardis_torch/tracing.py``): a torch profiler span that
the program's trace recorder records too, beside its kernels' launches
and its host-device synchronizations (``tracing.sync``); ``iterate``
starts a new iteration of the recorder.  A span costs a few microseconds
when nothing records.  The benchmark's ``breakdown`` and per-layer files
(``portbench/``) and ``chip_smoke.py`` read them.

Everything runs on one device, the card unless the caller passes another,
except the classic event loop: as in the JAX package, its packets are
split over every visible card when there is more than one
(``TransportSolver(mesh="auto")``), or over the devices of a list passed
as ``device`` (``run_tardis(config, device=["cuda:0", "cuda:1"])``; the
simulation lives on the first, and a device may repeat), by
``parallel/transport.py``.  The transport options are wired as the JAX
package wires them: last-interaction tracking (on by default), the
r-packet tracker (``initial_array_length`` events a packet), full
relativity (which selects the relativistic packet pool), the reflective
inner boundary (its albedo applies only when it is enabled) and the
weighted pool.  ``atom_data`` given as a path (the config's
``atom_data`` or the argument) is read with ``atom_data_from_hdf``, as the
JAX package does.  The macro atom takes the absorbing-chain tables where
they fit the device budget and K1's random walk otherwise
(``TransportSolver.use_macro_chain``; set ``sim.transport.use_macro_chain``
before the run to choose).  The plasma options run as in the JAX
package: NLTE species (``plasma.nlte``, with ``coronal_approximation`` /
``classical_nebular``), both ``helium_treatment``s and ``detailed``
radiative rates, under which every iteration accumulates the line
estimators and ``advance_state`` feeds their j_blues back into the plasma
(K3's estimators instantiation).  vpacket biasing raises
``NotImplementedError`` naming the option (see ``check_supported``).
``montecarlo.enable_nonhomologous_expansion`` selects
the nonhomologous transport solver (K7), as the JAX package does.
With continuum species (``plasma.continuum_interaction.species``)
``run_tardis`` and the classic workflows run what the JAX package runs:
the classic transport, which ignores the continua, with the plasma solved
in host line mode (``_device_line_ok`` is false, so ``run_final`` does no
re-solve); the continuum transport is the Type IIP workflow's
(``workflows/type_iip.py``).  ``run_convergence(checkpoint_path=)``
writes the resume state after every iteration (``io/hdf.py``
``save_checkpoint``, h5py) and ``io.hdf.resume_simulation`` continues an
interrupted run; ``run_tardis`` configures the ``tardis_torch`` logger
(``io/logger.py``) and, with ``show_progress_bars``, shows a packet bar
that advances once per K1 launch.  The model comes from the
configuration: a ``specific`` structure, a ``csvy_model`` or a ``file``
structure (``io/csvy.py``, ``io/model_readers.py``), with isotope
abundances decayed to ``time_explosion``.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import numpy as np
import torch

from tardis_torch import tracing
from tardis_torch.atomic.hdf_loader import atom_data_from_hdf
from tardis_torch.atomic.synthetic import make_synthetic_atom_data
from tardis_torch.config.reader import ConfigDict
from tardis_torch.constants import C
from tardis_torch.cuda import resolve_device
from tardis_torch.model.state import SimulationState
from tardis_torch.opacities.macro_atom_solver import chain_tables_fit
from tardis_torch.parallel.transport import packet_devices
from tardis_torch.plasma.nlte import parse_species
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
    NonhomologousTransportSolver,
    TransportResult,
    TransportSolver,
    solve_radiation_field,
)
from tardis_torch.transport.tables import NU_UNIT

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


def load_atom_data(atom_data):
    """The atomic data a run takes: the synthetic set for None or
    "synthetic", a carsus HDF file's for a path (``atom_data_from_hdf``),
    or ``atom_data`` itself when it already is an AtomData."""
    if atom_data in (None, "synthetic"):
        return make_synthetic_atom_data()
    if isinstance(atom_data, (str, os.PathLike)):
        return atom_data_from_hdf(os.fspath(atom_data))
    return atom_data


def check_supported(config: ConfigDict) -> None:
    """Raise ``NotImplementedError`` for vpacket biasing, which the JAX
    package refuses too, and ``ValueError`` for an unknown
    ``spectrum.integrated.compute``; log, as the JAX package does, the
    options that change nothing here (``montecarlo.nthreads``,
    ``spectrum.virtual.tau_russian`` / ``survival_probability``)."""
    if int(config.montecarlo.get("nthreads", 1)) != 1:
        # the reference's numba prange thread count; packets run in
        # parallel on the device (or the devices of ``device=[...]``)
        logger.info(
            "montecarlo.nthreads is a no-op: packet parallelism runs on "
            "the device, or on the devices given as device=[...]")
    virtual = config.spectrum.get("virtual", {}) or {}
    if virtual.get("enable_biasing", False):
        raise NotImplementedError(
            "spectrum.virtual.enable_biasing: v-packet biasing is not "
            "implemented (the dense volley pass has no roulette to bias)")
    if (float(virtual.get("tau_russian", 10.0)) != 10.0
            or float(virtual.get("survival_probability", 0.0)) != 0.0):
        # K4 integrates e^-tau exactly over the whole ray; Russian
        # roulette is an approximation it does not need
        logger.info(
            "spectrum.virtual.tau_russian/survival_probability are "
            "no-ops: the v-packet pass computes the exact e^-tau "
            "attenuation the roulette would approximate")
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
    @tracing.span("tardis.from_config")
    def from_config(cls, config: ConfigDict, atom_data=None,
                    device=None) -> "Simulation":
        """``device`` may be a list of devices: the simulation lives on
        the first, and the classic event loop splits its packets over all
        of them."""
        mesh = "auto"
        if isinstance(device, (list, tuple)):
            mesh = packet_devices([resolve_device(d) for d in device])
            device = mesh[0]
        device = resolve_device(device)
        check_supported(config)
        state = SimulationState.from_config(config)
        lit = config.plasma.line_interaction_type
        atom_data = load_atom_data(
            config.atom_data if atom_data is None else atom_data)
        if atom_data.species_z is None:
            atom_data = atom_data.prepare(
                selected_atoms=list(state.composition.atomic_numbers),
                line_interaction_type=lit,
            )
        plasma = config.plasma
        nlte = plasma.get("nlte", {}) or {}
        # the reference schema defaults heating_rate_data_file to the
        # string "none"
        heating = plasma.get("heating_rate_data_file", None)
        plasma_solver = PlasmaSolver(
            atom_data,
            state,
            device,
            ionization=plasma.ionization,
            excitation=plasma.excitation,
            radiative_rates_type=plasma.radiative_rates_type,
            link_t_rad_t_electron=plasma.get("link_t_rad_t_electron", 0.9),
            w_epsilon=plasma.get("w_epsilon", 1e-10),
            helium_treatment=plasma.get("helium_treatment", "none"),
            heating_rate_data_file=(None if heating in ("none", "", None)
                                    else heating),
            nlte_species=[parse_species(sp) if isinstance(sp, str)
                          else tuple(sp) for sp in nlte.get("species", [])],
            nlte_coronal_approximation=bool(
                nlte.get("coronal_approximation", False)),
            nlte_classical_nebular=bool(
                nlte.get("classical_nebular", False)),
        )
        mc = config.montecarlo
        if int(mc.get("nthreads", 1)) != 1:
            logger.info(
                "montecarlo.nthreads is a no-op: packet parallelism runs "
                "on the devices (every visible card, or the list passed as "
                "device), each packet walked by a lane of the event "
                "loop's grid")
        tracking = mc.get("tracking", {}) or {}
        solver_cls = (NonhomologousTransportSolver
                      if mc.get("enable_nonhomologous_expansion", False)
                      else TransportSolver)
        transport_solver = solver_cls(
            line_interaction_type=lit,
            disable_electron_scattering=config.plasma.get(
                "disable_electron_scattering", False),
            disable_line_scattering=config.plasma.get(
                "disable_line_scattering", False),
            vpacket_tracking=bool(
                (config.spectrum.get("virtual", {}) or {})
                .get("virtual_packet_logging", False)),
            track_last_interaction=bool(
                tracking.get("track_last_interaction", True)),
            enable_full_relativity=bool(
                mc.get("enable_full_relativity", False)),
            track_rpacket_length=(
                int(tracking.get("initial_array_length", 10))
                if tracking.get("track_rpacket", False) else 0),
            inner_boundary_albedo=(
                float(mc.get("inner_boundary_albedo", 0.0))
                if mc.get("enable_reflective_inner_boundary", False)
                else 0.0),
            packet_source=mc.get("packet_source", "auto"),
            mesh=mesh,
        )
        return cls(config, state, atom_data, plasma_solver, transport_solver)

    def add_callback(self, fn):
        """fn(simulation) is called after each iteration."""
        self._callbacks.append(fn)

    @property
    def detailed(self) -> bool:
        return self.plasma_solver.radiative_rates_type == "detailed"

    def _device_line_ok(self) -> bool:
        """Whether the JAX package's convergence loop solves this run's
        plasma in device-line mode (tardis_tpu/simulation/base.py:252-285):
        the classic solver, no detailed rates, no NLTE species, no
        continuum species and, for downbranch and macroatom, the chain
        tables engaged (``use_macro_chain`` "auto" or True and the tables
        fit)."""
        t = self.transport
        ok = (type(t) is TransportSolver
              and not self.detailed
              and not self.plasma_solver.nlte_species
              and not (self.config.plasma.get("continuum_interaction", {})
                       or {}).get("species"))
        lit = t.line_interaction_type
        if ok and lit in ("downbranch", "macroatom"):
            macro = (self.atom_data.downbranch if lit == "downbranch"
                     else self.atom_data.macro_atom)
            ok = t.use_macro_chain in ("auto", True) and chain_tables_fit(
                macro, self.state.no_of_shells, mode=lit,
                line_nu_scaled=self.atom_data.line_nu / NU_UNIT)
        return ok

    def _solve_plasma(self, estimator_j_blues=None):
        with tracing.span("tardis.plasma"):
            self.plasma_state = self.plasma_solver.update(
                self.state.t_radiative, self.state.dilution_factor,
                j_blues=estimator_j_blues,
            )

    def _lum_nu_window(self):
        """(nu_min, nu_max) of the luminosity wavelength window [Hz]."""
        lam_lo, lam_hi = self.lum_wavelength_start, self.lum_wavelength_end
        nu_min = C / lam_hi if lam_hi > 0 and np.isfinite(lam_hi) else 0.0
        nu_max = C / lam_lo if lam_lo > 0 else np.inf
        return nu_min, nu_max

    def iterate(self, n_packets: int, iteration: int) -> TransportResult:
        """One plasma solve (if needed) and Monte Carlo transport run."""
        tracing.next_iteration()
        if self.plasma_state is None:
            self._solve_plasma()
        result = self.transport.run_iteration(
            self.state, self.plasma_state, self.atom_data,
            n_packets=n_packets, seed=self.seed, iteration=iteration,
            # the convergence iterations read the line estimators only
            # under detailed rates; the final iteration always takes them
            need_line_estimators=self.detailed,
            lum_nu_window=self._lum_nu_window(),
        )
        self.last_transport_result = result
        return result

    @tracing.span("tardis.advance")
    def advance_state(self, result: TransportResult, iteration: int) -> bool:
        """Invert estimators, check convergence, apply damped updates and
        re-solve the plasma."""
        with tracing.span("tardis.radiation_field"):
            est_t_rad, est_w, est_j_blues = solve_radiation_field(
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
        self._solve_plasma(est_j_blues if self.detailed else None)
        return converged

    def run_convergence(self, checkpoint_path: str | None = None):
        """The convergence loop, from ``iterations_executed`` on.

        ``checkpoint_path``: after each iteration, before the callbacks,
        write the resume state there (``io/hdf.py`` ``save_checkpoint``:
        t_rad, W, t_inner, the iteration, the damping constants and the
        n_e the last plasma solve started from), so an interrupted run
        continues with ``io.hdf.resume_simulation``.  The iteration keys
        are derived from (seed, iteration), so on the CPU the continued
        run is the uninterrupted one bit for bit."""
        if checkpoint_path is not None:
            from tardis_torch.io.hdf import save_checkpoint
        for iteration in range(self.iterations_executed, self.iterations - 1):
            result = self.iterate(self.no_of_packets, iteration)
            converged = self.advance_state(result, iteration)
            self.iterations_executed += 1
            if checkpoint_path is not None:
                save_checkpoint(self, checkpoint_path)
            for cb in self._callbacks:
                cb(self)
            if converged and self.stop_if_converged:
                break
        return self

    def run_final(self):
        """Final high-statistics iteration and its spectra: real packets,
        virtual packets (if any) and the formal integral (if asked for)."""
        iteration = self.iterations_executed
        # the JAX package re-solves the plasma at the final (t_rad, W) only
        # where there is none yet or its convergence loop solved it in
        # device-line mode (tardis_tpu/simulation/base.py:433-441); the
        # re-solve takes one more step of the n_e fixpoint, and under
        # detailed rates it would drop the estimator j_blues
        if self.plasma_state is None or self._device_line_ok():
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
        with tracing.span("tardis.spectrum"):
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
               callbacks=(), log_level=None, specific_log_level=False,
               show_progress_bars=False) -> Simulation:
    """Top-level API: build, converge and run the final iteration.

    ``device`` defaults to the CUDA card and raises where there is none;
    pass ``device="cpu"`` for the plain PyTorch versions of the kernels,
    or a list of devices to split the packets of the classic event loop
    over them (the simulation lives on the first; a device may repeat).
    Each of ``callbacks`` is called with the simulation after every
    iteration.  ``log_level`` / ``specific_log_level`` configure the
    ``tardis_torch`` logger (``io/logger.py`` ``logging_state``: the
    config's ``debug`` section and ``montecarlo.logger_buffer`` as the JAX
    package reads them); where neither the arguments nor the config ask
    for logging, the logger tree is left as the caller set it (the JAX
    package always configures it).  ``show_progress_bars`` shows a
    packet bar that advances once per K1 launch.
    """
    from tardis_torch.config.reader import config_from_dict, config_from_yaml

    if isinstance(config_or_path, str):
        config = config_from_yaml(config_or_path)
    elif isinstance(config_or_path, ConfigDict):
        config = config_or_path
    else:
        config = config_from_dict(config_or_path)
    from tardis_torch.io.logger import logging_asked, logging_state

    if logging_asked(log_level, config, specific_log_level):
        logging_state(log_level, config, specific_log_level)
    with torch.no_grad():
        sim = Simulation.from_config(config, atom_data=atom_data,
                                     device=device)
        sim.transport.show_packet_progress = bool(show_progress_bars)
        for cb in callbacks:
            sim.add_callback(cb)
        return sim.run()
