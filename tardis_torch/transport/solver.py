"""Transport solver: one Monte Carlo iteration around kernels K2, K1, K4.

Counterpart of ``tardis_tpu/transport/solver.py`` (``TransportSolver``
.run_iteration / ._finalize, ``TransportResult``, ``solve_radiation_field``)
for the classic mode.  The per-iteration keys follow the JAX package
exactly: base = key(seed), source = fold_in(base, 2 it),
run = fold_in(base, 2 it + 1), so both packages draw the same bits.

With ``n_vpackets`` > 0 K1 keeps ``VPACKET_RECORDS_PER_PACKET`` spawn
records per packet (the JAX package's default) and the vpacket volley (K4)
turns them into the virtual spectrum; records past that capacity are
dropped with a warning.

The transport options of the JAX package's solver are taken as it takes
them: ``packet_source`` "auto" is the relativistic pool under full
relativity and the simple pool otherwise; ``track_last_interaction`` and
``track_rpacket_length`` fill ``TransportResult.last_interaction`` and
``.rpacket_tracker`` (kept on the device until first read);
``inner_boundary_albedo`` > 0 reflects packets at the inner boundary.

``use_macro_chain`` chooses the macro atom's sampler in downbranch and
macroatom modes, as in the JAX package (``tardis_tpu/transport/
solver.py:201,213-216,265``): "auto" builds the absorbing-chain tables
where they fit the device budget (``solve_macro_chain``, which returns
None where they do not) and walks the macro atom in K1 otherwise
(``solve_macro_state``, span ``tardis.macro_walk``); False always walks;
True takes the chain tables and raises where they do not fit.

``mesh`` spreads the packets of an iteration over several devices, as the
JAX package's solver does (``tardis_tpu/transport/solver.py:203-209,
376-400``): "auto" takes every visible CUDA card when more than one is
visible and the pool lies on a card, ``None`` one device, and a list of
devices is taken as given (its first entry must be the simulation's
device: the outputs are gathered there).  The pool is drawn on the
simulation's device and split by ``parallel/transport.py``; an iteration
whose packet count is not a multiple of the device count runs on one
device, as in the JAX package, and the solver logs it once.  The virtual
packets (K4) and every later step run on the gathered outputs.
``show_packet_progress`` (``run_tardis(show_progress_bars=True)``) shows
a tqdm bar over an iteration's packets; it advances once per K1 launch,
per shard under packet parallelism, as the launch is queued: K1 is one
persistent launch, and neither a split nor a host sync is added for the
bar (the JAX package's bar advances by chunks).

With a ``continuum_state`` and ``continuum_macro`` (the Type IIP workflow)
K1 runs its continuum instantiation: full relativity is forced, and with
it the relativistic pool under ``packet_source: auto``, as the JAX package
forces them (``tardis_tpu/transport/solver.py:254-258,297-299,329-331``);
``TransportResult.continuum`` holds the per-continuum estimators rebuilt
from K1's grid moments (``reconstruct_continuum_estimators``).  With
``n_vpackets`` > 0 as well, K1's continuum ``records`` instantiation writes
the spawn records (``li_type`` 3 for a continuum process) and K4 traces
them under full relativity, as the JAX package's ``_trace_tau`` does: the
line and Thomson optical depths only, no bound-free or free-free opacity
along a virtual packet's path.  A random-walking continuum packet makes
thousands of attempts, so records past the capacity are the rule there.

Each stage of an iteration runs inside a ``tracing.span``
(``tardis_torch/tracing.py``): ``tardis.continuum_tables``,
``tardis.macro_chain`` or ``tardis.macro_walk``, ``tardis.transport_tables``,
``tardis.packet_source``, ``tardis.transport_loop``,
``tardis.vpacket_volley``, ``tardis.readback`` (``read_back``: the
blocking copies of K1's summary and estimators, each a ``tracing.sync``,
in which the host waits for the card) and ``tardis.finalize`` (the host
arithmetic on them).  The benchmark's ``breakdown`` and per-layer files
(``portbench/``) and ``chip_smoke.py`` read them.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from tardis_torch import tracing
from tardis_torch.constants import (
    C,
    H,
    SIGMA_SB,
    T_RADIATIVE_ESTIMATOR_CONSTANT,
)
from tardis_torch.model.geometry import NonhomologousRadial1DGeometry
from tardis_torch.opacities.macro_atom_solver import (
    solve_macro_chain,
    solve_macro_state,
)
from tardis_torch.parallel.transport import (
    packet_devices,
    run_transport_sharded,
)
from tardis_torch.plasma.continuum import ContinuumEstimators
from tardis_torch.plasma.lte import intensity_black_body
from tardis_torch.transport import rng
from tardis_torch.transport.kernel import (
    STATUS_EMITTED,
    STATUS_IN_PROCESS,
    STATUS_REABSORBED,
    transport_loop,
    warn_immortal,
)
from tardis_torch.transport.nonhomologous import (
    build_nonhom_tables,
    nonhom_transport_loop,
    nonhomologous_plasma_state,
)
from tardis_torch.transport.source import POOLS, blackbody_source
from tardis_torch.transport.tables import (
    NU_UNIT,
    build_continuum_grid,
    build_continuum_tables,
    build_transport_tables,
)
from tardis_torch.transport.vpacket import trace_vpacket_records

logger = logging.getLogger(__name__)

VPACKET_RECORDS_PER_PACKET = 8


@dataclass
class TransportResult:
    """Physical-unit transport outputs of one iteration.

    The per-packet arrays stay on the device until ``output_nu`` /
    ``output_energy`` / ``output_status`` is first read; the convergence
    loop needs only the two luminosity sums the kernel already made.
    """

    _out: torch.Tensor  # (N, 2) f32: signed nu (NU_UNIT), energy (packets)
    j_estimator: np.ndarray  # (S,) erg cm
    nu_bar_estimator: np.ndarray  # (S,) erg cm Hz
    j_blue_estimator: np.ndarray | None  # (L, S)
    edot_lu_estimator: np.ndarray | None  # (L, S)
    time_of_simulation: float  # s
    n_packets: int
    n_events: float
    n_immortal: int
    # (nu_min, nu_max, emitted in window, reabsorbed) luminosities [erg/s]
    _lum_cache: tuple
    virt_nu_edges: np.ndarray | None = None  # (M+1,) Hz
    virt_energy_hist: np.ndarray | None = None  # (M,) erg per bin
    vp_records: int = 0  # spawn records attempted
    vpackets: dict | None = None  # virt_packet_* arrays (packet logging)
    # (N, 6) and (N, K, 6) f32 kernel-unit rows, read by the properties
    _li: torch.Tensor | None = None
    _tracker: torch.Tensor | None = None
    length_unit: float = 1.0  # c t_exp, cm
    # continuum transport: the normalized, undamped per-continuum
    # estimators (plasma.continuum.ContinuumEstimators; None otherwise)
    continuum: object | None = None
    # continuum transport: each packet's event count (N,) i32 on the device
    events: torch.Tensor | None = None

    @cached_property
    def last_interaction(self) -> dict | None:
        """Per packet, its last interaction: the JAX package's keys, units
        and dtypes (type 0 for a packet that never interacted); read from
        the device once."""
        if self._li is None:
            return None
        li = self._li.cpu().numpy().astype(np.float64)
        return {
            "type": li[:, 0].astype(np.int8),
            "in_line": li[:, 1].astype(np.int32),
            "out_line": li[:, 2].astype(np.int32),
            "shell": li[:, 3].astype(np.int32),
            "in_nu": li[:, 4] * NU_UNIT,
            "r": li[:, 5] * self.length_unit,
        }

    @cached_property
    def rpacket_tracker(self) -> dict | None:
        """Per packet, its first K events (N, K): the JAX package's keys,
        units and dtypes (energy in packet birth units, type 0 past the
        packet's last event); read from the device once."""
        if self._tracker is None:
            return None
        tr = self._tracker.cpu().numpy().astype(np.float64)
        return {
            "r": tr[:, :, 0] * self.length_unit,
            "nu": tr[:, :, 1] * NU_UNIT,
            "energy": tr[:, :, 2],
            "shell": tr[:, :, 3].astype(np.int32),
            "type": tr[:, :, 4].astype(np.int8),
            "mu": tr[:, :, 5],
        }

    def _materialize(self):
        if not hasattr(self, "_out_nu"):
            with tracing.sync("result.output"):
                out = self._out.cpu().numpy()
            out = out.astype(np.float64)
            nu_signed = out[:, 0]
            self._out_nu = np.abs(nu_signed) * NU_UNIT
            self._out_energy = out[:, 1] * (1.0 / self.n_packets)
            self._out_status = np.where(
                nu_signed > 0, STATUS_EMITTED,
                np.where(nu_signed < 0, STATUS_REABSORBED,
                         STATUS_IN_PROCESS),
            ).astype(np.int8)

    @property
    def output_nu(self):
        self._materialize()
        return self._out_nu

    @property
    def output_energy(self):
        self._materialize()
        return self._out_energy

    @property
    def output_status(self):
        self._materialize()
        return self._out_status

    @property
    def emitted_mask(self):
        return self.output_status == STATUS_EMITTED

    def emitted_luminosity(self, nu_min=0.0, nu_max=np.inf) -> float:
        c = self._lum_cache
        if c[0] == nu_min and c[1] == nu_max:
            return c[2]
        m = self.emitted_mask & (self.output_nu > nu_min) & (
            self.output_nu < nu_max
        )
        return float(self.output_energy[m].sum() / self.time_of_simulation)

    def reabsorbed_luminosity(self) -> float:
        return self._lum_cache[3]


def iteration_keys(seed: int, iteration: int):
    """(source key, run key) of one iteration."""
    base = rng.key(np.uint32(seed))
    return (rng.fold_in(base, 2 * iteration),
            rng.fold_in(base, 2 * iteration + 1))


class TransportSolver:
    def __init__(
        self,
        line_interaction_type: str = "scatter",
        disable_electron_scattering: bool = False,
        disable_line_scattering: bool = False,
        vpacket_tracking: bool = False,
        track_last_interaction: bool = False,
        enable_full_relativity: bool = False,
        track_rpacket_length: int = 0,
        inner_boundary_albedo: float = 0.0,
        packet_source: str = "auto",
        mesh: object = "auto",
        use_macro_chain: bool | str = "auto",
        show_packet_progress: bool = False,
    ):
        if line_interaction_type not in ("scatter", "downbranch",
                                         "macroatom"):
            raise ValueError(
                f"line_interaction_type {line_interaction_type!r}"
            )
        if packet_source not in ("auto", *POOLS):
            raise ValueError(f"packet_source {packet_source!r}")
        if use_macro_chain not in ("auto", True, False):
            raise ValueError(f"use_macro_chain {use_macro_chain!r}")
        self.line_interaction_type = line_interaction_type
        self.disable_electron_scattering = disable_electron_scattering
        self.disable_line_scattering = disable_line_scattering
        self.vpacket_tracking = vpacket_tracking
        self.track_last_interaction = track_last_interaction
        self.enable_full_relativity = enable_full_relativity
        self.track_rpacket_length = int(track_rpacket_length)
        self.inner_boundary_albedo = float(inner_boundary_albedo)
        self.packet_source = packet_source
        self.mesh = mesh
        # "auto": the absorbing-chain tables where they fit the device
        # budget (solve_macro_chain), K1's RNG walk otherwise; True: the
        # chain tables (raises where they do not fit); False: the walk
        self.use_macro_chain = use_macro_chain
        # the in-run packet bar: it advances once per K1 launch (per shard
        # under packet parallelism), as the launch is queued
        self.show_packet_progress = show_packet_progress
        self._logged_one_device = False

    def devices_for(self, device: torch.device) -> list[torch.device]:
        """The devices an iteration's packets run on, the pool's device
        ``device`` first under "auto"."""
        if self.mesh is None:
            return [device]
        if self.mesh == "auto":
            if device.type != "cuda" or torch.cuda.device_count() < 2:
                return [device]
            return [device] + [d for d in packet_devices() if d != device]
        devices = packet_devices(self.mesh)
        if devices[0] != device:
            raise ValueError(f"mesh {devices}: the first device must be "
                             f"the pool's, {device}")
        return devices

    def full_relativity(self, continuum: bool = False) -> bool:
        """Whether transport runs fully relativistic: as configured, and
        always with continuum."""
        return self.enable_full_relativity or continuum

    @property
    def pool(self) -> str:
        """The packet pool of classic transport."""
        return self.pool_for()

    def pool_for(self, continuum: bool = False) -> str:
        """The packet pool: "auto" is the relativistic one under full
        relativity, the simple one otherwise."""
        if self.packet_source != "auto":
            return self.packet_source
        return ("relativistic" if self.full_relativity(continuum)
                else "simple")

    def run_iteration(
        self,
        sim_state,
        plasma_state,
        atom_data,
        n_packets: int,
        seed: int,
        iteration: int,
        n_vpackets: int = 0,
        spectrum_nu_edges: np.ndarray | None = None,
        vpacket_spawn_nu_range: tuple = (0.0, np.inf),
        need_line_estimators: bool = True,
        lum_nu_window: tuple = (0.0, np.inf),
        continuum_state=None,
        continuum_macro=None,
    ) -> TransportResult:
        macro_chain = macro_walk = continuum = None
        lit = self.line_interaction_type
        device = plasma_state.tau_prefix.device
        with_continuum = continuum_state is not None
        if with_continuum:
            # the absorbing-Markov tables replace the macro-atom chain
            with tracing.span("tardis.continuum_tables"):
                continuum = build_continuum_tables(
                    sim_state.geometry, atom_data, continuum_state,
                    continuum_macro, device)
        elif lit in ("downbranch", "macroatom"):
            macro = (atom_data.downbranch if lit == "downbranch"
                     else atom_data.macro_atom)
            args = (macro, plasma_state.beta_sobolev, plasma_state.j_blues,
                    plasma_state.stimulated_emission_factor)
            if self.use_macro_chain in ("auto", True):
                with tracing.span("tardis.macro_chain"):
                    macro_chain = solve_macro_chain(
                        *args, mode=lit,
                        line_nu_scaled=atom_data.line_nu / NU_UNIT)
                if macro_chain is None and self.use_macro_chain is True:
                    raise ValueError(
                        "use_macro_chain=True: the macro-atom chain tables "
                        "do not fit the device budget (chain_tables_fit)")
            if macro_chain is None:
                with tracing.span("tardis.macro_walk"):
                    macro_walk = solve_macro_state(*args)
        with tracing.span("tardis.transport_tables"):
            tables = build_transport_tables(
                sim_state.geometry,
                plasma_state.electron_densities,
                plasma_state.tau_prefix,
                atom_data,
                line_interaction_type=lit,
                macro_chain=macro_chain,
                disable_electron_scattering=self.disable_electron_scattering,
                disable_line_scattering=self.disable_line_scattering,
                full_relativity=self.full_relativity(with_continuum),
                inner_boundary_albedo=self.inner_boundary_albedo,
                continuum=continuum,
                macro_walk=macro_walk,
            )
        src_key, run_key = iteration_keys(seed, iteration)
        with tracing.span("tardis.packet_source"):
            pool_mu, pool_nu, pool_w = blackbody_source(
                src_key, n_packets, sim_state.t_inner, device,
                self.pool_for(with_continuum),
                beta_inner=float(sim_state.geometry.r_inner[0] / (
                    C * sim_state.geometry.time_explosion)))
        lo, hi = lum_nu_window
        capacity = n_packets * VPACKET_RECORDS_PER_PACKET \
            if n_vpackets > 0 else 0
        # the line difference array only where _finalize reads it (the
        # continuum instantiations always accumulate it)
        kw = dict(nu_window=(lo / NU_UNIT, hi / NU_UNIT),
                  vpacket_capacity=capacity, pool_w=pool_w,
                  last_interaction=self.track_last_interaction,
                  tracker_length=self.track_rpacket_length,
                  line_estimators=need_line_estimators or with_continuum)
        devices = self.devices_for(device)
        sharded = len(devices) > 1 and n_packets % len(devices) == 0
        if len(devices) > 1 and not sharded and not self._logged_one_device:
            logger.info(
                "%d packets do not split over %d devices: the iteration "
                "runs on %s", n_packets, len(devices), device)
            self._logged_one_device = True
        pbar = self._packet_bar(n_packets)
        with tracing.span("tardis.transport_loop"):
            if sharded:
                res = run_transport_sharded(
                    tables, pool_mu, pool_nu, run_key, devices,
                    progress=None if pbar is None else pbar.update, **kw)
            else:
                res = transport_loop(tables, pool_mu, pool_nu, run_key, **kw)
                if pbar is not None:
                    pbar.update(n_packets)
        if pbar is not None:
            pbar.close()
        virtual = {}
        if n_vpackets > 0:
            with tracing.span("tardis.vpacket_volley"):
                virtual = self._volley(tables, res, n_vpackets,
                                       spectrum_nu_edges,
                                       vpacket_spawn_nu_range, n_packets,
                                       sim_state)
        with tracing.span("tardis.readback"):
            host = read_back(res, need_line_estimators, atom_data.n_lines,
                             sim_state.no_of_shells)
        with tracing.span("tardis.finalize"):
            return self._finalize(res, host, sim_state, atom_data, n_packets,
                                  lum_nu_window,
                                  self.full_relativity(with_continuum),
                                  **virtual)

    def _packet_bar(self, n_packets: int):
        """A tqdm bar over the iteration's packets where
        ``show_packet_progress`` asks for one (and tqdm imports), else
        None."""
        if not self.show_packet_progress:
            return None
        try:
            from tqdm.auto import tqdm
        except ImportError:  # pragma: no cover
            return None
        return tqdm(total=n_packets, desc="packets", unit="pkt",
                    unit_scale=True, leave=False)

    def _volley(self, tables, res, n_vpackets, nu_edges, spawn_nu_range,
                n_packets, sim_state) -> dict:
        """The virtual spectrum (and, with packet logging, every virtual
        packet) from K1's spawn records."""
        attempted = int(res.vp_count[0])
        capacity = res.vp_records.shape[0]
        if attempted > capacity:
            logger.warning(
                "%d vpacket spawn record(s) past the capacity of %d were "
                "dropped", attempted - capacity, capacity,
            )
        records = res.vp_records[:res.n_vp_records]
        nu_edges = np.asarray(nu_edges, dtype=np.float64)
        lo, hi = spawn_nu_range
        vol = trace_vpacket_records(
            tables, records, n_vpackets,
            torch.as_tensor((nu_edges / NU_UNIT).astype(np.float32),
                            device=records.device),
            spawn_nu_range=(lo / NU_UNIT, hi / NU_UNIT),
            return_packets=self.vpacket_tracking,
        )
        e0 = 1.0 / n_packets
        vpackets = None
        if self.vpacket_tracking:
            ve = vol.energy.cpu().numpy()
            keep = np.nonzero(ve > 0)[0]
            rec = keep // n_vpackets
            vp = records.cpu().numpy().astype(np.float64)
            # the reference's virt_packet_* names
            vpackets = {
                "virt_packet_nus":
                    vol.nu.cpu().numpy()[keep].astype(np.float64) * NU_UNIT,
                "virt_packet_energies": ve[keep].astype(np.float64) * e0,
                "virt_packet_initial_rs":
                    vp[rec, 0] * (C * sim_state.time_explosion),
                "virt_packet_initial_mus": vp[rec, 1],
                "virt_packet_last_interaction_in_nu": vp[rec, 2] * NU_UNIT,
                "virt_packet_last_interaction_type":
                    vp[rec, 6].astype(np.int8),
                "virt_packet_last_line_interaction_out_id":
                    vp[rec, 7].astype(np.int32),
            }
        return dict(virt_nu_edges=nu_edges,
                    virt_energy_hist=vol.hist.cpu().numpy() * e0,
                    vp_records=attempted, vpackets=vpackets)

    def _finalize(self, res, host, sim_state, atom_data, n_packets,
                  lum_nu_window, full_relativity,
                  **virtual) -> TransportResult:
        """Kernel units -> cgs: length c t_exp, frequency NU_UNIT, energy
        1/N erg (time of simulation = 1 erg / L_requested), from K1's
        outputs read back to the host (``read_back``)."""
        ct = C * sim_state.time_explosion
        e0 = 1.0 / n_packets
        dt = 1.0 / sim_state.luminosity_requested
        summary = host["summary"]
        est_j = host["est_j"] * e0 * ct
        est_nubar = host["est_nubar"] * e0 * ct * NU_UNIT
        j_blue = edot = None
        cum = host["line_estimators"]
        if cum is not None:
            # under full relativity the increments carry no nu_i factor
            nu_scaled = (1.0 if full_relativity else
                         (atom_data.line_nu / NU_UNIT)[:, None])
            j_blue = cum[:, :, 0] * nu_scaled * (e0 / NU_UNIT)
            edot = cum[:, :, 1] * nu_scaled * e0
        n_immortal = warn_immortal(summary)
        continuum = None
        if res.cont_moments.numel():
            continuum = reconstruct_continuum_estimators(
                res, atom_data, sim_state, n_packets, dt)
        return TransportResult(
            _out=res.out,
            j_estimator=est_j,
            nu_bar_estimator=est_nubar,
            j_blue_estimator=j_blue,
            edot_lu_estimator=edot,
            time_of_simulation=dt,
            n_packets=n_packets,
            n_events=float(summary[2]),
            n_immortal=n_immortal,
            _lum_cache=(
                float(lum_nu_window[0]), float(lum_nu_window[1]),
                float(summary[0]) * e0 / dt, float(summary[1]) * e0 / dt,
            ),
            _li=res.last_interaction if self.track_last_interaction else None,
            _tracker=res.tracker if self.track_rpacket_length else None,
            length_unit=ct,
            continuum=continuum,
            events=res.events if continuum is not None else None,
            **virtual,
        )


class NonhomologousTransportSolver(TransportSolver):
    """Transport under an arbitrary piecewise-linear velocity law.

    Counterpart of ``tardis_tpu/transport/solver.py``
    ``NonhomologousTransportSolver``: the Sobolev depths are rescaled to
    the local velocity gradient, the macro modes build the RNG-walk tables
    (``solve_macro_state``, never the chain tables), the simple pool is
    drawn (K2) and the nonhomologous event loop (K7) runs.  A homologous
    geometry is lifted to the piecewise-linear representation (the
    ``enable_nonhomologous_expansion`` path).  Full relativity and
    continuum raise, as in the JAX package.  Virtual packets are not
    traced in this mode: ``n_vpackets`` is taken and no virtual spectrum
    results, as in the JAX package.
    """

    def run_iteration(
        self,
        sim_state,
        plasma_state,
        atom_data,
        n_packets: int,
        seed: int,
        iteration: int,
        n_vpackets: int = 0,
        spectrum_nu_edges: np.ndarray | None = None,
        vpacket_spawn_nu_range: tuple = (0.0, np.inf),
        need_line_estimators: bool = True,
        lum_nu_window: tuple = (0.0, np.inf),
        continuum_state=None,
        continuum_macro=None,
    ) -> TransportResult:
        if self.enable_full_relativity:
            raise NotImplementedError(
                "Full relativity not supported for non-homology.")
        if continuum_state is not None:
            raise NotImplementedError(
                "Continuum processes not supported for non-homology.")
        if n_vpackets > 0:
            logger.warning(
                "nonhomologous transport traces no virtual packets: "
                "no_of_virtual_packets=%d gives no virtual spectrum",
                n_vpackets)
        geometry = sim_state.geometry
        if not hasattr(geometry, "velocity_gradient"):
            geometry = NonhomologousRadial1DGeometry.from_homologous(geometry)
        lit = self.line_interaction_type
        device = plasma_state.tau_prefix.device
        with tracing.span("tardis.transport_tables"):
            plasma_nh = nonhomologous_plasma_state(plasma_state, geometry)
            walk = None
            if lit in ("downbranch", "macroatom"):
                macro = (atom_data.downbranch if lit == "downbranch"
                         else atom_data.macro_atom)
                walk = solve_macro_state(
                    macro, plasma_nh.beta_sobolev, plasma_nh.j_blues,
                    plasma_nh.stimulated_emission_factor)
            tables = build_nonhom_tables(
                geometry, plasma_nh, atom_data, lit, walk=walk,
                disable_electron_scattering=self.disable_electron_scattering,
                disable_line_scattering=self.disable_line_scattering,
                inner_boundary_albedo=self.inner_boundary_albedo,
            )
        src_key, run_key = iteration_keys(seed, iteration)
        with tracing.span("tardis.packet_source"):
            pool_mu, pool_nu, _ = blackbody_source(
                src_key, n_packets, sim_state.t_inner, device, "simple")
        lo, hi = lum_nu_window
        with tracing.span("tardis.transport_loop"):
            res = nonhom_transport_loop(
                tables, pool_mu, pool_nu, run_key,
                nu_window=(lo / NU_UNIT, hi / NU_UNIT),
                last_interaction=self.track_last_interaction,
                tracker_length=self.track_rpacket_length,
                line_estimators=need_line_estimators,
            )
        with tracing.span("tardis.readback"):
            host = read_back(res, need_line_estimators, atom_data.n_lines,
                             sim_state.no_of_shells)
        with tracing.span("tardis.finalize"):
            return self._finalize(res, host, sim_state, atom_data, n_packets,
                                  lum_nu_window, False)


def reconstruct_continuum_estimators(res, atom_data, sim_state, n_packets,
                                     time_of_simulation):
    """Per-continuum estimators from K1's frequency-grid moments.

    Counterpart of ``tardis_tpu/transport/solver.py:730``.  Within each
    merged-grid cell every cross-section is linear in nu, sigma_c = alpha_c
    + beta_c nu, so the reference's per-event sums over the active continua
    (update_estimators_bound_free, radfield_estimator_calcs.py:57-125)
    factor exactly into contractions of (alpha, beta) with the moments
    M_k = sum w nu^k and Mb_k = sum w b nu^k.  Returns
    ``plasma.continuum.ContinuumEstimators`` normalized by 1 / (dt V h)
    (heatings times h), as the reference's IIP workflow normalizes them
    (workflows/type_iip_workflow.py:768-790); the radiation-field damping
    is left to the workflow.
    """
    pi = atom_data.photo_ion
    ct = C * sim_state.time_explosion
    e0 = 1.0 / n_packets
    S = sim_state.no_of_shells
    grid, xs = build_continuum_grid(pi)
    grid_s = grid / NU_UNIT
    with tracing.sync("finalize.cont_moments"):
        m = res.cont_moments.cpu().numpy().reshape(len(grid) - 1, S, 8)
    M0, M1, M2 = m[..., 0], m[..., 1], m[..., 2]
    Mb0, Mb1, Mb2 = m[..., 3], m[..., 4], m[..., 5]
    counts = m[..., 6]

    dg = grid_s[1:] - grid_s[:-1]
    beta = (xs[1:] - xs[:-1]) / np.maximum(dg, 1e-300)[:, None]
    alpha = xs[:-1] - beta * grid_s[:-1, None]

    def contract(ma, mb):
        # sum_g alpha[g, c] ma[g, s] + beta[g, c] mb[g, s]
        return (np.einsum("gc,gs->cs", alpha, ma)
                + np.einsum("gc,gs->cs", beta, mb))

    # sum w sigma / nu and sum w b sigma / nu
    photo_ion = contract(M1, M0) * (ct / NU_UNIT) * e0
    stim_recomb = contract(Mb1, Mb0) * (ct / NU_UNIT) * e0
    # sum w sigma (1 - nu_th / nu)
    nu_th = pi.nu_threshold / NU_UNIT
    bf_heating = (contract(M0, M2) - nu_th[:, None] * contract(M1, M0)
                  ) * ct * e0
    stim_recomb_cooling = (contract(Mb0, Mb2)
                           - nu_th[:, None] * contract(Mb1, Mb0)) * ct * e0
    active = (xs[:-1] > 0) & (xs[1:] > 0)
    stats = np.einsum("gc,gs->cs", active.astype(np.float64), counts)
    with tracing.sync("finalize.ff_heat"):
        ff_heating = res.est_ff_heat.cpu().numpy() * e0
    norm = 1.0 / (time_of_simulation * sim_state.volume * H)  # (S,)
    return ContinuumEstimators(
        photo_ion=photo_ion * norm[None, :],
        stim_recomb=stim_recomb * norm[None, :],
        bf_heating=bf_heating * norm[None, :] * H,
        stim_recomb_cooling=stim_recomb_cooling * norm[None, :] * H,
        photo_ion_statistics=stats,
        ff_heating=ff_heating * norm * H,
    )


def read_back(res, line_estimators: bool, L: int, S: int) -> dict:
    """K1's (or K7's) summary, j and nu-bar estimators and, where asked,
    line estimators (L, S, 2) on the host: the blocking copies in which
    the host waits for the card."""
    with tracing.sync("readback.summary"):
        summary = res.summary.cpu().numpy()
    with tracing.sync("readback.est_j"):
        est_j = res.est_j.cpu().numpy()
    with tracing.sync("readback.est_nubar"):
        est_nubar = res.est_nubar.cpu().numpy()
    cum = None
    if line_estimators:
        with tracing.span("tardis.line_estimators"):
            cum = read_line_estimators(res.line_diff, L, S)
    return dict(summary=summary, est_j=est_j, est_nubar=est_nubar,
                line_estimators=cum)


def read_line_estimators(line_diff: torch.Tensor, L: int, S: int):
    """The line estimators on the host, (L, S, 2) f64 [j_blue, edot], from
    K1's or K7's line difference array ((L+1) S 2,): its prefix along the
    lines, then one copy to the host."""
    # scan along the innermost dimension, (2S, L+1): PyTorch's scan over
    # the outer dimension of (L+1, 2S) is far slower on the card
    diff = line_diff.reshape(L + 1, 2 * S).T.contiguous()
    cum = torch.cumsum(diff, dim=1)[:, :L].T.contiguous()
    with tracing.sync("readback.line_estimators"):
        return cum.cpu().numpy().reshape(L, S, 2)


def solve_radiation_field(result: TransportResult, sim_state, atom_data,
                          w_epsilon: float = 1e-10):
    """Invert the MC estimators to (T_rad, W, j_blues)."""
    volume = sim_state.volume
    dt = result.time_of_simulation
    t_rad = (T_RADIATIVE_ESTIMATOR_CONSTANT * result.nu_bar_estimator
             / result.j_estimator)
    w = result.j_estimator / (4.0 * SIGMA_SB * t_rad**4 * dt * volume)
    if result.j_blue_estimator is None:
        return t_rad, w, None
    norm = C * sim_state.time_explosion / (4.0 * np.pi * dt * volume)
    j_blues = result.j_blue_estimator * norm[None, :]
    planck = w[None, :] * intensity_black_body(
        atom_data.line_nu[:, None], t_rad[None, :]
    )
    j_blues = np.where(j_blues == 0.0, w_epsilon * planck, j_blues)
    return t_rad, w, j_blues
