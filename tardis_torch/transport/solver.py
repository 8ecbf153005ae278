"""Transport solver: one Monte Carlo iteration around kernels K2 and K1.

Counterpart of ``tardis_tpu/transport/solver.py`` (``TransportSolver``
.run_iteration / ._finalize, ``TransportResult``, ``solve_radiation_field``)
for the classic mode.  The per-iteration keys follow the JAX package
exactly: base = key(seed), source = fold_in(base, 2 it),
run = fold_in(base, 2 it + 1), so both packages draw the same bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from tardis_torch.constants import C, SIGMA_SB, T_RADIATIVE_ESTIMATOR_CONSTANT
from tardis_torch.opacities.macro_atom_solver import solve_macro_chain
from tardis_torch.plasma.lte import intensity_black_body
from tardis_torch.transport import rng
from tardis_torch.transport.kernel import (
    STATUS_EMITTED,
    STATUS_IN_PROCESS,
    STATUS_REABSORBED,
    transport_loop,
    warn_immortal,
)
from tardis_torch.transport.source import blackbody_source
from tardis_torch.transport.tables import NU_UNIT, build_transport_tables


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

    def _materialize(self):
        if not hasattr(self, "_out_nu"):
            out = self._out.cpu().numpy().astype(np.float64)
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
    ):
        if line_interaction_type not in ("scatter", "downbranch",
                                         "macroatom"):
            raise ValueError(
                f"line_interaction_type {line_interaction_type!r}"
            )
        self.line_interaction_type = line_interaction_type
        self.disable_electron_scattering = disable_electron_scattering
        self.disable_line_scattering = disable_line_scattering

    def run_iteration(
        self,
        sim_state,
        plasma_state,
        atom_data,
        n_packets: int,
        seed: int,
        iteration: int,
        need_line_estimators: bool = True,
        lum_nu_window: tuple = (0.0, np.inf),
    ) -> TransportResult:
        macro_chain = None
        lit = self.line_interaction_type
        if lit in ("downbranch", "macroatom"):
            macro = (atom_data.downbranch if lit == "downbranch"
                     else atom_data.macro_atom)
            with record_function("tardis.macro_chain"):
                macro_chain = solve_macro_chain(
                    macro, plasma_state.beta_sobolev, plasma_state.j_blues,
                    plasma_state.stimulated_emission_factor, mode=lit,
                    line_nu_scaled=atom_data.line_nu / NU_UNIT,
                )
        with record_function("tardis.transport_tables"):
            tables = build_transport_tables(
                sim_state.geometry,
                plasma_state.electron_densities,
                plasma_state.tau_prefix,
                atom_data,
                line_interaction_type=lit,
                macro_chain=macro_chain,
                disable_electron_scattering=self.disable_electron_scattering,
                disable_line_scattering=self.disable_line_scattering,
            )
        src_key, run_key = iteration_keys(seed, iteration)
        device = plasma_state.tau_prefix.device
        with record_function("tardis.packet_source"):
            pool_mu, pool_nu = blackbody_source(src_key, n_packets,
                                                sim_state.t_inner, device)
        lo, hi = lum_nu_window
        with record_function("tardis.transport_loop"):
            res = transport_loop(
                tables, pool_mu, pool_nu, run_key,
                nu_window=(lo / NU_UNIT, hi / NU_UNIT),
            )
        with record_function("tardis.finalize"):
            return self._finalize(res, sim_state, atom_data, n_packets,
                                  need_line_estimators, lum_nu_window)

    def _finalize(self, res, sim_state, atom_data, n_packets,
                  need_line_estimators, lum_nu_window) -> TransportResult:
        """Kernel units -> cgs: length c t_exp, frequency NU_UNIT, energy
        1/N erg (time of simulation = 1 erg / L_requested)."""
        ct = C * sim_state.time_explosion
        e0 = 1.0 / n_packets
        dt = 1.0 / sim_state.luminosity_requested
        S = sim_state.no_of_shells
        L = atom_data.n_lines
        summary = res.summary.cpu().numpy()
        est_j = res.est_j.cpu().numpy() * e0 * ct
        est_nubar = res.est_nubar.cpu().numpy() * e0 * ct * NU_UNIT
        j_blue = edot = None
        if need_line_estimators:
            # scan along the innermost dimension, (2S, L+1): PyTorch's scan
            # over the outer dimension of (L+1, 2S) is far slower on the card
            diff = res.line_diff.reshape(L + 1, 2 * S).T.contiguous()
            cum = torch.cumsum(diff, dim=1)[:, :L].T.contiguous()
            cum = cum.cpu().numpy().reshape(L, S, 2)
            nu_scaled = (atom_data.line_nu / NU_UNIT)[:, None]
            j_blue = cum[:, :, 0] * nu_scaled * (e0 / NU_UNIT)
            edot = cum[:, :, 1] * nu_scaled * e0
        n_immortal = warn_immortal(res)
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
        )


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
