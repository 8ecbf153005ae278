"""High-energy (gamma-ray) workflow.

Counterpart of ``tardis_tpu/workflows/high_energy.py`` (``TARDISHEWorkflow``,
``GammaRayResult``): decay gamma packets from the isotopes' chains are
sampled over a time grid (host numpy, the JAX package's Philox draws) and
transported through the homologously expanding ejecta one time step at a
time (K6), giving the per-(step, shell) energy deposition and the escaping
spectrum.  The packet state stays on the device across the time steps;
waiting packets are re-shelled there with an f64 search of the next
step's inner radii (the JAX package reads the state back every step).
The positron kinetic energy is deposited locally on the host, as in the
JAX package.  Runs on the card unless ``device="cpu"`` is passed.  The
decay pool is drawn inside the ``torch.profiler.record_function`` span
``tardis.gamma_pool``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from tardis_torch.atomic.atom_data import ATOMIC_MASSES
from tardis_torch.constants import C, DAY, M_U
from tardis_torch.cuda import resolve_device
from tardis_torch.energy_input.decay import (
    DECAY_RADIATION,
    decay_radiation_from_atom_data,
    isotope_numbers_from_fractions,
    sample_gamma_packets,
)
from tardis_torch.energy_input.gamma_kernel import (
    ESTIMATORS,
    STATUS_ACTIVE,
    STATUS_TIME,
    build_kn_table,
    gamma_step_transport,
)
from tardis_torch.transport import rng

F32 = torch.float32
F64 = torch.float64


@dataclass
class GammaRayResult:
    time_edges: np.ndarray  # (T+1,) s
    energy_bins_kev: np.ndarray  # (E+1,)
    deposition: np.ndarray  # (T, S) erg deposited per step per shell
    escape_spectrum: np.ndarray  # (E,) erg per bin (time-integrated)
    escape_spectra_t: np.ndarray  # (T, E)
    total_emitted: float  # erg (gamma sampled into packets + positron KE)
    total_escaped: float
    total_deposited: float
    # positron kinetic energy deposited locally per (T, S) [erg]; included
    # in total_deposited
    positron_deposition: np.ndarray = None
    total_positron_energy: float = 0.0
    # path-length estimators per (T, S) (None unless collect_estimators):
    # kasen_deposition [erg], compton_emissivity, pair_creation_emissivity
    estimators: dict | None = None


def step_shell_tables(time_edges, time_explosion, v_inner, v_outer,
                      electron_density, density, kasen_z4, device):
    """Every time step's shell tables at its mid-epoch t = sqrt(t0 t1):
    radii v t and the densities (electron, mass and the Kasen composition
    sum, each at ``time_explosion``) scaled by (t / time_explosion)^-3, in
    f64 on the host and rounded to f32 on ``device``; (T, S) each, one
    copy per table, so no time step copies from the host (a copy from host
    memory waits for the device's queue)."""
    t_mid = np.sqrt(time_edges[:-1] * time_edges[1:])
    scale = np.array([(t / time_explosion) ** -3 for t in t_mid])[:, None]
    t_mid = t_mid[:, None]
    rows = dict(r_inner=v_inner * t_mid, r_outer=v_outer * t_mid,
                electron_density=electron_density * scale,
                density=density * scale, kasen_z4=kasen_z4 * scale)
    return {name: torch.as_tensor(np.asarray(a, np.float64),
                                  device=device).to(F32)
            for name, a in rows.items()}


class TARDISHEWorkflow:
    def __init__(self, sim_state, isotope_mass_fractions=None,
                 seed: int = 23111963, ni56_mass_fraction=None,
                 atom_data=None, device=None):
        """isotope_mass_fractions: {'Ni56': (S,) or scalar, 'Cr48': ...},
        chains from model/decay._HALF_LIVES; ``ni56_mass_fraction`` is the
        same as {'Ni56': value}; ``atom_data`` (an AtomData or the path of
        a carsus file) brings its ``decay_radiation_data``, if it has
        one."""
        self.state = sim_state
        self.device = resolve_device(device)
        S = sim_state.no_of_shells
        if isotope_mass_fractions is None:
            if ni56_mass_fraction is None:
                raise ValueError("isotope_mass_fractions required")
            isotope_mass_fractions = {"Ni56": ni56_mass_fraction}
        elif not isinstance(isotope_mass_fractions, dict):
            isotope_mass_fractions = {"Ni56": isotope_mass_fractions}
        self.isotope_fractions = {
            iso: np.broadcast_to(np.asarray(f, np.float64), (S,))
            for iso, f in isotope_mass_fractions.items()
        }
        # initial nucleus counts per shell (homologous mass is constant)
        shell_mass = sim_state.composition.density * sim_state.geometry.volume
        self.isotope_numbers = isotope_numbers_from_fractions(
            self.isotope_fractions, shell_mass)
        self.radioactive_fraction = sum(self.isotope_fractions.values())
        self.seed = seed
        # carsus decay_radiation_data entries of the atomic data, where it
        # has them, override the built-in NNDC table
        self.radiation = dict(DECAY_RADIATION)
        if atom_data is not None:
            from tardis_torch.simulation.base import load_atom_data

            self.radiation.update(
                decay_radiation_from_atom_data(load_atom_data(atom_data)))

    def _composition_sums(self):
        """Per shell: the iron-group fraction (Z >= 21, plus the radioactive
        isotopes), sum X Z / A and sum X Z^4 / A (all electrons, and the
        Kasen photoabsorption's composition sum)."""
        comp = self.state.composition
        S = self.state.no_of_shells
        iron = np.zeros(S)
        z_over_a = np.zeros(S)
        z4_over_a = np.zeros(S)
        for i, z in enumerate(comp.atomic_numbers):
            if z >= 21:
                iron += comp.mass_fractions[i]
            a_i = (ATOMIC_MASSES[z - 1] if z <= len(ATOMIC_MASSES)
                   else 2.0 * z)
            z_over_a += comp.mass_fractions[i] * z / a_i
            z4_over_a += comp.mass_fractions[i] * z**4 / a_i
        iron = np.clip(iron + self.radioactive_fraction, 0.0, 1.0)
        return iron, z_over_a, z4_over_a

    @torch.no_grad()
    def run(
        self,
        n_packets: int = 100000,
        t_start: float = 2.0 * DAY,
        t_end: float = 50.0 * DAY,
        n_time_steps: int = 20,
        n_energy_bins: int = 100,
        positronium_fraction: float = 0.0,
        grey_opacity: float = -1.0,
        photoabsorption_opacity: str = "tardis",
        pair_creation_opacity: str = "tardis",
        collect_estimators: bool = False,
    ) -> GammaRayResult:
        """Transport the decay gamma rays (the options of the JAX package's
        ``run``: the ortho-positronium fraction, the grey opacity [cm^2/g]
        (>= 0 switches to grey absorption), the "tardis" | "kasen"
        photoabsorption and "tardis" | "artis" pair-creation prescriptions,
        and the per-(step, shell) path-length estimators)."""
        state = self.state
        dev = self.device
        S = state.no_of_shells
        with record_function("tardis.gamma_pool"):
            pool = sample_gamma_packets(
                n_packets, self.isotope_numbers, t_start, t_end,
                seed=self.seed, radiation=self.radiation,
                positronium_fraction=positronium_fraction,
            )
        time_edges = np.logspace(np.log10(t_start), np.log10(t_end),
                                 n_time_steps + 1)
        ebins = np.logspace(np.log10(10.0), np.log10(4000.0),
                            n_energy_bins + 1)
        kn_log_e, kn_table = build_kn_table(device=dev)
        iron, z_over_a, z4_over_a = self._composition_sums()

        # positron kinetic energy deposited locally, re-binned from the
        # sampler's time bins onto the step edges
        pos_dep = np.zeros((n_time_steps, S))
        src_edges = pool.time_bin_edges
        src_mid = np.sqrt(src_edges[:-1] * src_edges[1:])
        dest = np.clip(np.searchsorted(time_edges, src_mid, side="right") - 1,
                       0, n_time_steps - 1)
        for b in range(pool.positron_energy.shape[1]):
            pos_dep[dest[b]] += pool.positron_energy[:, b]

        def f64(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=dev)

        def f32(a):
            return f64(a).to(F32)

        v_inner = state.geometry.v_inner
        v_outer = state.geometry.v_outer
        # birth position: fractional radius within the shell in velocity
        v_pos = f64(v_inner[pool.shell] + pool.radius_frac * (
            v_outer[pool.shell] - v_inner[pool.shell]))
        birth_time = f64(pool.time)
        # kernel weights in packet units; scaled back by e0 after
        e0 = pool.total_energy / n_packets
        r = torch.zeros(n_packets, dtype=F32, device=dev)
        mu = f32(pool.mu)
        e_kev = f32(pool.energy_kev)
        w = f32(pool.packet_energy / e0)
        shell = torch.as_tensor(pool.shell, dtype=torch.int32, device=dev)
        status = torch.full((n_packets,), STATUS_TIME, dtype=torch.int32,
                            device=dev)  # waiting for the birth step
        born = torch.zeros(n_packets, dtype=torch.bool, device=dev)
        dep_t, esc_t, est_t = [], [], []

        key = rng.key(np.uint32(self.seed))
        base_density = state.composition.density
        tables = step_shell_tables(
            time_edges, state.time_explosion, v_inner, v_outer,
            base_density * z_over_a / M_U, base_density,
            base_density * z4_over_a / M_U, dev)
        rin_dev = f64(v_inner)
        ebins_t = f32(ebins)
        iron_t = f32(iron)
        for ts in range(n_time_steps):
            t0, t1 = time_edges[ts], time_edges[ts + 1]
            t_mid = np.sqrt(t0 * t1)
            # packets born in this step enter at their scaled position;
            # packets that reached the last step's end continue
            birth = ~born & (birth_time >= t0) & (birth_time < t1)
            r = torch.where(birth, (v_pos * t_mid).to(F32), r)
            born |= birth
            status = torch.where(born & (status == STATUS_TIME),
                                 STATUS_ACTIVE, status).int()
            budget = torch.where(
                status == STATUS_ACTIVE,
                (C * (t1 - torch.clamp(birth_time, min=t0))).to(F32), 0.0)
            out = gamma_step_transport(
                r, mu, e_kev, w, shell, status, budget, rng.fold_in(key, ts),
                tables["r_inner"][ts], tables["r_outer"][ts],
                tables["electron_density"][ts], tables["density"][ts], iron_t,
                kn_log_e, kn_table, ebins_t,
                kasen_z4=tables["kasen_z4"][ts],
                grey_opacity=float(grey_opacity),
                photoabsorption_type=photoabsorption_opacity,
                pair_creation_type=pair_creation_opacity,
                collect_estimators=collect_estimators,
            )
            r, mu, e_kev, w = out.r, out.mu, out.energy_kev, out.weight
            shell, status = out.shell, out.status
            dep_t.append(out.deposition)
            esc_t.append(out.escape_hist)
            est_t.append(out.estimators)
            # photons move at c, not homologously: keep r and find the
            # shell of the waiting packets at the next step's epoch
            if ts + 1 < n_time_steps:
                t_next = np.sqrt(time_edges[ts + 1] * time_edges[ts + 2])
                new_shell = torch.clamp(torch.searchsorted(
                    rin_dev * t_next, r.double(), right=True) - 1, 0, S - 1)
                shell = torch.where(status == STATUS_TIME, new_shell.int(),
                                    shell)

        deposition = torch.stack(dep_t).cpu().numpy() * e0
        escape_t = torch.stack(esc_t).cpu().numpy() * e0
        estimators = None
        if collect_estimators:
            est = torch.stack(est_t).cpu().numpy() * e0  # (T, 3, S)
            estimators = {k: est[:, i] for i, k in enumerate(ESTIMATORS)}
        return GammaRayResult(
            time_edges=time_edges,
            energy_bins_kev=ebins,
            deposition=deposition + pos_dep,
            escape_spectrum=escape_t.sum(axis=0),
            escape_spectra_t=escape_t,
            total_emitted=pool.total_energy + float(pos_dep.sum()),
            total_escaped=float(escape_t.sum()),
            total_deposited=float(deposition.sum() + pos_dep.sum()),
            positron_deposition=pos_dep,
            total_positron_energy=float(pos_dep.sum()),
            estimators=estimators,
        )
