"""Transport tables: what the packet event loop reads, on one device.

Counterpart of ``tardis_tpu/transport/device_state.py``
``build_transport_tables``.  The JAX package packs its per-shell tau prefix
into two-float (hi, lo) rows and 128-ary search tables because the TPU
has no f64 and serializes gathers; the H100 reads the flat f64 prefix
directly and binary-searches it per thread, so none of that packing exists
here.

Scaled units, as in the JAX package: lengths / (c t_exp), frequencies /
NU_UNIT, energies in packet birth units.  Homologous flow makes the
combined optical depth to line i,
    g(i) = [P(i+1) - P(next_line)] + chi_e * s(i),
    s(i) = max(1 - nu_i / nu_lab - mu r, 0),
monotone in i, so the event line is found by binary search.  Under full
relativity s(i) solves the resonance quadratic and chi_e carries the
Doppler factor; s stays monotone in i, so the search is the same.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from tardis_torch import tracing
from tardis_torch.constants import C, SIGMA_THOMSON
from tardis_torch.opacities.macro_atom_solver import MacroWalkTables
from tardis_torch.transport.macro_walk import max_jumps, walk_steps

NU_UNIT = 1.0e15  # Hz
GAMMA_FLOOR = 1e-12  # 1 - beta^2 is floored here before the square root

# line interaction modes
LINE_SCATTER = 0
LINE_DOWNBRANCH = 1
LINE_MACROATOM = 2
LINE_MODES = {"scatter": LINE_SCATTER, "downbranch": LINE_DOWNBRANCH,
              "macroatom": LINE_MACROATOM}


def lorentz_gamma(r):
    """Lorentz factor of the homologous flow at radius r (f32 tensor; beta
    = r in these units), as the JAX package takes it."""
    return 1.0 / torch.sqrt(torch.clamp(1.0 - r * r, min=GAMMA_FLOOR))


@dataclass
class TransportTables:
    r_inner: torch.Tensor  # (S,) f32, / (c t_exp)
    r_outer: torch.Tensor  # (S,) f32
    chi_e: torch.Tensor  # (S,) f32 electron-scattering opacity * c t_exp
    line_nu: torch.Tensor  # (L,) f32 descending, / NU_UNIT
    prefix: torch.Tensor  # (S, L+1) f64 inclusive tau prefix, leading 0
    line2macro: torch.Tensor  # (L,) i32 activation level (zeros: scatter)
    chain_cdf: torch.Tensor  # (S*M, W+1) f32 ((1, 1) dummy unless macroatom)
    emit_cdf: torch.Tensor  # (S*M, 3*We) f32 ((1, 3) dummy in scatter mode)
    mode: int  # LINE_SCATTER / LINE_DOWNBRANCH / LINE_MACROATOM
    n_states: int = 1  # M
    chain_width: int = 0  # W
    emit_width: int = 1  # We
    disable_line_scattering: bool = False
    # special-relativistic transport (Lorentz factors, aberration, the
    # quadratic resonance distance), as the JAX package's static config
    full_relativity: bool = False
    # probability that a packet hitting the inner boundary is reflected
    # (0: every such packet is reabsorbed)
    inner_boundary_albedo: float = 0.0
    # bound-free / free-free opacity and the absorbing-Markov macro atom
    # of the Type IIP workflow (None: classic transport)
    continuum: ContinuumTables | None = None
    # the RNG-walk macro atom's tables (``solve_macro_state``: per-block
    # f32 cumulative probabilities (T, S), block_start, dest, emit, line,
    # line2macro), where the line interaction walks instead of drawing
    # from the chain tables (None: the chain tables, or scatter)
    walk: MacroWalkTables | None = None
    max_jumps: int = 0  # jumps of one walk (1 in downbranch mode)
    walk_steps: int = 1  # bisection steps of the widest transition block

    @property
    def n_shells(self) -> int:
        return self.r_inner.shape[0]

    @property
    def n_lines(self) -> int:
        return self.line_nu.shape[0]

    def to(self, device) -> TransportTables:
        """The tables on ``device`` (continuum tables included); the
        tables themselves where they are there already."""
        return _tables_to(self, device)


@dataclass
class ContinuumTables:
    """What K1's continuum branch reads, in the JAX package's layouts
    (``tardis_tpu/transport/device_state.py:295-376``): flat arrays indexed
    ``gcell * C + c``, ``c * S + shell``, ``(shell * M + state) * M + j``,
    ``t * S + shell`` and ``point * S + shell``."""

    grid_nu: torch.Tensor  # (Ng,) f32 merged bound-free grid, / NU_UNIT
    xsect: torch.Tensor  # (Ng * C,) f32 cross-sections on the grid
    coef_a: torch.Tensor  # (C * S,) f32 level population * c t_exp
    coef_b: torch.Tensor  # (C * S,) f32 LTE population coefficient * c t_exp
    boltz_coef: torch.Tensor  # (S,) f32 h NU_UNIT / (k T_e)
    ff_coef: torch.Tensor  # (S,) f32 free-free opacity coefficient
    mk_cum_b: torch.Tensor  # (S * M * M,) f32 cumulative absorbing rows
    deact_block_start: torch.Tensor  # (M + 1,) i32
    deact_cum_prob: torch.Tensor  # (D * S,) f32 cumulative per block
    deact_kind: torch.Tensor  # (D,) i8 emission kind (EMIT_* codes)
    deact_id: torch.Tensor  # (D,) i32 line or continuum id of a channel
    line2state: torch.Tensor  # (L,) i32 state a line absorption activates
    photo_ion_state: torch.Tensor  # (C,) i32 i-packet state of a continuum
    fb_cdf: torch.Tensor  # (P * S,) f32 free-bound emission CDF per block
    fb_nu: torch.Tensor  # (P,) f32 tabulation frequencies, / NU_UNIT
    pion_block_start: torch.Tensor  # (C + 1,) i32
    two_photon_nu: torch.Tensor  # (TPN,) f32 inverse CDF ((1,) when off)
    k_state: int
    two_photon: bool = False  # a two-photon deactivation channel exists
    adiabatic: bool = False  # the adiabatic-cooling channel exists
    # bisection steps that settle a search of any deactivation block and
    # of any continuum's free-bound CDF block (the plain version's loops)
    deact_steps: int = 1
    fb_steps: int = 1

    @property
    def n_grid(self) -> int:
        return self.grid_nu.shape[0]

    @property
    def n_continua(self) -> int:
        return self.photo_ion_state.shape[0]

    @property
    def n_states(self) -> int:
        return self.deact_block_start.shape[0] - 1

    def to(self, device) -> ContinuumTables:
        """The tables on ``device``; the tables themselves where they are
        there already."""
        return _tables_to(self, device)


def _tables_to(tables, device):
    """A copy of a tables dataclass with every tensor (and the nested
    continuum and walk tables) moved to ``device`` by an asynchronous
    copy, ordered on the current streams of both devices; ``tables``
    itself when nothing moves."""
    device = torch.device(device)
    moved = {}
    for field in dataclasses.fields(tables):
        v = getattr(tables, field.name)
        if isinstance(v, ContinuumTables):
            v_on = v.to(device)
        elif isinstance(v, MacroWalkTables):
            v_on = MacroWalkTables(*(x.to(device, non_blocking=True)
                                     for x in v))
            if all(a is b for a, b in zip(v_on, v)):
                v_on = v
        elif isinstance(v, torch.Tensor):
            v_on = v.to(device, non_blocking=True)
        else:
            continue
        if v_on is not v:
            moved[field.name] = v_on
    return dataclasses.replace(tables, **moved) if moved else tables


def _bisection_steps(block_start) -> int:
    widest = int(np.max(np.diff(np.asarray(block_start))))
    return int(np.ceil(np.log2(widest + 1))) + 1


def build_continuum_grid(photo_ion, edge_eps: float = 1e-6):
    """Merged bound-free frequency grid and per-continuum cross-sections.

    Returns (grid_nu (Ng,) ascending Hz, xsect (Ng, C)).  Each continuum
    contributes its tabulation knots plus hard-edge sentinel knots just
    outside its support, so linear interpolation on the merged grid
    reproduces the per-block interpolation with hard thresholds of the
    reference (opacities/opacities.py:88-180) with one search per event
    instead of one per continuum.  Counterpart of
    ``tardis_tpu/transport/device_state.py:175`` ``build_continuum_grid``.
    """
    pi = photo_ion
    th, mx = pi.nu_threshold, pi.nu_max
    lo, hi = pi.nu.min(), pi.nu.max()
    grid = np.unique(np.concatenate([
        pi.nu, th * (1.0 - edge_eps), mx * (1.0 + edge_eps),
        np.array([lo * 0.5, lo * 0.75, hi * 1.5, hi * 2.0])]))
    xs = np.zeros((len(grid), pi.n_continua))
    for c in range(pi.n_continua):
        a, b = pi.block_references[c], pi.block_references[c + 1]
        nus = np.concatenate([[th[c] * (1.0 - edge_eps)], pi.nu[a:b],
                              [mx[c] * (1.0 + edge_eps)]])
        vals = np.concatenate([[0.0], pi.x_sect[a:b], [0.0]])
        xs[:, c] = np.interp(grid, nus, vals, left=0.0, right=0.0)
    return grid, xs


def build_continuum_tables(geometry, atom_data, continuum_state,
                           continuum_macro, device) -> ContinuumTables:
    """K1's continuum tables from the host continuum state and Markov
    macro-atom tables of one iteration, on ``device``."""
    from tardis_torch.constants import H, K_B
    from tardis_torch.opacities.continuum_macro import (
        EMIT_TWO_PHOTON,
        two_photon_inv_cdf,
    )
    from tardis_torch.plasma.continuum import FF_OPAC_CONST

    cs, cm = continuum_state, continuum_macro
    pi = atom_data.photo_ion
    ct = C * geometry.time_explosion
    grid, xs = build_continuum_grid(pi)

    def dev(a, dtype):
        with tracing.sync("continuum_tables"):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype),
                                   device=device)

    def f32(a):
        return dev(np.asarray(a).reshape(-1), np.float32)

    def i32(a):
        return dev(np.asarray(a).reshape(-1), np.int32)

    two_photon_nu = np.zeros(1)
    if cm.n_two_photon:
        if cm.n_two_photon > 1:
            raise NotImplementedError(
                "more than one two-photon decay transition (the reference "
                "supports one, plasma/properties/atomic.py:400-402)")
        tp = atom_data.two_photon
        t = int(cm.deact_id[cm.deact_kind == EMIT_TWO_PHOTON][0])
        two_photon_nu = two_photon_inv_cdf(
            float(tp.alpha[t]), float(tp.beta[t]), float(tp.gamma[t])
        ) * float(tp.nu0[t]) / NU_UNIT
    return ContinuumTables(
        grid_nu=f32(grid / NU_UNIT),
        xsect=f32(xs),
        coef_a=f32(cs.level_pop * ct),
        coef_b=f32(cs.lte_pop_coef * ct),
        boltz_coef=f32(H * NU_UNIT / (K_B * cs.t_electrons)),
        ff_coef=f32(FF_OPAC_CONST * cs.ff_opacity_factor * ct / NU_UNIT**3),
        mk_cum_b=f32(cm.cum_B),
        deact_block_start=i32(cm.deact_block_start),
        deact_cum_prob=f32(cm.deact_cum_prob),
        deact_kind=dev(cm.deact_kind, np.int8),
        deact_id=i32(cm.deact_id),
        line2state=i32(cm.line2state),
        photo_ion_state=i32(cm.photo_ion_state),
        fb_cdf=f32(cs.fb_emission_cdf),
        fb_nu=f32(pi.nu / NU_UNIT),
        pion_block_start=i32(pi.block_references),
        two_photon_nu=f32(two_photon_nu),
        k_state=int(cm.k_state),
        two_photon=cm.n_two_photon > 0,
        adiabatic=bool(cm.has_adiabatic),
        deact_steps=_bisection_steps(cm.deact_block_start),
        fb_steps=_bisection_steps(pi.block_references),
    )


def build_transport_tables(
    geometry,
    electron_densities: np.ndarray,
    prefix: torch.Tensor,
    atom_data,
    line_interaction_type: str = "scatter",
    macro_chain=None,
    disable_electron_scattering: bool = False,
    disable_line_scattering: bool = False,
    full_relativity: bool = False,
    inner_boundary_albedo: float = 0.0,
    continuum: ContinuumTables | None = None,
    macro_walk: MacroWalkTables | None = None,
) -> TransportTables:
    """Tables on the device of ``prefix`` (the K3 tau prefix).  The macro
    modes take ``macro_chain`` (``solve_macro_chain``) or, where its tables
    do not fit, ``macro_walk`` (``solve_macro_state``: the line interaction
    walks the macro atom).  With ``continuum`` (``build_continuum_tables``)
    the line interaction goes through the absorbing-Markov macro atom and
    neither is needed."""
    device = prefix.device
    ct = C * geometry.time_explosion
    L = atom_data.n_lines
    sigma = 1e-200 if disable_electron_scattering else SIGMA_THOMSON
    mode = LINE_MODES[line_interaction_type]

    def f32(a):
        with tracing.sync("tables.f32"):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

    kw = {}
    if mode == LINE_SCATTER or continuum is not None:
        line2macro = torch.zeros(L, dtype=torch.int32, device=device)
        chain_cdf = torch.zeros((1, 1), dtype=torch.float32, device=device)
        emit_cdf = torch.zeros((1, 3), dtype=torch.float32, device=device)
    elif macro_walk is not None:
        line2macro = macro_walk.line2macro
        chain_cdf = torch.zeros((1, 1), dtype=torch.float32, device=device)
        emit_cdf = torch.zeros((1, 3), dtype=torch.float32, device=device)
        kw = dict(walk=macro_walk,
                  max_jumps=max_jumps(mode == LINE_DOWNBRANCH),
                  walk_steps=walk_steps(macro_walk.block_start.cpu()))
    else:
        if macro_chain is None:
            raise ValueError(f"{line_interaction_type} needs macro_chain "
                             "or macro_walk")
        mc = macro_chain
        with tracing.sync("tables.line2macro"):
            line2macro = torch.as_tensor(mc.line2macro, dtype=torch.int32,
                                         device=device)
        emit_cdf = mc.emit_cdf
        chain_cdf = (mc.chain_cdf if mc.chain_cdf is not None else
                     torch.zeros((1, 1), dtype=torch.float32, device=device))
        kw = dict(n_states=mc.n_states, chain_width=mc.chain_width,
                  emit_width=mc.emit_width)
    return TransportTables(
        r_inner=f32(geometry.r_inner / ct),
        r_outer=f32(geometry.r_outer / ct),
        chi_e=f32(sigma * np.asarray(electron_densities) * ct),
        line_nu=f32(atom_data.line_nu / NU_UNIT),
        prefix=prefix.to(torch.float64).contiguous(),
        line2macro=line2macro,
        chain_cdf=chain_cdf.contiguous(),
        emit_cdf=emit_cdf.contiguous(),
        mode=mode,
        disable_line_scattering=disable_line_scattering,
        full_relativity=full_relativity,
        inner_boundary_albedo=float(inner_boundary_albedo),
        continuum=continuum,
        **kw,
    )
