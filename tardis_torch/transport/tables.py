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

from dataclasses import dataclass

import numpy as np
import torch

from tardis_torch.constants import C, SIGMA_THOMSON

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

    @property
    def n_shells(self) -> int:
        return self.r_inner.shape[0]

    @property
    def n_lines(self) -> int:
        return self.line_nu.shape[0]


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
) -> TransportTables:
    """Tables on the device of ``prefix`` (the K3 tau prefix)."""
    device = prefix.device
    ct = C * geometry.time_explosion
    L = atom_data.n_lines
    sigma = 1e-200 if disable_electron_scattering else SIGMA_THOMSON
    mode = LINE_MODES[line_interaction_type]

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    kw = {}
    if mode == LINE_SCATTER:
        line2macro = torch.zeros(L, dtype=torch.int32, device=device)
        chain_cdf = torch.zeros((1, 1), dtype=torch.float32, device=device)
        emit_cdf = torch.zeros((1, 3), dtype=torch.float32, device=device)
    else:
        if macro_chain is None:
            raise ValueError(f"{line_interaction_type} needs macro_chain")
        mc = macro_chain
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
        **kw,
    )
