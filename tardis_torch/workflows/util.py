"""Workflow utilities: integrated mean optical depths.

Counterpart of ``tardis_tpu/workflows/util.py`` (the reference's
``get_tau_integ``, tardis/workflows/util.py:7-97): bin the line list in
ascending frequency, build the expansion opacity
kappa_exp = (nu/dnu)/(ct) * sum(1-e^-tau), combine it with the Thomson
opacity into Planck- and Rosseland-mean opacities, and integrate them
from the surface inward to per-shell mean optical depths.

The (L, S) tau table is K3's f64 output and stays where it lies: the
binned sums, the weights and the reversed cumulative sums are f64 torch
ops on its device, and only the two (S,) profiles come back to the host.
The ascending-frequency order of a line list is kept once per line list
(``line_bins``), not once per call.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from tardis_torch.constants import C, H, K_B, SIGMA_THOMSON


class LineBins:
    """The ascending-frequency order of one line list, grouped in bins of
    ``bin_size`` lines after ``pad`` leading empty rows (the JAX package's
    zero padding), with each bin's lower edge and width."""

    def __init__(self, line_nu: np.ndarray, bin_size: int, device):
        order = np.argsort(line_nu)  # ascending
        freqs = line_nu[order]
        extra = bin_size - len(freqs) % bin_size
        freqs = np.hstack((np.arange(extra + 1) + 1.0, freqs))
        bins_low = freqs[:-bin_size:bin_size]
        delta_nu = freqs[bin_size::bin_size] - bins_low
        self.line_nu = line_nu
        self.bin_size = bin_size
        self.device = device
        self.n_bins = len(delta_nu)
        # of the extra + 1 padding rows the first is dropped
        self.pad = extra
        self.order = torch.as_tensor(order, device=device)
        self.bins_low = torch.as_tensor(bins_low, device=device)
        self.delta_nu = torch.as_tensor(
            np.where(delta_nu == 0, 1.0, delta_nu), device=device)


_line_bins: LineBins | None = None


def line_bins(line_nu: np.ndarray, bin_size: int, device) -> LineBins:
    """The bins of ``line_nu`` on ``device``, kept for the last line list
    asked for."""
    global _line_bins
    b = _line_bins
    if (b is None or b.line_nu is not line_nu or b.bin_size != bin_size
            or b.device != device):
        b = _line_bins = LineBins(line_nu, bin_size, device)
    return b


def get_tau_integ(plasma_state, atom_data, sim_state, bin_size: int = 10):
    """Integrated Rosseland / Planck mean optical depth per shell, as host
    (S,) arrays.  ``plasma_state.tau_sobolev`` may be a tensor on any
    device (the work runs there) or a numpy array (on the CPU)."""
    with record_function("tardis.tau_integ"):
        tau = torch.as_tensor(plasma_state.tau_sobolev, dtype=torch.float64)
        device = tau.device
        b = line_bins(atom_data.line_nu, bin_size, device)
        S = tau.shape[1]

        def shells(x):
            return torch.as_tensor(np.asarray(x, np.float64), device=device)

        opacity = -torch.expm1(-tau.index_select(0, b.order))
        opacity = torch.cat((opacity.new_zeros(b.pad, S), opacity))
        summed = opacity.view(b.n_bins, bin_size, S).sum(dim=1)

        ct = sim_state.time_explosion * C
        t_rad = shells(plasma_state.t_rad)[None, :]
        nu = b.bins_low[:, None]
        dnu = b.delta_nu[:, None]
        planck = (2.0 * H * nu**3 / C**2
                  / torch.expm1(torch.clamp(H * nu / (K_B * t_rad),
                                            max=500.0)))
        u_weight = planck**2 * (C / nu) ** 2 / (2.0 * K_B * t_rad**2)

        kappa_exp = (b.bins_low / b.delta_nu)[:, None] / ct * summed
        kappa_thom = shells(plasma_state.electron_densities) * SIGMA_THOMSON
        b_dnu = planck * dnu
        kappa_planck = kappa_thom + (b_dnu * kappa_exp).sum(dim=0) \
            / b_dnu.sum(dim=0)
        u_dnu = u_weight * dnu
        kappa_rosseland = u_dnu.sum(dim=0) \
            / (u_dnu / (kappa_thom + kappa_exp)).sum(dim=0)

        g = sim_state.geometry
        dr = shells(g.r_outer - g.r_inner)

        def integrate(kappa):
            # from the surface inward
            return torch.flip(torch.cumsum(torch.flip(kappa * dr, (0,)), 0),
                              (0,))

        profiles = torch.stack((integrate(kappa_rosseland),
                                integrate(kappa_planck))).cpu().numpy()
    return {"rosseland": profiles[0], "planck": profiles[1]}
