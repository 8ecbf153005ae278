"""Opacity / optical-depth diagnostics for finished runs.

Counterpart of ``tardis_tpu/analysis/opacities.py`` (the reference's
``OpacityCalculator``, tardis/analysis/opacities.py:15-419): per-(frequency-bin,
shell) bound-bound expansion opacity (Blinnikov et al. 1998), Thomson
opacity, total opacity, Planck-mean opacity and the per-shell /
surface-integrated Planck optical depths.  Quantities are lazy-cached and
recomputed when the grid parameters change, as in the reference.

The expansion opacity is an ``index_add_`` of 1 - e^-tau into (nbins, S)
on the device of K3's tau table; the (nbins, S) table is the only copy
to the host, and the rest is host numpy on it, as in the JAX package.

Differences from the reference (deliberate, as in the JAX package):
- plain cgs floats instead of astropy quantities;
- the per-bin python loop over the line list is a ``searchsorted`` and a
  segment sum;
- the reference's ``_calc_planck_mean_opacity`` reads
  ``kappa_tot[:, 0]`` for every shell (analysis/opacities.py:384, shell
  0's opacity reused everywhere); here the mean uses each shell's own
  column.
"""

from __future__ import annotations

import numpy as np
import torch

from tardis_torch.constants import C, H, K_B, SIGMA_THOMSON

ANGSTROM_CM = 1e-8


class OpacityCalculator:
    """Extract opacity/optical-depth diagnostics from a simulation.

    Parameters
    ----------
    sim : tardis_torch.simulation.base.Simulation (after at least one
        plasma solve) — supplies geometry, t_radiative, tau_sobolev,
        electron densities, and the line list.  The port's plasma state
        always carries K3's tau table, so there is no re-solve for a
        state without one, which the JAX package makes for its device
        line mode.
    nbins, lam_min_angstrom, lam_max_angstrom, bin_scaling : frequency
        grid controls (reference defaults: 300 bins, 100-20000 A, log).
    """

    def __init__(self, sim, nbins=300, lam_min_angstrom=100.0,
                 lam_max_angstrom=2e4, bin_scaling="log"):
        if sim.plasma_state is None:
            raise ValueError("simulation has no plasma state yet")
        self.sim = sim
        self._nbins = int(nbins)
        self._lam_min = float(lam_min_angstrom)
        self._lam_max = float(lam_max_angstrom)
        self._bin_scaling = bin_scaling
        self._reset()

    def _reset(self):
        self._nu_bins = None
        self._kappa_exp = None
        self._kappa_thom = None
        self._kappa_tot = None
        self._planck_kappa = None
        self._planck_delta_tau = None
        self._planck_tau = None

    # ---- grid parameters (setters invalidate the caches) ----
    def _param(name):  # noqa: N805 - descriptor factory
        def get(self):
            return getattr(self, "_" + name)

        def set_(self, val):
            setattr(self, "_" + name, val)
            self._reset()

        return property(get, set_)

    nbins = _param("nbins")
    lam_min = _param("lam_min")
    lam_max = _param("lam_max")
    bin_scaling = _param("bin_scaling")
    del _param

    @property
    def nshells(self):
        return self.sim.state.no_of_shells

    @property
    def t_exp(self):
        return self.sim.state.time_explosion

    @property
    def nu_bins(self):
        """Descending-wavelength = ascending-frequency bin edges [Hz]."""
        if self._nu_bins is None:
            nu_min = C / (self._lam_max * ANGSTROM_CM)
            nu_max = C / (self._lam_min * ANGSTROM_CM)
            if self._bin_scaling == "log":
                self._nu_bins = np.logspace(
                    np.log10(nu_min), np.log10(nu_max), self._nbins + 1
                )
            elif self._bin_scaling == "linear":
                self._nu_bins = np.linspace(
                    nu_min, nu_max, self._nbins + 1
                )
            else:
                raise ValueError("bin_scaling must be 'log' or 'linear'")
        return self._nu_bins

    @property
    def kappa_exp(self):
        """Bound-bound expansion opacity (nbins, nshells) [1/cm]:
        chi = nu / Delta_nu / (c t_exp) * sum_j (1 - e^-tau_j) over the
        lines in each bin (Blinnikov et al. 1998; reference
        _calc_expansion_opacity)."""
        if self._kappa_exp is None:
            edges = self.nu_bins
            line_nu = self.sim.atom_data.line_nu  # descending
            tau = torch.as_tensor(self.sim.plasma_state.tau_sobolev,
                                  dtype=torch.float64)  # (L, S)
            idx = np.searchsorted(edges, line_nu, side="left") - 1
            # lines outside the grid land in a last row that is dropped
            idx = np.where((idx >= 0) & (idx < self._nbins), idx,
                           self._nbins)
            binned = tau.new_zeros(self._nbins + 1, tau.shape[1])
            binned.index_add_(0, torch.as_tensor(idx, device=tau.device),
                              1.0 - torch.exp(-tau))
            binned = binned[:-1].cpu().numpy()
            dnu = np.diff(edges)
            self._kappa_exp = (
                binned * (edges[:-1] / dnu)[:, None] / (C * self.t_exp)
            )
        return self._kappa_exp

    @property
    def kappa_thom(self):
        """Thomson scattering opacity per shell [1/cm]."""
        if self._kappa_thom is None:
            self._kappa_thom = (
                SIGMA_THOMSON * self.sim.plasma_state.electron_densities
            )
        return self._kappa_thom

    @property
    def kappa_thom_grid(self):
        return np.broadcast_to(
            self.kappa_thom[None, :], (self._nbins, self.nshells)
        )

    @property
    def kappa_tot(self):
        if self._kappa_tot is None:
            self._kappa_tot = self.kappa_exp + self.kappa_thom_grid
        return self._kappa_tot

    @property
    def planck_kappa(self):
        """Planck-mean total opacity per shell [1/cm]
        (Mihalas & Mihalas 1984)."""
        if self._planck_kappa is None:
            edges = self.nu_bins
            dnu = np.diff(edges)
            t_rad = self.sim.state.t_radiative  # (S,)
            x = H * edges[:-1][:, None] / (K_B * t_rad[None, :])
            b_nu = edges[:-1][:, None] ** 3 / np.expm1(
                np.clip(x, 1e-10, 500.0)
            )
            w = b_nu * dnu[:, None]
            self._planck_kappa = (
                (w * self.kappa_tot).sum(axis=0) / w.sum(axis=0)
            )
        return self._planck_kappa

    @property
    def planck_delta_tau(self):
        """Planck-mean optical depth of each shell."""
        if self._planck_delta_tau is None:
            g = self.sim.state.geometry
            self._planck_delta_tau = (
                (g.r_outer - g.r_inner) * self.planck_kappa
            )
        return self._planck_delta_tau

    @property
    def planck_tau(self):
        """Planck-mean optical depth integrated from the surface inward."""
        if self._planck_tau is None:
            self._planck_tau = np.cumsum(
                self.planck_delta_tau[::-1]
            )[::-1]
        return self._planck_tau
