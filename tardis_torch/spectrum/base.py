"""Spectrum synthesis from transport outputs.

Counterpart of the reference's ``SpectrumSolver`` / ``TARDISSpectrum``
(tardis/spectrum/base.py:14-135, spectrum/spectrum.py:9):
real-packet and virtual-packet histogram spectra on a uniform frequency grid,
plus f_lambda conversions and luminosity integrals.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tardis_torch.constants import C


@dataclass
class Spectrum:
    """Luminosity density spectrum L_nu on a uniform nu grid."""

    nu_edges: np.ndarray  # (M+1,) Hz ascending
    luminosity_nu: np.ndarray  # (M,) erg s^-1 Hz^-1

    @property
    def nu(self) -> np.ndarray:
        return 0.5 * (self.nu_edges[:-1] + self.nu_edges[1:])

    @property
    def delta_nu(self) -> np.ndarray:
        return np.diff(self.nu_edges)

    @property
    def wavelength(self) -> np.ndarray:
        """Bin-center wavelengths [cm], descending in nu order."""
        return C / self.nu

    @property
    def luminosity(self) -> float:
        return float((self.luminosity_nu * self.delta_nu).sum())

    @property
    def luminosity_lambda(self) -> np.ndarray:
        """L_lambda [erg s^-1 cm^-1] on the same bins."""
        return self.luminosity_nu * self.nu**2 / C

    def to_flux(self, distance_cm: float) -> np.ndarray:
        """F_nu at a given distance."""
        return self.luminosity_nu / (4.0 * np.pi * distance_cm**2)

    # ---- TARDISSpectrum conveniences (reference spectrum/spectrum.py:9) --

    @property
    def wavelength_angstrom(self) -> np.ndarray:
        """Bin-centre wavelengths [A]."""
        return self.wavelength * 1e8

    @property
    def luminosity_density_lambda(self) -> np.ndarray:
        """L_lambda [erg s^-1 A^-1] (reference
        luminosity_density_lambda; f_nu_to_f_lambda convention)."""
        return self.luminosity_lambda * 1e-8

    @staticmethod
    def luminosity_to_flux(luminosity, distance_cm: float):
        """L -> F at a distance (reference TARDISSpectrum
        .luminosity_to_flux)."""
        return luminosity / (4.0 * np.pi * float(distance_cm) ** 2)

    def plot(self, ax=None, mode: str = "wavelength", **kwargs):
        """Plot the spectrum against wavelength [A] or frequency [Hz]
        (reference TARDISSpectrum.plot)."""
        if ax is None:
            from matplotlib.pyplot import gca

            ax = gca()
        if mode == "wavelength":
            ax.plot(
                self.wavelength_angstrom, self.luminosity_density_lambda,
                **kwargs,
            )
            ax.set_xlabel("Wavelength [$\\AA$]")
            ax.set_ylabel("$L_\\lambda$ [erg s$^{-1}$ $\\AA^{-1}$]")
        elif mode == "frequency":
            ax.plot(self.nu, self.luminosity_nu, **kwargs)
            ax.set_xlabel("Frequency [Hz]")
            ax.set_ylabel("$L_\\nu$ [erg s$^{-1}$ Hz$^{-1}$]")
        else:
            raise ValueError(
                "mode must be 'wavelength' or 'frequency'"
            )
        return ax

    def to_ascii(self, fname: str, mode: str = "luminosity_density"):
        """Two-column ascii export: wavelength [A] + L_lambda (or the
        per-bin luminosity with mode='luminosity')
        (reference TARDISSpectrum.to_ascii)."""
        if mode == "luminosity_density":
            y = self.luminosity_density_lambda
        elif mode == "luminosity":
            y = self.luminosity_nu * self.delta_nu
        else:
            raise NotImplementedError(
                "only 'luminosity_density' and 'luminosity' modes exist"
            )
        np.savetxt(fname, np.column_stack([self.wavelength_angstrom, y]))


def frequency_grid(lambda_start_cm: float, lambda_end_cm: float, num: int):
    """Uniform nu grid spanning the requested wavelength range.

    (reference SpectrumSolver.from_config builds spectrum_frequency from the
    lambda range, spectrum/base.py:190-210)
    """
    nu_start = C / lambda_end_cm
    nu_end = C / lambda_start_cm
    return np.linspace(nu_start, nu_end, num + 1)


def real_packet_spectrum(
    output_nu: np.ndarray,
    output_energy: np.ndarray,
    emitted_mask: np.ndarray,
    nu_edges: np.ndarray,
    time_of_simulation: float,
) -> Spectrum:
    """Histogram emitted packets into L_nu."""
    hist, _ = np.histogram(
        output_nu[emitted_mask],
        bins=nu_edges,
        weights=output_energy[emitted_mask],
    )
    l_nu = hist / time_of_simulation / np.diff(nu_edges)
    return Spectrum(nu_edges=nu_edges, luminosity_nu=l_nu)


def filtered_luminosity(
    output_nu: np.ndarray,
    output_energy: np.ndarray,
    mask: np.ndarray,
    time_of_simulation: float,
    lambda_start_cm: float = 0.0,
    lambda_end_cm: float = np.inf,
) -> float:
    """Luminosity of packets inside a wavelength window
    (reference spectrum/luminosity.py:5)."""
    nu_min = C / lambda_end_cm if lambda_end_cm > 0 else 0.0
    nu_max = C / lambda_start_cm if lambda_start_cm > 0 else np.inf
    m = mask & (output_nu > nu_min) & (output_nu < nu_max)
    return float(output_energy[m].sum() / time_of_simulation)
