"""Homologous radial 1-D geometry.

Equivalent of the reference's ``HomologousRadial1DGeometry``
(tardis/model/geometry/radial1d.py:168) — plain numpy arrays
in cgs; radii derive from velocities via r = v * t_explosion.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Radial1DGeometry:
    v_inner: np.ndarray  # (S,) cm/s
    v_outer: np.ndarray  # (S,) cm/s
    time_explosion: float  # s

    @classmethod
    def from_velocity_grid(cls, velocity_edges: np.ndarray, time_explosion: float):
        return cls(
            v_inner=np.asarray(velocity_edges[:-1], dtype=np.float64),
            v_outer=np.asarray(velocity_edges[1:], dtype=np.float64),
            time_explosion=float(time_explosion),
        )

    @property
    def no_of_shells(self) -> int:
        return len(self.v_inner)

    @property
    def v_middle(self) -> np.ndarray:
        return 0.5 * (self.v_inner + self.v_outer)

    @property
    def r_inner(self) -> np.ndarray:
        return self.v_inner * self.time_explosion

    @property
    def r_outer(self) -> np.ndarray:
        return self.v_outer * self.time_explosion

    @property
    def r_middle(self) -> np.ndarray:
        return 0.5 * (self.r_inner + self.r_outer)

    @property
    def volume(self) -> np.ndarray:
        """Shell volumes [cm^3]."""
        return (4.0 / 3.0) * np.pi * (self.r_outer**3 - self.r_inner**3)

    def geometric_dilution_factor(self) -> np.ndarray:
        """W = (1 - sqrt(1 - r_inner0^2 / r_middle^2)) / 2.

        (reference: io/model/parse_radiation_field_configuration.py:171-190)
        """
        value = 1.0 - (self.r_inner[0] ** 2) / (self.r_middle**2)
        return 0.5 * (1.0 - np.sqrt(np.clip(value, 0.0, None)))


@dataclass
class NonhomologousRadial1DGeometry:
    """Radial 1-D geometry with an arbitrary piecewise-linear velocity law.

    Counterpart of ``tardis_tpu/model/geometry.py``
    ``NonhomologousRadial1DGeometry`` (the reference's
    radial1d_nonhomologous.py:9): radii and velocities are independent
    inputs; within shell ``i`` the velocity is linear in radius,

        v(r) = v_inner[i] + velocity_gradient[i] * (r - r_inner[i]),

    so homologous expansion is the special case r = v * t_explosion.
    """

    _r_inner: np.ndarray  # (S,) cm
    _r_outer: np.ndarray  # (S,) cm
    v_inner: np.ndarray  # (S,) cm/s
    v_outer: np.ndarray  # (S,) cm/s
    time_explosion: float  # s

    @classmethod
    def from_homologous(cls, geometry: Radial1DGeometry):
        """Wrap a homologous geometry (r = v t; the reference workflow's
        default construction)."""
        return cls(
            _r_inner=geometry.r_inner.copy(),
            _r_outer=geometry.r_outer.copy(),
            v_inner=geometry.v_inner.copy(),
            v_outer=geometry.v_outer.copy(),
            time_explosion=geometry.time_explosion,
        )

    @property
    def r_inner(self) -> np.ndarray:
        return self._r_inner

    @property
    def r_outer(self) -> np.ndarray:
        return self._r_outer

    @property
    def velocity_gradient(self) -> np.ndarray:
        """dv/dr per shell."""
        return (self.v_outer - self.v_inner) / (self._r_outer - self._r_inner)

    @property
    def no_of_shells(self) -> int:
        return len(self._r_inner)

    @property
    def v_middle(self) -> np.ndarray:
        return 0.5 * (self.v_inner + self.v_outer)

    @property
    def r_middle(self) -> np.ndarray:
        return 0.5 * (self._r_inner + self._r_outer)

    @property
    def volume(self) -> np.ndarray:
        return (4.0 / 3.0) * np.pi * (self._r_outer**3 - self._r_inner**3)

    def geometric_dilution_factor(self) -> np.ndarray:
        value = 1.0 - (self._r_inner[0] ** 2) / (self.r_middle**2)
        return 0.5 * (1.0 - np.sqrt(np.clip(value, 0.0, None)))
