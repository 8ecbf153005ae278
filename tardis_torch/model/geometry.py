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

