"""Ejecta density profiles.

Re-implements the analytic profiles of the reference
(tardis/io/model/parse_density_configuration.py:40-240):
branch85_w7 (power-law with W7 constants), uniform, power_law, exponential,
plus the t^-3 homologous dilution from the profile epoch to t_explosion.
"""

from __future__ import annotations

import numpy as np

# W7 defaults (schema model_definitions.yml:18-28)
W7_TIME_0 = 0.000231481 * 86400.0  # s (~20 s)
W7_RHO_0 = 3.0e29  # g/cm^3
W7_V_0 = 1.0e5  # cm/s (1 km/s)


def power_law_density(v_middle, v_0, rho_0, exponent):
    return rho_0 * (v_middle / v_0) ** exponent


def exponential_density(v_middle, v_0, rho_0):
    return rho_0 * np.exp(-(v_middle / v_0))


def density_after_time(density_0, time_0, time_explosion):
    """Homologous expansion: rho ~ t^-3."""
    return density_0 * (time_explosion / time_0) ** -3


def calculate_density(density_config: dict, v_middle, time_explosion):
    """Compute the shell density [g/cm^3] at time_explosion.

    ``density_config`` is the parsed ``model.structure.density`` section.
    """
    dtype = density_config["type"]
    if dtype == "branch85_w7":
        time_0 = density_config.get("w7_time_0", W7_TIME_0)
        rho_0 = density_config.get("w7_rho_0", W7_RHO_0)
        v_0 = density_config.get("w7_v_0", W7_V_0)
        density_0 = power_law_density(v_middle, v_0, rho_0, -7)
    elif dtype == "uniform":
        density_0 = np.full_like(v_middle, density_config["value"])
        time_0 = density_config.get("time_0", time_explosion)
    elif dtype == "power_law":
        density_0 = power_law_density(
            v_middle,
            density_config["v_0"],
            density_config["rho_0"],
            density_config["exponent"],
        )
        time_0 = density_config.get("time_0", time_explosion)
    elif dtype == "exponential":
        density_0 = exponential_density(
            v_middle, density_config["v_0"], density_config["rho_0"]
        )
        time_0 = density_config.get("time_0", time_explosion)
    else:
        raise ValueError(f"Unrecognized density type '{dtype}'")
    return density_after_time(density_0, time_0, time_explosion)
