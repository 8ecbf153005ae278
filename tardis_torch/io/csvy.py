"""CSVY model reader: YAML header + CSV body.

Counterpart of the reference's csvy model support
(tardis/io/model/csvy.py and parse_density_configuration.py:
71-165): custom multi-shell ejecta with per-shell velocity, density, and
abundances, plus optional analytic density sections in the header.
The port's copy of ``tardis_tpu/io/csvy.py`` (host numpy; pandas is
imported inside ``load_csvy``).  Isotope columns (``Ni56``) decay from
``model_isotope_time_0`` to ``time_explosion`` and fold into the
elements (``model/decay.py``).  A path is taken as given, not resolved
against the configuration's folder.

Format:
    ---
    name: my_model
    model_density_time_0: 1 day
    model_isotope_time_0: 0 day
    datatype:
      fields:
        - {name: velocity, unit: km/s}
        - {name: density, unit: g/cm^3}
        - {name: Si, desc: silicon mass fraction}
    ---
    velocity,density,Si
    10000,1e-13,1.0
    ...
"""

from __future__ import annotations

import io

import numpy as np
import yaml

from tardis_torch.atomic.atom_data import SYMBOL_TO_Z
from tardis_torch.config.reader import parse_quantity, unit_to_cgs_factor
from tardis_torch.model.density import density_after_time
from tardis_torch.model.geometry import Radial1DGeometry
from tardis_torch.model.state import Composition, SimulationState

YAML_DELIMITER = "---"


def load_csvy(path: str):
    """Split a csvy file into (yaml_header_dict, csv_rows)."""
    with open(path) as fh:
        content = fh.read()
    parts = content.split(YAML_DELIMITER)
    if len(parts) < 3:
        raise ValueError(f"{path} is not a valid CSVY file (missing '---')")
    header = yaml.safe_load(parts[1])
    csv_text = YAML_DELIMITER.join(parts[2:]).strip()
    data = None
    if csv_text:
        import pandas as pd

        data = pd.read_csv(io.StringIO(csv_text))
    return header, data


def simulation_state_from_csvy(
    path: str, config
) -> SimulationState:
    """Build a SimulationState from a csvy model + the main config
    (supernova section provides time_explosion / luminosity)."""
    header, data = load_csvy(path)
    t_exp = config.supernova.time_explosion

    field_units = {}
    for f in header.get("datatype", {}).get("fields", []):
        field_units[f["name"]] = f.get("unit", "")

    if data is None or "velocity" not in data:
        raise ValueError("csvy model must tabulate a velocity column")

    v_unit = unit_to_cgs_factor(field_units.get("velocity", "cm/s"))
    velocity = data["velocity"].to_numpy(np.float64) * v_unit  # edges
    geometry = Radial1DGeometry.from_velocity_grid(velocity, t_exp)
    n_shells = geometry.no_of_shells

    # density: tabulated (cell values; first row = inner edge, dropped)
    d_unit = unit_to_cgs_factor(field_units.get("density", "g/cm^3"))
    density_0 = data["density"].to_numpy(np.float64)[1:] * d_unit
    time_0 = parse_quantity(header.get("model_density_time_0", t_exp))
    density = density_after_time(density_0, time_0, t_exp)

    # abundances: element-symbol columns + isotope columns (e.g. Ni56);
    # isotopes are decayed from model_isotope_time_0 to time_explosion and
    # folded into the elemental table (reference model/matter/decay.py)
    from tardis_torch.model.decay import fold_isotopes_into_elements, parse_isotope

    elements, fractions = [], []
    isotopes = {}
    for col in data.columns:
        if col in ("velocity", "density", "t_electron", "t_rad",
                   "dilution_factor"):
            continue
        z = SYMBOL_TO_Z.get(col)
        if z is not None:
            elements.append(z)
            fractions.append(data[col].to_numpy(np.float64)[1:])
        elif parse_isotope(col) is not None:
            isotopes[col] = data[col].to_numpy(np.float64)[1:]
    if isotopes:
        iso_t0 = parse_quantity(header.get("model_isotope_time_0", 0.0))
        elements, mass_fractions = fold_isotopes_into_elements(
            elements, fractions, isotopes, max(t_exp - iso_t0, 0.0)
        )
    else:
        order = np.argsort(elements)
        elements = np.asarray(elements)[order]
        mass_fractions = np.stack([fractions[i] for i in order])
    norm = mass_fractions.sum(axis=0)
    mass_fractions = mass_fractions / np.where(norm > 0, norm, 1.0)

    composition = Composition(
        atomic_numbers=elements,
        mass_fractions=mass_fractions,
        density=density,
    )

    from tardis_torch.constants import B_WIEN, C, SIGMA_SB

    L = config.supernova.luminosity_requested
    r0 = geometry.r_inner[0]
    if config.plasma.initial_t_inner > 0:
        t_inner = float(config.plasma.initial_t_inner)
    else:
        t_inner = float((L / (4.0 * np.pi * r0**2 * SIGMA_SB)) ** 0.25)
    lambda_wien_inner = B_WIEN / t_inner
    t_radiative = B_WIEN / (
        lambda_wien_inner
        * (1.0 + (geometry.v_middle - geometry.v_inner[0]) / C)
    )
    dilution = geometry.geometric_dilution_factor()
    # optional tabulated initial radiation field (reference csvy schema
    # fields t_rad / dilution_factor, io/model/parse_radiation_field_*)
    if "t_rad" in data:
        t_radiative = data["t_rad"].to_numpy(np.float64)[1:]  # Kelvin
    if "dilution_factor" in data:
        dilution = data["dilution_factor"].to_numpy(np.float64)[1:]
    return SimulationState(
        geometry=geometry,
        composition=composition,
        time_explosion=t_exp,
        luminosity_requested=L,
        t_inner=t_inner,
        t_radiative=t_radiative,
        dilution_factor=dilution,
    )
