"""General utilities: roman numerals, species parsing, luminosity helpers,
synpp export.

Counterpart of ``tardis_tpu/utils/base.py`` (the reference's
``tardis/util/base.py``: int_to_roman :88, roman_to_int :110,
calculate_luminosity :138, create_synpp_yaml :186,
species_tuple_to_string :305, species_string_to_tuple :330,
element_symbol2atomic_number :423, quantity_linspace :504).  Host code;
``create_synpp_yaml`` copies one shell's column of the device tau table.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from tardis_torch.atomic.atom_data import ATOMIC_SYMBOLS, SYMBOL_TO_Z
from tardis_torch.config.reader import parse_quantity  # noqa: F401 (re-export)
from tardis_torch.plasma.lte import intensity_black_body  # noqa: F401


class MalformedError(Exception):
    pass


class MalformedSpeciesError(MalformedError):
    def __init__(self, malformed_element_symbol):
        self.malformed_element_symbol = malformed_element_symbol

    def __str__(self):
        return (
            f'Expecting a species notation (e.g. "Si 2", "Si II", "Fe IV") '
            f"- supplied {self.malformed_element_symbol}"
        )


class MalformedElementSymbolError(MalformedError):
    def __init__(self, malformed_element_symbol):
        self.malformed_element_symbol = malformed_element_symbol

    def __str__(self):
        return f"Expecting an element symbol, supplied {self.malformed_element_symbol}"


_ROMAN = (
    (1000, "M"), (900, "CM"), (500, "D"), (400, "CD"), (100, "C"),
    (90, "XC"), (50, "L"), (40, "XL"), (10, "X"), (9, "IX"),
    (5, "V"), (4, "IV"), (1, "I"),
)
_ROMAN_VALUES = {"I": 1, "V": 5, "X": 10, "L": 50, "C": 100, "D": 500,
                 "M": 1000}


def int_to_roman(i: int) -> str:
    """Integer -> Roman numeral (reference util/base.py:88-108)."""
    if i <= 0:
        raise ValueError("Roman numerals start at 1")
    out = []
    for value, numeral in _ROMAN:
        count = i // value
        out.append(numeral * count)
        i -= value * count
    return "".join(out)


def roman_to_int(roman: str) -> int:
    """Roman numeral -> integer (reference util/base.py:110-136)."""
    s = roman.upper().strip()
    if not s or any(c not in _ROMAN_VALUES for c in s):
        raise ValueError(f"{roman!r} is not a valid roman numeral")
    total = 0
    prev = 0
    for c in reversed(s):
        v = _ROMAN_VALUES[c]
        total += v if v >= prev else -v
        prev = max(prev, v)
    if int_to_roman(total) != s:
        raise ValueError(f"{roman!r} is not a canonical roman numeral")
    return total


def reformat_element_symbol(element_string: str) -> str:
    """'si' -> 'Si' (reference util/base.py:460-476)."""
    return element_string[0].upper() + element_string[1:].lower()


def element_symbol2atomic_number(element_string: str) -> int:
    sym = reformat_element_symbol(element_string)
    if sym not in SYMBOL_TO_Z:
        raise MalformedElementSymbolError(element_string)
    return SYMBOL_TO_Z[sym]


def atomic_number2element_symbol(atomic_number: int) -> str:
    return ATOMIC_SYMBOLS[int(atomic_number) - 1]


def species_string_to_tuple(species_string: str):
    """'Si II' / 'Si2' / 'si_ii' -> (14, 1); ion is 0-based
    (reference util/base.py:330-381)."""
    normalized = species_string.replace("_", " ")
    m = re.match(r"^([A-Za-z]+)\s*(\d+)$", normalized.strip())
    if m:
        symbol, ion_str = m.groups()
    else:
        parts = normalized.split()
        if len(parts) != 2:
            raise MalformedSpeciesError(species_string)
        symbol, ion_str = parts
    atomic_number = element_symbol2atomic_number(symbol)
    try:
        ion_number = roman_to_int(ion_str)
    except ValueError:
        try:
            ion_number = int(ion_str)
        except ValueError:
            raise MalformedSpeciesError(species_string)
    if ion_number - 1 > atomic_number:
        raise ValueError(
            "Species given does not exist: ion number > atomic number"
        )
    return atomic_number, ion_number - 1


def species_tuple_to_string(species_tuple, roman_numerals: bool = True) -> str:
    """(14, 1) -> 'Si II' (reference util/base.py:305-328)."""
    atomic_number, ion_number = species_tuple
    symbol = atomic_number2element_symbol(atomic_number)
    if roman_numerals:
        return f"{symbol} {int_to_roman(ion_number + 1)}"
    return f"{symbol} {ion_number}"


def quantity_linspace(start, stop, num) -> np.ndarray:
    """linspace over quantity strings, cgs floats out
    (reference util/base.py:504-536 returns an astropy Quantity)."""
    return np.linspace(parse_quantity(start), parse_quantity(stop), num)


def calculate_luminosity(
    spec_fname: str,
    distance,
    wavelength_column: int = 0,
    flux_column: int = 1,
):
    """Luminosity from an observed flux spectrum file
    (reference util/base.py:138-184): wavelength [Angstrom], flux
    [erg/s/cm^2/Angstrom]; distance a quantity string like '10 Mpc' or cm.

    Returns (luminosity [erg/s], wl_min, wl_max)."""
    data = np.loadtxt(spec_fname, usecols=(wavelength_column, flux_column))
    wavelength, flux = data[:, 0], data[:, 1]
    d_cm = parse_quantity(distance) if isinstance(distance, str) else float(
        distance
    )
    flux_density = np.trapezoid(flux, wavelength)
    luminosity = flux_density * 4.0 * np.pi * d_cm**2
    return float(luminosity), float(wavelength.min()), float(wavelength.max())


def convert_abundances_format(fname: str, delimiter: str = r"\s+"):
    """Legacy whitespace abundance table -> dict of element columns
    (reference util/base.py:538-560)."""
    data = np.loadtxt(fname)
    if data.ndim == 1:
        data = data[None, :]
    out = {}
    for z in range(1, min(31, data.shape[1] + 1)):
        col = data[:, z - 1]
        if np.any(col > 0):
            out[atomic_number2element_symbol(z)] = col
    return out


def create_synpp_yaml(simulation, fname: str, shell_no: int = 0):
    """Export a syn++ setup from a simulation's plasma state
    (reference util/base.py:186-277).

    For each ion the reference optical depth is the strongest Sobolev line
    in ``shell_no``; ions with log tau <= -50 are dropped, as the
    reference does.  Only that shell's column of the tau table leaves the
    device.
    """
    import yaml

    plasma = simulation.plasma_state
    atom = simulation.atom_data
    state = simulation.state
    tau = torch.as_tensor(plasma.tau_sobolev)[:, shell_no].cpu().numpy()
    # the strongest line of each (Z, ion): ions whose lines are all at
    # tau 0 stay out, as a line must beat 0 to enter
    key = atom.line_z.astype(np.int64) * 1000 + atom.line_ion
    ion_keys, inverse = np.unique(key, return_inverse=True)
    tau_ref = np.zeros(len(ion_keys))
    np.maximum.at(tau_ref, inverse, tau)
    v_ref = state.geometry.v_inner[0] / 1e8  # units of 1000 km/s
    v_outer_max = state.geometry.v_outer[-1] / 1e8
    setup = {
        "ions": [],
        "log_tau": [],
        "active": [],
        "temp": [],
        "v_min": [],
        "v_max": [],
        "aux": [],
        "t_phot": float(state.t_inner),
    }
    for k, t in zip(ion_keys, tau_ref):
        if not t > 0.0:
            continue
        log_tau = float(np.log10(max(t, 1e-99)))
        if log_tau <= -50:
            continue
        z, ion = divmod(int(k), 1000)
        setup["ions"].append(100 * z + ion)
        setup["log_tau"].append(log_tau)
        setup["active"].append(True)
        setup["temp"].append(setup["t_phot"])
        setup["v_min"].append(float(v_ref))
        setup["v_max"].append(float(v_outer_max))
        setup["aux"].append(1e200)
    doc = {
        "output": {
            "min_wl": 500.0,
            "max_wl": 20000.0,
            "wl_step": 5.0,
        },
        "grid": {
            "bin_width": 0.3,
            "v_size": 100,
            "v_outer_max": float(v_outer_max),
        },
        "opacity": {
            "line_dir": "lines",
            "ref_file": "refs.dat",
            "form": "exp",
            "v_ref": float(v_ref),
            "log_tau_min": -2.0,
        },
        "source": {"mu_size": 10},
        "spectrum": {"p_size": 60, "flatten": False},
        "setups": [setup],
    }
    with open(fname, "w") as fh:
        yaml.safe_dump(doc, fh, explicit_start=True, sort_keys=False)
    return doc
