"""Physical constants in cgs (CODATA 2018, as astropy gives them) and the
unit factors the configuration's quantities use."""

import math

C = 2.99792458e10  # cm / s
H = 6.62607015e-27  # erg s
K_B = 1.380649e-16  # erg / K
M_E = 9.1093837015e-28  # g
E_CHARGE = 4.80320471257e-10  # esu
SIGMA_THOMSON = 6.6524587321e-25  # cm^2
SIGMA_SB = 5.6703744191844314e-05  # erg cm^-2 s^-1 K^-4
M_U = 1.6605390666e-24  # g
B_WIEN = 0.28977719551851727  # cm K
L_SUN = 3.828e33  # erg / s
SOBOLEV_COEFFICIENT = math.pi * E_CHARGE**2 / (M_E * C)
_ZETA5 = 1.0369277551433699  # Riemann zeta(5)
# T_rad = T_RADIATIVE_ESTIMATOR_CONSTANT * nu_bar / j (Lucy 2003)
T_RADIATIVE_ESTIMATOR_CONSTANT = (math.pi**4 / (15.0 * 24.0 * _ZETA5)) * (
    H / K_B)

# transport units: lengths / (c t_exp), frequencies / NU_UNIT
NU_UNIT = 1.0e15

UNITS = {"km/s": 1e5, "cm/s": 1.0, "day": 86400.0, "s": 1.0,
         "angstrom": 1e-8, "cm": 1.0, "K": 1.0}

# mean atomic masses [amu] for Z = 1..30
ATOMIC_MASSES = (
    1.008, 4.0026, 6.94, 9.0122, 10.81, 12.011, 14.007, 15.999, 18.998,
    20.180, 22.990, 24.305, 26.982, 28.085, 30.974, 32.06, 35.45, 39.948,
    39.098, 40.078, 44.956, 47.867, 50.942, 51.996, 54.938, 55.845,
    58.933, 58.693, 63.546, 65.38,
)
SYMBOLS = (
    "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
    "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
)


def quantity(value) -> float:
    """'1.1e4 km/s', '9.44 log_lsun', '13 day' or a number, in cgs."""
    if isinstance(value, (int, float)):
        return float(value)
    mag, _, unit = str(value).partition(" ")
    unit = unit.strip()
    if not unit:
        return float(mag)
    if unit == "log_lsun":
        return 10.0 ** float(mag) * L_SUN
    return float(mag) * UNITS[unit]
