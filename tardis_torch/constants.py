"""Physical constants in CGS units.

All values follow CODATA 2018 / astropy.constants (the reference obtains them
via ``tardis.constants`` = astropy; see e.g.
tardis/transport/montecarlo/configuration/constants.py:1-10).
We hard-code the cgs floats so the framework has no astropy dependency in the
compute path.
"""

import numpy as np

# Speed of light [cm/s]
C = 2.99792458e10
# Planck constant [erg s]
H = 6.62607015e-27
# Boltzmann constant [erg/K]
K_B = 1.380649e-16
# Electron rest mass [g]
M_E = 9.1093837015e-28
# Elementary charge [esu] (gaussian units)
E_CHARGE = 4.80320471257e-10
# Thomson cross-section [cm^2]
SIGMA_THOMSON = 6.6524587321e-25
# Stefan-Boltzmann constant [erg cm^-2 s^-1 K^-4]
SIGMA_SB = 5.6703744191844314e-05
# Radiation constant a = 4 sigma / c [erg cm^-3 K^-4]
A_RAD = 4.0 * SIGMA_SB / C
# Atomic mass unit [g]
M_U = 1.6605390666e-24
# Wien displacement constant [cm K]
B_WIEN = 0.28977719551851727

# Solar luminosity [erg/s]
L_SUN = 3.828e33
# Solar mass [g]
M_SUN = 1.98892e33

# Day in seconds
DAY = 86400.0

# Sobolev coefficient: pi e^2 / (m_e c)  [cm^2 s^-1 * cm ...]; used as
# tau = COEF * lambda * f_lu * t_exp * n_lower * stim_factor
# (reference: tardis/opacities/tau_sobolev.py:10-19)
SOBOLEV_COEFFICIENT = float(np.pi * E_CHARGE**2 / (M_E * C))

# Estimator-inversion constants
# (reference: tardis/transport/montecarlo/estimators/mc_rad_field_solver.py:20-28)
# T_rad = T_RADIATIVE_ESTIMATOR_CONSTANT * nu_bar_estimator / j_estimator
_ZETA5 = 1.0369277551433699  # Riemann zeta(5)
T_RADIATIVE_ESTIMATOR_CONSTANT = float(
    (np.pi**4 / (15.0 * 24.0 * _ZETA5)) * (H / K_B)
)
DILUTION_FACTOR_ESTIMATOR_CONSTANT = float(
    (C**2 / (2.0 * H)) * (15.0 / np.pi**4) * (H / K_B) ** 4 / (4.0 * np.pi)
)

# Sentinel distance for "no interaction possible" [cm]
# (reference: transport/montecarlo/configuration/constants.py MISS_DISTANCE=1e99;
#  we use a float32-safe sentinel since the transport kernel runs in f32)
MISS_DISTANCE = 1e30

# Relative nu threshold under which a line is considered co-located with the
# packet (reference CLOSE_LINE_THRESHOLD=1e-14 in f64; f32 kernels handle this
# by clamping distances at 0 instead).
CLOSE_LINE_THRESHOLD = 1e-14
