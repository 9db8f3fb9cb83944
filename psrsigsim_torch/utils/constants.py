"""Physical constants in canonical units.

Mirrors the reference's constants module (psrsigsim/utils/constants.py:13-16)
but exposes both unit-tagged quantities (config boundary) and plain floats
(kernel boundary).
"""

from .quantity import Quantity, Unit

__all__ = [
    "DM_K",
    "DM_K_MS_MHZ2",
    "KOLMOGOROV_BETA",
    "KB_JY_M2_PER_K",
]

# Dispersion constant, PSRCHIVE-compatible convention:
# DM_K = 1/2.41e-4 MHz^2 cm^3 s / pc  (reference: utils/constants.py:13)
_DM_K_VALUE = 1.0 / 2.41e-4  # in MHz^2 cm^3 s / pc
DM_K = Quantity(_DM_K_VALUE, Unit("MHz^2*cm^3*s/pc"))

# The same constant expressed for kernels that work in (MHz, ms):
# delay_ms = DM_K_MS_MHZ2 * DM[pc/cm^3] / freq[MHz]^2
DM_K_MS_MHZ2 = _DM_K_VALUE * 1e3  # = 4.149378e6 ms MHz^2 cm^3 / pc

# Kolmogorov scattering spectral exponent (reference: utils/constants.py:16)
KOLMOGOROV_BETA = 11.0 / 3.0

# Boltzmann constant in radio units, k_B = 1.38064852e3 Jy m^2 / K
# (reference: telescope/telescope.py:12)
KB_JY_M2_PER_K = 1.38064852e3
