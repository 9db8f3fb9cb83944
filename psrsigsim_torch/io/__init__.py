"""IO: PSRFITS data products and the bulk ensemble export (counterpart:
psrsigsim_tpu/io/).

A from-scratch FITS core, closed-form polycos over an analytic (or SPK)
ephemeris, the PSRFITS writer/reader, the pdv text writer and the streamed
bulk exporter.
These modules are numpy-only copies of the JAX package's: the port cannot
import them, because importing any ``psrsigsim_tpu`` module loads jax.
"""

from .export import ExportManifestError, export_ensemble_psrfits
from .file import BaseFile
from .fits import Card, FitsFile, HDU, Header
from .polyco import generate_polyco, parse_par, polyco_phase
from .psrfits import PSRFITS
from .txtfile import TxtFile

__all__ = [
    "export_ensemble_psrfits",
    "ExportManifestError",
    "BaseFile",
    "PSRFITS",
    "TxtFile",
    "FitsFile",
    "HDU",
    "Header",
    "Card",
    "generate_polyco",
    "parse_par",
    "polyco_phase",
]
