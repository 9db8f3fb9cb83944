"""Telescope: aperture, gain, Tsys and named (receiver, backend) systems
(counterpart: psrsigsim_tpu/models/telescope/telescope.py, its
configuration half; ``observe`` comes with a later slice)."""

from __future__ import annotations

import numpy as np

from ...utils.constants import KB_JY_M2_PER_K
from ...utils.quantity import Quantity, make_quant
from .backend import Backend
from .receiver import Receiver

__all__ = ["Telescope", "GBT"]

_kB = Quantity(KB_JY_M2_PER_K, "Jy*m^2/K")


class Telescope:
    """A telescope: aperture/area/Tsys + named (receiver, backend) systems
    (reference: telescope.py:14-70)."""

    def __init__(self, aperture, area=None, Tsys=None, name=None):
        self._name = name
        self._aperture = make_quant(aperture, "m")
        self._systems = {}

        if area is None:
            self._area = np.pi * (self.aperture / 2) ** 2
        else:
            self._area = make_quant(area, "m^2")
        self._gain = self.area / (2 * _kB)  # 2 polarizations

        self._Tsys = make_quant(Tsys, "K") if Tsys is not None else None

    def __repr__(self):
        return "Telescope({:s}, {:f}m)".format(self._name, self._aperture.value)

    @property
    def name(self):
        return self._name

    @property
    def area(self):
        return self._area

    @property
    def gain(self):
        return self._gain

    @property
    def aperture(self):
        return self._aperture

    @property
    def systems(self):
        return self._systems

    @property
    def Tsys(self):
        return self._Tsys

    def add_system(self, name=None, receiver=None, backend=None):
        """Append a new (receiver, backend) system
        (reference: telescope.py:67-70)."""
        self._systems[name] = (receiver, backend)


def GBT():
    """The 100m Green Bank Telescope with its NANOGrav-era systems
    (reference: telescope.py:186-206)."""
    g = Telescope(100.0, area=5500.0, Tsys=35.0, name="GBT")
    g.add_system(
        name="820_GUPPI",
        receiver=Receiver(fcent=820, bandwidth=180, name="820"),
        backend=Backend(samprate=3.125, name="GUPPI"),
    )
    g.add_system(
        name="Lband_GUPPI",
        receiver=Receiver(fcent=1400, bandwidth=800, name="Lband"),
        backend=Backend(samprate=12.5, name="GUPPI"),
    )
    g.add_system(
        name="800_GASP",
        receiver=Receiver(fcent=844, bandwidth=64, name="800"),
        backend=Backend(samprate=0.25, name="GASP"),
    )
    g.add_system(
        name="Lband_GASP",
        receiver=Receiver(fcent=1410, bandwidth=64, name="Lband"),
        backend=Backend(samprate=0.25, name="GASP"),
    )
    return g
