"""Pulsar: period, flux, portrait (counterpart:
psrsigsim_tpu/models/pulsar/pulsar.py, its configuration half).

Behavioral counterpart of psrsigsim/pulsar/pulsar.py.  This slice ports
what :func:`psrsigsim_torch.simulate.build_fold_config` stages: units, the
phase resolution, and the spectral-index portrait.  The object-oriented
``make_pulses``/``null`` flow comes with a later slice; the pipelines draw
the pulses.
"""

from __future__ import annotations

import numpy as np

from ...utils.quantity import make_quant
from .portraits import DataPortrait
from .profiles import GaussProfile

__all__ = ["Pulsar"]


class Pulsar:
    """A pulsar: period, mean flux, pulse portrait, spectral index
    (reference: pulsar.py:11-56).

    Parameters
    ----------
    period : float
        Pulse period (sec)
    Smean : float
        Mean pulse flux density (Jy)
    profiles : PulseProfile-like, optional (default GaussProfile())
    name : str, optional
    specidx : float, optional (default 0.0)
    ref_freq : float, optional (MHz; default = signal band center)
    seed : int, optional — accepted for API parity; the port's pipelines
        take their keys explicitly
    """

    def __init__(self, period, Smean, profiles=None, name=None, specidx=0.0,
                 ref_freq=None, seed=None):
        self._period = make_quant(period, "s")
        self._Smean = make_quant(Smean, "Jy")
        self._name = name
        self._specidx = specidx
        self._ref_freq = make_quant(ref_freq, "MHz") if ref_freq is not None else None
        self._Profiles = profiles if profiles is not None else GaussProfile()
        self._seed = seed

    def __repr__(self):
        namestr = "" if self.name is None else self.name + ", "
        return "Pulsar(" + namestr + "{})".format(self.period.to("ms"))

    @property
    def Profiles(self):
        return self._Profiles

    @property
    def name(self):
        return self._name

    @property
    def period(self):
        return self._period

    @property
    def Smean(self):
        return self._Smean

    @property
    def specidx(self):
        return self._specidx

    @property
    def ref_freq(self):
        return self._ref_freq

    def _nph(self, signal):
        """Phase bins per period at the signal's sample rate
        (reference: pulsar.py:124)."""
        return int((signal.samprate * self.period).decompose())

    def _add_spec_idx(self, signal):
        """Scale the portrait by ``(f/ref_freq)^specidx`` and re-wrap as a
        DataPortrait (reference: pulsar.py:86-105).  Host-side config work."""
        C = (signal.dat_freq / self.ref_freq).value ** self.specidx
        C = np.reshape(C, (signal.Nchan, 1))
        nph = self._nph(signal)
        self.Profiles.init_profiles(nph, Nchan=signal.Nchan)
        phs = np.linspace(0.0, 1.0, nph)
        full_profs = self.Profiles.calc_profiles(phs, Nchan=signal.Nchan) * C
        self._Profiles = DataPortrait(full_profs)
