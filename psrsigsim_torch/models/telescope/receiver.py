"""Telescope receiver: bandpass and radiometer noise level (counterpart:
psrsigsim_tpu/models/telescope/receiver.py, its configuration half).

Noise levels follow Lorimer & Kramer eq 7.12 with the Lam et al. 2018a
profile-normalization scaling (reference: psrsigsim/telescope/
receiver.py:140-172).  The pipelines draw the noise; the in-place
``radiometer_noise`` of the object-oriented flow comes with a later slice.
"""

from __future__ import annotations

import numpy as np

from ...utils.quantity import make_quant

__all__ = ["Receiver"]


class Receiver:
    """A receiver: flat bandpass (fcent/bandwidth) + receiver temperature
    (reference: receiver.py:12-57).  Custom bandpass responses come with a
    later slice."""

    def __init__(self, fcent, bandwidth, Trec=35, name=None, seed=None):
        self._response = _flat_response(fcent, bandwidth)

        self._Trec = make_quant(Trec, "K")
        self._name = name
        self._fcent = make_quant(fcent, "MHz")
        self._bandwidth = make_quant(bandwidth, "MHz")
        self._seed = seed

    def __repr__(self):
        return "Receiver({:s})".format(self._name)

    @property
    def name(self):
        return self._name

    @property
    def Trec(self):
        return self._Trec

    @property
    def response(self):
        return self._response

    @property
    def fcent(self):
        return self._fcent

    @property
    def bandwidth(self):
        return self._bandwidth

    def _resolve_tsys(self, Tsys, Tenv):
        """Tsys = Tenv + Trec, unless Tsys given (just Trec if neither)
        (reference: receiver.py:100-108)."""
        tsys_val = Tsys.value if hasattr(Tsys, "value") else Tsys
        tenv_val = Tenv.value if hasattr(Tenv, "value") else Tenv
        if tsys_val is None and tenv_val is None:
            return self.Trec
        if tenv_val is not None:
            if tsys_val is not None:
                raise ValueError("specify EITHER Tsys OR Tenv, not both")
            return make_quant(Tenv, "K") + self.Trec
        return make_quant(Tsys, "K")

    def _pow_noise_norm(self, signal, Tsys, gain, pulsar):
        """Intensity-signal noise scale and χ² df (reference:
        receiver.py:140-172)."""
        nbins = signal.nsamp / signal.nsub  # bins per subint
        dt = signal.sublen / nbins
        bw_per_chan = signal.bw / signal.Nchan
        sigS = Tsys / gain / np.sqrt(2 * dt * bw_per_chan)
        df = signal.Nfold if signal.fold else 1
        u_scale = 1.0 / (float(np.sum(pulsar.Profiles._max_profile)) / nbins)
        norm = (
            float(((sigS * signal._draw_norm) / signal._Smax).decompose()) * u_scale
        )
        return norm, float(df)


def _flat_response(fcent, bandwidth):
    """Flat (heaviside-edged) bandpass callable
    (reference: receiver.py:182-197)."""
    fc = make_quant(fcent, "MHz")
    bw = make_quant(bandwidth, "MHz")
    fmin = fc - bw / 2
    fmax = fc + bw / 2

    def bandpass(f):
        f = make_quant(f, "MHz")
        return np.heaviside((f - fmin).to("MHz").value, 0) * np.heaviside(
            (fmax - f).to("MHz").value, 0
        )

    return bandpass
