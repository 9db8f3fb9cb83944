"""Telescope receiver: bandpass + radiometer noise (counterpart:
psrsigsim_tpu/models/telescope/receiver.py).

Behavioral counterpart of psrsigsim/telescope/receiver.py.  Noise levels
follow Lorimer & Kramer eq 7.12 with the Lam et al. 2018a profile-
normalization scaling; the scipy global-RNG draws over ``(Nchan, Nsamp)``
(receiver.py:136,170) become one explicit-key χ² draw on the signal's
device, jax's threefry stream (``ops/stats.py``).  The pipelines take the
noise scale from :meth:`Receiver._pow_noise_norm` and draw their own.
"""

from __future__ import annotations

import numpy as np

from ...utils.quantity import make_quant

__all__ = ["Receiver", "response_from_data"]


def _add_pow_noise_kernel(key, data, df, norm):
    # df a Python number, so the χ² routing is by value; the JAX package
    # jits this kernel with df static, and XLA compiles the draw as
    # chi2_sample_compiled does and the scale-and-add into one FMA (with
    # the exact gamma's constants folded into the scale)
    from ...ops.stats import chi2_noise_compiled

    return chi2_noise_compiled(key, df, data, norm)


def _add_amp_noise_kernel(key, data, norm):
    # the JAX package jits this kernel, and XLA compiles the scale-and-add
    # into one FMA
    from ...ops.stats import fma, normal_sample

    return fma(normal_sample(key, tuple(data.shape)), norm, data)


class Receiver:
    """A receiver: flat bandpass (fcent/bandwidth) + receiver temperature
    (reference: receiver.py:12-57).

    Required: EITHER a callable ``response`` carrying ``fcent``/
    ``bandwidth`` attributes in MHz (build one with
    :func:`response_from_data`; the reference stubs this path,
    receiver.py:49) OR ``fcent`` and ``bandwidth`` for a flat response.
    """

    def __init__(self, response=None, fcent=None, bandwidth=None, Trec=35,
                 name=None, seed=None):
        if response is None:
            if fcent is None or bandwidth is None:
                raise ValueError("specify EITHER response OR fcent and bandwidth")
            self._response = _flat_response(fcent, bandwidth)
        else:
            if fcent is not None or bandwidth is not None:
                raise ValueError("specify EITHER response OR fcent and bandwidth")
            # custom bandpass (NotImplemented upstream, receiver.py:49):
            # the callable must carry its band metadata — use
            # response_from_data to build one from sampled data
            fcent = getattr(response, "fcent", None)
            bandwidth = getattr(response, "bandwidth", None)
            if fcent is None or bandwidth is None:
                raise ValueError(
                    "a custom response callable must carry fcent/bandwidth "
                    "attributes (MHz); build it with response_from_data")
            self._response = response

        self._Trec = make_quant(Trec, "K")
        self._name = name
        self._fcent = make_quant(fcent, "MHz")
        self._bandwidth = make_quant(bandwidth, "MHz")
        from ...utils.rng import KeySequence, default_keys

        self._keys = KeySequence(seed) if seed is not None else default_keys

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

    def radiometer_noise(self, signal, pulsar, gain=1, Tsys=None, Tenv=None):
        """Add radiometer noise to the signal's data in place, on its
        device (reference: receiver.py:82-121)."""
        Tsys = self._resolve_tsys(Tsys, Tenv)
        gain = make_quant(gain, "K/Jy")

        if signal.sigtype in ["RFSignal", "BasebandSignal"]:
            self._add_amp_noise(signal, Tsys, gain, pulsar)
        elif signal.sigtype == "FilterBankSignal":
            self._add_pow_noise(signal, Tsys, gain, pulsar)
        else:
            raise NotImplementedError(
                "no pulse method for signal: {}".format(signal.sigtype)
            )

    def _amp_noise_norm(self, signal, Tsys, gain, pulsar):
        """Amplitude-signal noise scale (reference: receiver.py:123-138).

        Reproduces the reference numerically, including its unit quirk:
        U_scale = 1/(sum(max_profile)/samprate) carries a stray MHz that
        ``.value`` silently drops (receiver.py:133-138).
        """
        dt = 1 / signal.samprate
        sigS = Tsys / gain / np.sqrt(2 * dt * signal.bw)
        u_scale = float(signal.samprate.to("MHz").value) / float(
            np.sum(pulsar.Profiles._max_profile)
        )
        return float(
            np.sqrt(float((sigS / signal._Smax).decompose())) * u_scale
        )

    def _pow_noise_norm(self, signal, Tsys, gain, pulsar):
        """Intensity-signal noise scale (reference: receiver.py:140-172)."""
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

    def _add_amp_noise(self, signal, Tsys, gain, pulsar):
        from ...utils.device import to_device

        norm = self._amp_noise_norm(signal, Tsys, gain, pulsar)
        data = signal.data
        signal.data = _add_amp_noise_kernel(
            to_device(self._keys.next("noise"), data.device), data,
            float(np.float32(norm)))

    def _add_pow_noise(self, signal, Tsys, gain, pulsar):
        from ...utils.device import to_device

        norm, df = self._pow_noise_norm(signal, Tsys, gain, pulsar)
        data = signal.data
        signal.data = _add_pow_noise_kernel(
            to_device(self._keys.next("noise"), data.device), data,
            float(df), float(np.float32(norm))
        )


def response_from_data(fs, values):
    """Generate a callable bandpass from sampled (frequency, response)
    data (stub in the reference, receiver.py:176-180; completed here).

    ``fs`` are frequencies in MHz (monotonically increasing), ``values``
    the measured response at those frequencies.  Returns a callable
    ``response(f)`` interpolating linearly inside the sampled band and
    zero outside it, carrying ``fcent``/``bandwidth`` attributes (the
    response-weighted band center and the sampled span) so
    :class:`Receiver` can take it directly in place of a flat band.
    """
    fs = np.asarray(fs, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    if fs.ndim != 1 or fs.shape != values.shape or fs.size < 2:
        raise ValueError("fs and values must be matching 1-D arrays "
                         "with at least two samples")
    if np.any(np.diff(fs) <= 0):
        raise ValueError("fs must be strictly increasing")

    def response(f):
        # .to("MHz") BEFORE .value: make_quant returns compatible
        # quantities unchanged, so a GHz input must be converted, not
        # stripped (same handling as _flat_response below)
        fq = np.asarray(make_quant(f, "MHz").to("MHz").value,
                        dtype=np.float64)
        return np.interp(fq, fs, values, left=0.0, right=0.0)

    # fcent/bandwidth describe the SAMPLED band: the midpoint pairs with
    # the span so [fcent - bw/2, fcent + bw/2] is exactly [fs[0], fs[-1]]
    # (a response-weighted centroid would shift the implied band off the
    # sampled one for asymmetric responses)
    response.fcent = float(0.5 * (fs[0] + fs[-1]))
    response.bandwidth = float(fs[-1] - fs[0])
    return response


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
