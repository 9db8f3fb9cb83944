"""Telescope backend: sampler metadata, ADC, folding (counterpart:
psrsigsim_tpu/models/telescope/backend.py)."""

from __future__ import annotations

from ...ops.window import fold_periods
from ...utils.quantity import make_quant

__all__ = ["Backend"]


class Backend:
    """Backend sampler (reference: backend.py:10-31)."""

    def __init__(self, samprate=None, name=None):
        self._name = name
        self._samprate = make_quant(samprate, "MHz")

    def __repr__(self):
        return "Backend({:s})".format(self._name)

    @property
    def name(self):
        return self._name

    @property
    def samprate(self):
        return self._samprate

    def adc(self, signal):
        """analog-digital-converter (no-op upstream, backend.py:27-31;
        kept as a no-op for parity — the cast happens in
        ``Telescope.observe``)."""

    def fold(self, signal, pulsar):
        """Fold data at the pulsar period: sum complete periods into one
        profile per channel, on the data's device.

        The reference's reshape (backend.py:34-49) only succeeds for one
        special observation length; the JAX package implements the evident
        intent (its DIVERGENCES #2): ``(Nf, Nt) -> (Nf, Nph)`` with
        ``Nph = int(period * samprate)``, ragged tail truncated.
        """
        nph = int((pulsar.period * signal.samprate).decompose())
        return fold_periods(signal.data, nph)
