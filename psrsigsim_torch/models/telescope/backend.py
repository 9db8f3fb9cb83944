"""Telescope backend: sampler metadata (counterpart:
psrsigsim_tpu/models/telescope/backend.py; its ``fold`` comes with the
object-oriented observe flow of a later slice)."""

from __future__ import annotations

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
        """analog-digital-converter (a no-op upstream, backend.py:27-31)."""
