"""Static signal metadata (counterpart: psrsigsim_tpu/signal/state.py,
``SignalMeta``).

A frozen, hashable record of the band geometry, sampling, fold config and
dtype tag; the pipeline configuration carries it and shapes derive from it
on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["SignalMeta", "FLOAT32", "INT8"]

# dtype tags kept as strings so SignalMeta stays hashable
FLOAT32 = "float32"
INT8 = "int8"


@dataclasses.dataclass(frozen=True)
class SignalMeta:
    """Static signal configuration.

    Canonical units: MHz for frequencies/rates, seconds for durations.
    Mirrors the metadata surface of the reference's BaseSignal/
    FilterBankSignal (signal/signal.py:43-71, signal/fb_signal.py:64-112).
    """

    sigtype: str  # "FilterBankSignal" | "BasebandSignal" | "RFSignal"
    fcent_mhz: float
    bw_mhz: float
    samprate_mhz: float
    nchan: int
    npols: int = 1
    dtype: str = FLOAT32
    fold: bool = True
    sublen_s: Optional[float] = None

    def dat_freq_mhz(self):
        """Channel center grid: ``arange(fcent-bw/2, fcent+bw/2, bw/nchan)``
        (reference: fb_signal.py:101-106)."""
        first = self.fcent_mhz - self.bw_mhz / 2
        last = self.fcent_mhz + self.bw_mhz / 2
        step = self.bw_mhz / self.nchan
        return np.arange(first, last, step)

    def nsamp_for(self, tobs_s):
        """Samples per channel for an observation of ``tobs_s`` seconds."""
        return int(tobs_s * self.samprate_mhz * 1e6)

    @property
    def np_dtype(self):
        return np.int8 if self.dtype == INT8 else np.float32
