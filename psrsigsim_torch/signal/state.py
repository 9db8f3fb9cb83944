"""Signal state and static metadata (counterpart:
psrsigsim_tpu/signal/state.py).

* :class:`SignalState` — the dynamic contents of a signal in the
  object-oriented flow: the ``(Nchan, Nsamp)`` sample tensor and the
  accumulated per-channel delay.
* :class:`SignalMeta` — a frozen, hashable record of the band geometry,
  sampling, fold config and dtype tag; the pipeline configuration carries
  it and shapes derive from it on the host.

Importing this module does not import torch: the PSRFITS writer processes
unpickle signal shells.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["SignalMeta", "SignalState", "FLOAT32", "INT8", "empty_state"]

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


class SignalState:
    """Dynamic signal contents: ``data (..., Nchan, Nsamp)`` (a tensor on
    the signal's device) and the accumulated per-channel ``delay_ms``
    (None before any propagation stage; the reference accumulates the same
    way, ism/ism.py:44-47,123-126,190-193)."""

    __slots__ = ("data", "delay_ms")

    def __init__(self, data, delay_ms=None):
        self.data = data
        self.delay_ms = delay_ms

    def replace(self, **kw):
        return SignalState(
            data=kw.get("data", self.data),
            delay_ms=kw.get("delay_ms", self.delay_ms),
        )

    def add_delay(self, delay_ms):
        """Accumulate a per-channel delay vector (ms)."""
        new = delay_ms if self.delay_ms is None else self.delay_ms + delay_ms
        return self.replace(delay_ms=new)

    def __repr__(self):
        shape = tuple(getattr(self.data, "shape", ()))
        delay = "set" if self.delay_ms is not None else "None"
        return f"SignalState(data{shape}, delay={delay})"


def empty_state(meta, nsamp, device=None):
    """A :class:`SignalState` holding a zeroed ``(Nchan, nsamp)`` float32
    tensor on ``device`` (default: the CUDA card)."""
    import torch

    from ..utils.device import resolve_device

    return SignalState(data=torch.zeros((meta.nchan, nsamp),
                                        dtype=torch.float32,
                                        device=resolve_device(device)))
