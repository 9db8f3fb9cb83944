"""Signal configuration objects with reference API parity (counterpart:
psrsigsim_tpu/signal/signals.py, ``BaseSignal`` and ``FilterBankSignal``).

In this slice a signal is a configuration object: it holds the band,
sampling and fold settings and the bookkeeping flags the reference
scatters across private attributes (``_nsub``, ``_Nfold``, ``_draw_norm``,
``_Smax``...), which :func:`psrsigsim_torch.simulate.build_fold_config`
stamps.  It carries no sample data: the pipelines return tensors.
"""

from __future__ import annotations

import numpy as np

from ..utils.quantity import Quantity, make_quant
from .state import FLOAT32, INT8, SignalMeta

__all__ = ["BaseSignal", "FilterBankSignal"]

_DTYPE_TAGS = {
    np.float32: FLOAT32,
    "float32": FLOAT32,
    np.int8: INT8,
    "int8": INT8,
}


def _dtype_tag(dtype):
    """Validate and normalize the dtype argument to {float32, int8}
    (the reference's check, signal/signal.py:56, was an always-true no-op;
    the JAX package's DIVERGENCES #1)."""
    try:
        hashable = dtype if isinstance(dtype, (str, type)) else np.dtype(dtype).type
    except TypeError:
        hashable = None
    if hashable in _DTYPE_TAGS:
        return _DTYPE_TAGS[hashable]
    raise ValueError(f"data type {dtype!r} not supported")


class BaseSignal:
    """Base class for signals (reference: signal/signal.py:11-165).

    Required Args:
        fcent [float]: central radio frequency (MHz)
        bandwidth [float]: radio bandwidth of signal (MHz)
    """

    _sigtype = "Signal"

    def __init__(self, fcent, bandwidth, sample_rate=None, dtype=np.float32,
                 Npols=1):
        self._fcent = make_quant(fcent, "MHz")
        bw = make_quant(bandwidth, "MHz")
        self._bw = abs(bw) if bw.value < 0 else bw
        self._samprate = (
            make_quant(sample_rate, "MHz") if sample_rate is not None else None
        )
        self._dtype_tag = _dtype_tag(dtype)
        if Npols != 1:
            raise ValueError("Only total intensity polarization is currently supported")
        self._Npols = 1

        self._delay = None
        self._dm = None
        self._tobs = None
        self._nsamp = None
        self._Nchan = None
        self._draw_max = None
        self._draw_norm = 1

    def __repr__(self):
        return f"{self.sigtype}({self.fcent}, bw={self.bw})"

    def _set_draw_norm(self):
        raise NotImplementedError()

    @property
    def sigtype(self):
        return self._sigtype

    @property
    def Nchan(self):
        return self._Nchan

    @property
    def fcent(self):
        return self._fcent

    @property
    def bw(self):
        return self._bw

    @property
    def tobs(self):
        return self._tobs

    @property
    def samprate(self):
        return self._samprate

    @property
    def nsamp(self):
        return self._nsamp

    @property
    def dtype(self):
        return np.int8 if self._dtype_tag == INT8 else np.float32

    @property
    def Npols(self):
        return self._Npols

    @property
    def dat_freq(self):
        return self._dat_freq

    @property
    def delay(self):
        return self._delay

    @delay.setter
    def delay(self, value):
        self._delay = value

    @property
    def dm(self):
        return self._dm

    @property
    def DM(self):
        return self._dm


class FilterBankSignal(BaseSignal):
    """2-D intensity signal ``(Nchan, Nsamp)``; fold vs single-pulse modes
    (reference: signal/fb_signal.py:11-161).

    Optional Args:
        Nsubband [int]: number of sub-bands, default 512
        sample_rate [float]: MHz; default 1/(20.48 us) — the coherently-
            dedispersed XUPPI rate
        sublen [float]: subintegration length (s) in fold mode
        fold [bool]: folded subintegrations (True) or single pulses (False)
    """

    _sigtype = "FilterBankSignal"

    def __init__(self, fcent, bandwidth, Nsubband=512, sample_rate=None,
                 sublen=None, dtype=np.float32, fold=True):
        super().__init__(fcent, bandwidth, sample_rate=sample_rate,
                         dtype=dtype, Npols=1)
        self._fold = bool(fold)
        self._sublen = None if sublen is None else make_quant(sublen, "s")
        self._Nfold = None
        self._nsub = None

        if self._samprate is None:
            self._samprate = (1 / make_quant(20.48, "us")).to("MHz")
        else:
            f_nyquist = 2 * self._bw
            if self._samprate < f_nyquist:
                print(
                    "Warning: specified sample rate {} < Nyquist frequency {}".format(
                        self._samprate, f_nyquist
                    )
                )

        self._Nchan = int(Nsubband)
        first = (self._fcent - self._bw / 2).to("MHz").value
        last = (self._fcent + self._bw / 2).to("MHz").value
        step = (self._bw / self._Nchan).to("MHz").value
        self._dat_freq = Quantity(np.arange(first, last, step), "MHz")

        self._set_draw_norm()

    def _set_draw_norm(self, df=1):
        """Dynamic-range scaling for the intensity draws
        (reference: fb_signal.py:114-121)."""
        # imported here: unpickling a signal (the PSRFITS writer
        # processes) must not import torch
        from ..ops.stats import chi2_draw_norm

        self._draw_max, self._draw_norm = chi2_draw_norm(self.dtype, df)

    @property
    def fold(self):
        return self._fold

    @property
    def sublen(self):
        return self._sublen

    @property
    def Nfold(self):
        return self._Nfold

    @property
    def nsub(self):
        return self._nsub

    def meta(self):
        return SignalMeta(
            sigtype=self.sigtype,
            fcent_mhz=float(self._fcent.to("MHz").value),
            bw_mhz=float(self._bw.to("MHz").value),
            samprate_mhz=float(self._samprate.to("MHz").value),
            nchan=self._Nchan,
            npols=self._Npols,
            dtype=self._dtype_tag,
            fold=self._fold,
            sublen_s=(
                float(self._sublen.to("s").value) if self._sublen is not None else None
            ),
        )
