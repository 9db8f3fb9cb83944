"""User-facing signal classes with reference API parity (counterpart:
psrsigsim_tpu/signal/signals.py).

A signal holds a :class:`SignalMeta`-style configuration (band, sampling,
fold settings), the bookkeeping flags the reference scatters across
private attributes (``_nsub``, ``_Nfold``, ``_draw_norm``, ``_Smax``,
``_delay``, ``_dispersed``...), and in the object-oriented flow a
:class:`SignalState` whose ``data`` is the ``(Nchan, Nsamp)`` sample
tensor.  The tensor lives on the signal's device: the CUDA card unless the
signal was made with ``device="cpu"`` (or another device).  The pipelines
(:func:`psrsigsim_torch.simulate.build_fold_config`, ``FoldEnsemble``) use
the signal as a configuration object only.

Importing this module does not import torch, and neither does unpickling a
signal without data: the PSRFITS writer processes unpickle signal shells.
"""

from __future__ import annotations

import numpy as np

from ..utils.quantity import Quantity, make_quant
from .state import FLOAT32, INT8, SignalMeta, SignalState

__all__ = ["BaseSignal", "Signal", "FilterBankSignal", "BasebandSignal",
           "RFSignal"]

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

    Optional Args:
        device: where the signal's data lives (``None`` = the CUDA card,
            resolved when data is first made; ``"cpu"`` for the host)
    """

    _sigtype = "Signal"

    def __init__(self, fcent, bandwidth, sample_rate=None, dtype=np.float32,
                 Npols=1, device=None):
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
        # kept as a string: a torch.device would make the pickled shell
        # import torch
        self._device = None if device is None else str(device)

        self._state = None
        self._delay = None
        self._dm = None
        self._tobs = None
        self._nsamp = None
        self._Nchan = None
        self._draw_max = None
        self._draw_norm = 1

    # -- data management ----------------------------------------------------
    @property
    def device(self):
        """The ``torch.device`` of the signal's data; raises when it is the
        card and there is none (see :func:`~psrsigsim_torch.utils.device.
        resolve_device`)."""
        from ..utils.device import resolve_device

        return resolve_device(self._device)

    def init_data(self, Nsamp):
        """Allocate a zeroed ``(Nchan, Nsamp)`` float32 buffer on the
        signal's device (reference: signal/signal.py:87-94 uses np.empty;
        zeros are safer)."""
        import torch

        self._nsamp = int(Nsamp)
        self._state = SignalState(data=torch.zeros(
            (self.Nchan, self._nsamp), dtype=torch.float32, device=self.device))

    @property
    def state(self):
        """The underlying :class:`SignalState` (data tensor and delay)."""
        return self._state

    @state.setter
    def state(self, new_state):
        self._state = new_state

    def meta(self, fold=False, sublen_s=None):
        """Build the static :class:`SignalMeta` for functional pipelines."""
        return SignalMeta(
            sigtype=self.sigtype,
            fcent_mhz=float(self._fcent.to("MHz").value),
            bw_mhz=float(self._bw.to("MHz").value),
            samprate_mhz=float(self._samprate.to("MHz").value),
            nchan=int(self.Nchan),
            npols=self._Npols,
            dtype=self._dtype_tag,
            fold=fold,
            sublen_s=sublen_s,
        )

    # -- reference-parity surface ------------------------------------------
    def __repr__(self):
        return f"{self.sigtype}({self.fcent}, bw={self.bw})"

    def __add__(self, b):
        """overload ``+`` to concatenate signals"""
        raise NotImplementedError()

    def _set_draw_norm(self):
        raise NotImplementedError()

    def to_RF(self):
        raise NotImplementedError()

    def to_Baseband(self):
        raise NotImplementedError()

    def to_FilterBank(self, Nsubband=512):
        raise NotImplementedError()

    @property
    def data(self):
        return self._state.data if self._state is not None else None

    @data.setter
    def data(self, value):
        if self._state is None:
            self._state = SignalState(data=value)
        else:
            self._state = self._state.replace(data=value)

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


def Signal():
    """helper function to instantiate signals (reference stub,
    signal/signal.py:168-171)"""
    raise NotImplementedError()


class FilterBankSignal(BaseSignal):
    """2-D intensity signal ``(Nchan, Nsamp)``; fold vs single-pulse modes
    (reference: signal/fb_signal.py:11-161).

    Optional Args:
        Nsubband [int]: number of sub-bands, default 512
        sample_rate [float]: MHz; default 1/(20.48 us) — the coherently-
            dedispersed XUPPI rate
        sublen [float]: subintegration length (s) in fold mode
        fold [bool]: folded subintegrations (True) or single pulses (False)
        device: where the data lives (``None`` = the CUDA card)
    """

    _sigtype = "FilterBankSignal"

    def __init__(self, fcent, bandwidth, Nsubband=512, sample_rate=None,
                 sublen=None, dtype=np.float32, fold=True, device=None):
        super().__init__(fcent, bandwidth, sample_rate=sample_rate,
                         dtype=dtype, Npols=1, device=device)
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
        (reference: fb_signal.py:114-121).  As in the reference, the data
        tensor stays floating point for ``dtype=int8`` signals: the dtype
        selects the draw-norm/clip dynamic range, and ``Telescope.observe``
        casts what it returns."""
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

    def to_FilterBank(self, Nsubband=512):
        return self


class BasebandSignal(BaseSignal):
    """Complex-band time-domain signal, 0 Hz → bw; Nyquist default
    sampling; ``Nchan`` polarization channels (reference:
    signal/bb_signal.py:9-77; the JAX package's ``BasebandSignal``).

    Optional Args:
        device: where the data lives (``None`` = the CUDA card)
    """

    _sigtype = "BasebandSignal"

    def __init__(self, fcent, bandwidth, sample_rate=None, dtype=np.float32,
                 Nchan=2, device=None):
        super().__init__(fcent, bandwidth, sample_rate=sample_rate,
                         dtype=dtype, Npols=1, device=device)
        self._Nchan = int(Nchan)
        self._dat_freq = Quantity(
            np.full(self._Nchan, self._fcent.to("MHz").value), "MHz"
        )

        f_nyquist = 2 * self._bw
        if self._samprate is None:
            self._samprate = f_nyquist.to("MHz")
        elif self._samprate < f_nyquist:
            print(
                "Warning: specified sample rate {} < Nyquist frequency {}".format(
                    self._samprate, f_nyquist
                )
            )

    def to_RF(self):
        raise NotImplementedError()

    def to_Baseband(self):
        return self

    def to_FilterBank(self, Nsubband=512):
        """Channelize the baseband stream into a SEARCH-mode filterbank
        (a stub in the reference, signal/bb_signal.py:58-76; the JAX
        package's critically-sampled FFT filterbank,
        :func:`psrsigsim_torch.ops.channelize.channelize_power`).

        Requires data (synthesize with ``Pulsar.make_pulses`` first).
        Returns a new :class:`FilterBankSignal` on this signal's device with
        ``Nsubband`` channels, sample spacing ``2*Nsubband/samprate`` and
        the detected AA+BB intensity; the baseband signal is unchanged.
        """
        if self._state is None or self._state.data is None:
            raise ValueError(
                "no baseband data to channelize; run make_pulses first")
        from ..ops.channelize import channelize_power

        nchan = int(Nsubband)
        frame = 2 * nchan
        nsamp_in = int(self._state.data.shape[-1])
        if nsamp_in < frame:
            raise ValueError(
                f"need at least one frame of 2*Nsubband={frame} samples; "
                f"have {nsamp_in}")
        power = channelize_power(self._state.data, nchan)
        nframes = int(power.shape[1])
        samprate_in = float(self._samprate.to("MHz").value)
        # made without sample_rate (then overridden), so the full-band
        # Nyquist warning meant for user-given rates stays quiet: the
        # detected stream is critically sampled per channel by construction
        out = FilterBankSignal(
            float(self._fcent.to("MHz").value),
            float(self._bw.to("MHz").value),
            Nsubband=nchan,
            fold=False,
            dtype=np.float32,
            device=self._device,
        )
        out._samprate = make_quant(samprate_in / frame, "MHz")
        out.data = power
        out._nsamp = nframes
        # tobs covers the whole frames (a partial last frame is dropped)
        out._tobs = make_quant(nframes * frame / (samprate_in * 1e6), "s")
        # one "subint" spanning the stream (the sublen=None SEARCH
        # convention) and the source signal's flux scale
        out._nsub = 1
        out._sublen = out._tobs
        if getattr(self, "_Smax", None) is not None:
            out._Smax = self._Smax
        if self.dm is not None:
            out._dm = self.dm
        return out


class RFSignal(BaseSignal):
    """True radio-frequency sampled time series (reference:
    signal/rf_signal.py:9-87; the JAX package's ``RFSignal``).  Sampled at
    ``2·(fcent + bw/2)`` by default: a 1.4 GHz band is a ~3 GHz stream.

    Optional Args:
        device: where the data lives (``None`` = the CUDA card)
    """

    _sigtype = "RFSignal"

    def __init__(self, fcent, bandwidth, sample_rate=None, dtype=np.float32,
                 device=None):
        super().__init__(fcent, bandwidth, sample_rate=sample_rate,
                         dtype=dtype, Npols=1, device=device)
        self._Nchan = 2
        self._dat_freq = Quantity(
            np.full(self._Nchan, self._fcent.to("MHz").value), "MHz"
        )

        f_nyquist = 2 * (self._fcent + self._bw / 2)
        if self._samprate is None:
            self._samprate = f_nyquist.to("MHz")
        elif self._samprate < f_nyquist:
            print(
                "Warning: specified sample rate {} < Nyquist frequency {}".format(
                    self._samprate, f_nyquist
                )
            )

    def to_RF(self):
        return self

    def to_Baseband(self):
        raise NotImplementedError()

    def to_FilterBank(self, Nsubband=512):
        raise NotImplementedError()
