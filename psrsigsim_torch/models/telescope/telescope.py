"""Telescope: (receiver, backend) systems; observation = resample +
radiometer noise + clip/cast (counterpart:
psrsigsim_tpu/models/telescope/telescope.py).

Behavioral counterpart of psrsigsim/telescope/telescope.py, including the
reference's deliberate quirk that the resampled product is NOT written back
to the signal (the root DIVERGENCES.md #7) — noise is added at the native
rate and the resampled tensor is returned only on request, on the signal's
device.
"""

from __future__ import annotations

import numpy as np

from ...utils.constants import KB_JY_M2_PER_K
from ...utils.quantity import Quantity, make_quant
from .backend import Backend
from .receiver import Receiver

__all__ = ["Telescope", "GBT", "Arecibo"]

_kB = Quantity(KB_JY_M2_PER_K, "Jy*m^2/K")


def _clip_upper(data, clip):
    # intensity signals clip only from above (reference: telescope.py:141-144);
    # amplitude signals would clip symmetrically, but observe() raises for
    # RF/Baseband before reaching the clip, upstream and here
    return data.clamp(max=clip)


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

    def observe(self, signal, pulsar, system=None, noise=False,
                ret_resampsig=False):
        """Observe a signal: resample to the backend rate, optionally add
        radiometer noise (in place, native rate), clip and cast
        (reference: telescope.py:72-149).

        Returns the resampled tensor, on the signal's device and cast to
        the signal's dtype, only if ``ret_resampsig`` (the signal's own data
        is NOT resampled — reference parity, the root DIVERGENCES.md #7).
        """
        from ...ops.resample import block_downsample, rebin

        if signal.sigtype in ["RFSignal", "BasebandSignal"]:
            raise NotImplementedError

        rcvr, bak = self.systems[system]

        dt_tel = (1 / (2 * bak.samprate)).to("s").value
        if signal.sigtype == "FilterBankSignal" and signal.sublen is not None:
            dt_sig = (signal.sublen / (signal.nsamp / signal.nsub)).to("s").value
        else:
            dt_sig = (signal.tobs / signal.nsamp).to("s").value

        rate_msg = "sig samp freq = {0:.3f} kHz\ntel samp freq = {1:.3f} kHz".format(
            1e-3 / dt_sig, 1e-3 / dt_tel
        )
        if dt_sig != dt_tel and (dt_tel % dt_sig == 0 or dt_tel > dt_sig):
            print(rate_msg)

        # resample from the PRE-noise buffer, as the reference does
        # (telescope.py:93-127 builds `out` before the noise block); skipped
        # entirely when the caller discards it — the reference computes and
        # throws it away (the root DIVERGENCES.md #7)
        out = None
        if ret_resampsig:
            sig_in = signal.data
            if dt_sig == dt_tel:
                out = sig_in
            elif dt_tel % dt_sig == 0:
                out = block_downsample(sig_in, int(dt_tel // dt_sig))
            elif dt_tel > dt_sig:
                new_nt = int(float(signal.tobs.to("s").value) // dt_tel)
                out = rebin(sig_in, new_nt)
            else:
                # sub-rate signal: pass through (reference: telescope.py:123-126)
                out = sig_in

        if noise:
            # in-place on the signal at its native rate (reference quirk,
            # the root DIVERGENCES.md #7)
            rcvr.radiometer_noise(signal, pulsar, gain=self.gain, Tsys=self.Tsys)

        if ret_resampsig:
            import torch

            out = _clip_upper(out, float(np.float32(signal._draw_max)))
            return out.to(torch.int8 if signal.dtype == np.int8
                          else torch.float32)

    def apply_response(self, signal):
        raise NotImplementedError()

    def rfi(self):
        raise NotImplementedError()

    def init_signal(self, system):
        raise NotImplementedError()


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


def Arecibo():
    """The Arecibo 300m telescope with its NANOGrav-era systems
    (reference: telescope.py:209-239)."""
    a = Telescope(300.0, area=22000.0, Tsys=35.0, name="Arecibo")
    a.add_system(
        name="430_PUPPI",
        receiver=Receiver(fcent=430, bandwidth=100, name="430"),
        backend=Backend(samprate=1.5625, name="PUPPI"),
    )
    a.add_system(
        name="Lband_PUPPI",
        receiver=Receiver(fcent=1410, bandwidth=800, name="Lband"),
        backend=Backend(samprate=12.5, name="PUPPI"),
    )
    a.add_system(
        name="Sband_PUPPI",
        receiver=Receiver(fcent=2030, bandwidth=400, name="Sband"),
        backend=Backend(samprate=12.5, name="PUPPI"),
    )
    a.add_system(
        name="327_ASP",
        receiver=Receiver(fcent=327, bandwidth=64, name="327"),
        backend=Backend(samprate=0.25, name="ASP"),
    )
    a.add_system(
        name="430_ASP",
        receiver=Receiver(fcent=432, bandwidth=64, name="430"),
        backend=Backend(samprate=0.25, name="ASP"),
    )
    a.add_system(
        name="Lband_ASP",
        receiver=Receiver(fcent=1412, bandwidth=64, name="Lband"),
        backend=Backend(samprate=0.25, name="ASP"),
    )
    a.add_system(
        name="Sband_ASP",
        receiver=Receiver(fcent=2348, bandwidth=64, name="Sband"),
        backend=Backend(samprate=0.25, name="ASP"),
    )
    return a
