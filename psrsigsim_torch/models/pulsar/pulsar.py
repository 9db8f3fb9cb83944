"""Pulsar: pulse-train synthesis onto a signal (counterpart:
psrsigsim_tpu/models/pulsar/pulsar.py).

Behavioral counterpart of psrsigsim/pulsar/pulsar.py.  Host code handles
config (units, shapes, profile normalization); the draws run as tensor
operations over the whole ``(Nchan, Nsamp)`` block on the signal's device,
with jax's threefry stream (``ops/stats.py``), so a seed draws the JAX
package's realization.

RNG: pass ``seed=`` for a private, reproducible key sequence, else the
package-global :data:`~psrsigsim_torch.utils.rng.default_keys` is used
(seed it with ``psrsigsim_torch.utils.set_seed``); the order of draws
across objects is the JAX package's.
"""

from __future__ import annotations

import numpy as np

from ...utils.quantity import make_quant
from .portraits import DataPortrait
from .profiles import GaussProfile

__all__ = ["Pulsar"]


def _fold_pulse_kernel(key, profiles, nsub, df, draw_norm):
    """Fold-mode synthesis: tile the portrait to nsub subints and modulate
    by χ²(df) intensity draws (reference: pulsar.py:196-221).  ``df`` is a
    Python number, so the χ² routing is by value; the JAX package jits
    this kernel with df static, and ``chi2_sample_compiled`` draws with the
    arithmetic XLA compiles for it."""
    from ...ops.stats import chi2_sample_compiled

    block = profiles.repeat(1, nsub)
    return block * chi2_sample_compiled(key, df, tuple(block.shape)) * draw_norm


def _power_draw_kernel(key, profiles, df, draw_norm):
    """Single-pulse intensity draws over an evaluated profile block
    (reference: pulsar.py:222-244, χ²(df=1))."""
    from ...ops.stats import chi2_sample_compiled

    return (profiles * chi2_sample_compiled(key, df, tuple(profiles.shape))
            * draw_norm)


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
    seed : int, optional — private reproducible key sequence
    """

    def __init__(self, period, Smean, profiles=None, name=None, specidx=0.0,
                 ref_freq=None, seed=None):
        from ...utils.rng import KeySequence, default_keys

        self._period = make_quant(period, "s")
        self._Smean = make_quant(Smean, "Jy")
        self._name = name
        self._specidx = specidx
        self._ref_freq = make_quant(ref_freq, "MHz") if ref_freq is not None else None
        self._Profiles = profiles if profiles is not None else GaussProfile()
        self._keys = KeySequence(seed) if seed is not None else default_keys

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

    # -- synthesis ---------------------------------------------------------
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

    def make_pulses(self, signal, tobs):
        """Generate pulses into ``signal`` for ``tobs`` seconds of
        observation (reference: pulsar.py:107-151).  The data tensor is
        made on ``signal.device``."""
        signal._tobs = make_quant(tobs, "s")

        if self.ref_freq is None:
            self._ref_freq = signal.fcent
        if signal.sigtype == "FilterBankSignal":
            self._add_spec_idx(signal)

        nph = self._nph(signal)
        self.Profiles.init_profiles(nph, signal.Nchan)

        if signal.sigtype in ["RFSignal", "BasebandSignal"]:
            self._make_amp_pulses(signal)
        elif signal.sigtype == "FilterBankSignal":
            self._make_pow_pulses(signal)
        else:
            raise NotImplementedError(
                "no pulse method for signal: {}".format(signal.sigtype)
            )

        # Smax feeds the radiometer noise level (reference: pulsar.py:147-151)
        pr = self.Profiles._max_profile
        nbins = len(pr)
        signal._Smax = self.Smean * nbins / float(np.sum(pr))

    def _sample_phases(self, signal):
        """Pulse phase of every sample, float64 host precision
        (reference: pulsar.py:174-176,238-240)."""
        spp = float((signal.samprate * self.period).decompose())  # samples/period
        phs = np.arange(signal.nsamp, dtype=np.float64) / spp
        return phs % 1.0

    def _make_amp_pulses(self, signal):
        """Amplitude pulses for RF/Baseband signals (reference:
        pulsar.py:153-183): the square root of the float64 host profile at
        every sample's phase, times jax's flat ``random.normal`` stream on
        the ``"pulse"`` key, on the signal's device."""
        import torch

        from ...ops.stats import normal_sample
        from ...utils.device import to_device

        signal._nsamp = int((signal.tobs * signal.samprate).decompose())
        signal.init_data(signal.nsamp)
        dev = signal.device

        phs = self._sample_phases(signal)
        full_prof = np.sqrt(self.Profiles.calc_profiles(phs, Nchan=signal.Nchan))
        amp = torch.as_tensor(np.asarray(full_prof, dtype=np.float32),
                              device=dev)
        signal.data = amp * normal_sample(
            to_device(self._keys.next("pulse"), dev), tuple(amp.shape))

    def _make_pow_pulses(self, signal):
        """Power pulses for FilterBank signals (reference: pulsar.py:185-244)."""
        import torch

        from ...utils.device import to_device

        dev = signal.device
        if signal.fold:
            if signal.sublen is None:
                signal._sublen = signal.tobs
                signal._nsub = 1
            else:
                signal._nsub = int(np.round((signal.tobs / signal.sublen).decompose()))

            # reference keeps _nsamp = int(nsub*period*samprate) even though
            # the data block is nsub*Nph wide (pulsar.py:206,219) — preserved
            signal._nsamp = int(
                (signal.nsub * (self.period * signal.samprate)).decompose()
            )

            signal._Nfold = float((signal.sublen / self.period).decompose())
            signal._set_draw_norm(df=signal.Nfold)

            profiles = self.Profiles.profiles_device(dev)
            signal.data = _fold_pulse_kernel(
                to_device(self._keys.next("pulse"), dev),
                profiles,
                signal.nsub,
                float(signal.Nfold),
                signal._draw_norm,
            )
        else:
            signal._sublen = self.period
            signal._nsub = int(np.round((signal.tobs / signal.sublen).decompose()))

            signal._Nfold = None
            signal._set_draw_norm(df=1)

            signal._nsamp = int((signal.tobs * signal.samprate).decompose())
            phs = self._sample_phases(signal)
            full_prof = self.Profiles.calc_profiles(phs, signal.Nchan)
            signal.data = _power_draw_kernel(
                to_device(self._keys.next("pulse"), dev),
                torch.as_tensor(np.asarray(full_prof, dtype=np.float32),
                                device=dev),
                1.0,
                signal._draw_norm,
            )

    # -- nulling -----------------------------------------------------------
    def null(self, signal, null_frac, length=None, frequency=None):
        """Replace a fraction of pulses with off-pulse-level noise
        (reference: pulsar.py:246-333).

        Run after ISM delays but before radiometer noise.  The pulses to
        null come from ``permutation`` (jax's, bit for bit, drawn on the
        data's device); the windows become one column mask and a ``where``
        select on the device.  Returns the indices of the nulled pulses
        (a host int64 array; None when no pulse is nulled).
        """
        import torch

        from ...ops.shift import fourier_shift
        from ...ops.stats import chi2_sample
        from ...utils.device import to_device
        from ...utils.rng import permutation

        if length is not None or frequency is not None:
            raise NotImplementedError(
                "Length and Frequency not been implimented yet"
            )

        null_pulses = int(np.round(signal.nsub * null_frac))
        if null_pulses == 0:
            return None
        nph = self._nph(signal)
        opw = self.Profiles._calcOffpulseWindow(Nphase=nph)
        df = signal.Nfold if signal.fold else 1
        if not signal.fold or signal.Nfold < 100:
            check_df = 100.0
        else:
            check_df = float(signal.Nfold)

        data = signal.data
        dev = data.device
        row0 = data[0, :nph].cpu().numpy()
        shift_val = nph // 2 - int(np.argmax(row0))
        width = data.shape[1]

        # choose pulses to null (explicit-key analog of np.random.choice)
        sel_key = self._keys.next("null_select")
        rand_pulses = permutation(to_device(sel_key, dev),
                                  signal.nsub).cpu().numpy()[:null_pulses]

        # column mask of nulled windows
        mask_row = np.zeros(width, dtype=bool)
        for p in rand_pulses:
            lo = nph * int(p) + shift_val
            bins = np.arange(lo, lo + nph)
            bins = bins[(bins >= 0) & (bins < width)]
            mask_row[bins] = True
        mask_row = torch.as_tensor(mask_row, device=dev)

        off_pulse_mean = float(np.mean(self.Profiles._max_profile[opw.astype(int)]))
        noise_key = self._keys.next("null_noise")

        if signal.delay is None:
            # same noise row across channels, as the reference's row-broadcast
            # assignment does (pulsar.py:304)
            noise_row = (chi2_sample(to_device(noise_key, dev), float(df), width)
                         * signal._draw_norm)
            signal.data = torch.where(mask_row[None, :],
                                      noise_row[None, :] * off_pulse_mean,
                                      data)
        else:
            # delayed signal: build the check array, shift it per channel with
            # the accumulated delays, then replace where it lands above 1
            check_key = self._keys.next("null_noise")
            check_row = torch.where(
                mask_row,
                chi2_sample(to_device(check_key, dev), check_df, width)
                * signal._draw_norm,
                0.0,
            )
            null_array = check_row[None, :].expand(signal.Nchan, width)
            shift_dt_ms = float((1 / signal.samprate).to("ms").value)
            delays_ms = np.asarray(
                signal.delay.to("ms").value
                if hasattr(signal.delay, "to")
                else signal.delay
            )
            shifted = fourier_shift(null_array, delays_ms, dt=shift_dt_ms)
            mask = shifted > 1
            del shifted
            noise = (chi2_sample(to_device(noise_key, dev), float(df),
                                 tuple(data.shape)) * signal._draw_norm)
            signal.data = torch.where(mask, noise * off_pulse_mean, data)
        return rand_pulses
