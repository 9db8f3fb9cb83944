"""Interstellar-medium propagation effects (counterpart:
psrsigsim_tpu/models/ism/ism.py).

Behavioral counterpart of psrsigsim/ism/ism.py.  Every per-channel serial
shift loop in the reference (disperse :57-60, FD_shift :136-139,
scatter_broaden :203-206) becomes ONE batched Fourier shift
(:func:`psrsigsim_torch.ops.shift.fourier_shift`) over the whole
``(Nchan, Nsamp)`` data tensor on the signal's device; the delays are host
float64, as in the JAX package.  Baseband signals are dispersed
coherently (:func:`psrsigsim_torch.ops.shift.coherent_dedisperse`).
"""

from __future__ import annotations

import numpy as np

from ...ops.convolve import convolve_profiles as _convolve_profiles_op
from ...ops.shift import coherent_dedisperse, fourier_shift
from ...utils.constants import DM_K, KOLMOGOROV_BETA
from ...utils.quantity import Quantity, make_quant
from ..pulsar.portraits import DataPortrait

__all__ = ["ISM", "fd_delays_ms", "scatter_delays_ms"]


def fd_delays_ms(freqs_mhz, fd_params_s):
    """Per-channel FD-polynomial delays in ms:
    ``sum_i c_i ln(f/1GHz)^(i+1)`` with coefficients in seconds
    (Arzoumanian et al. 2016; reference: ism/ism.py:100-156).

    Pure host function — the delay vector feeds the batched Fourier shift
    (either :meth:`ISM.FD_shift` or a pipeline stage)."""
    freqs_mhz = np.asarray(freqs_mhz, dtype=np.float64)
    log_ratio = np.log(freqs_mhz / 1000.0)
    delays_ms = np.zeros_like(freqs_mhz)
    for ii, c in enumerate(fd_params_s):
        delays_ms += 1e3 * float(c) * log_ratio ** (ii + 1)
    return delays_ms


def _tau_d_exponent(beta):
    """Scattering-scaling exponent (thin/thick screen branches; reference:
    ism/ism.py:340-358)."""
    if beta < 4:
        return -2.0 * beta / (beta - 2)
    if beta > 4:
        return -8.0 / (6 - beta)
    raise ValueError("beta == 4 is a degenerate scaling (reference leaves "
                     "it undefined); use beta < 4 or beta > 4")


def scatter_delays_ms(freqs_mhz, tau_d_s, ref_freq_mhz, beta=KOLMOGOROV_BETA):
    """Per-channel scatter-broadening delays in ms: tau_d scaled from
    ``ref_freq`` to each channel by the thin/thick-screen law
    (reference: ism/ism.py:158-220,340-358).  Pure host function."""
    freqs_mhz = np.asarray(freqs_mhz, dtype=np.float64)
    exp = _tau_d_exponent(beta)
    return 1e3 * float(tau_d_s) * (freqs_mhz / float(ref_freq_mhz)) ** exp


class ISM:
    """Class for modeling interstellar medium effects on pulsar signals
    (reference: ism/ism.py:12-18)."""

    def __init__(self):
        pass

    # -- dispersion --------------------------------------------------------
    def disperse(self, signal, dm):
        r"""Disperse the signal: :math:`\Delta t_{\rm DM} = k_{\rm DM}\,
        {\rm DM}/\nu^2` per channel (reference: ism/ism.py:20-38).

        Raises ValueError if the signal was already dispersed.
        """
        signal._dm = make_quant(dm, "pc/cm^3")

        if getattr(signal, "_dispersed", False):
            raise ValueError("Signal has already been dispersed!")

        if signal.sigtype == "FilterBankSignal":
            self._disperse_filterbank(signal, signal._dm)
        elif signal.sigtype == "BasebandSignal":
            self._disperse_baseband(signal, signal._dm)

        signal._dispersed = True

    def _disperse_filterbank(self, signal, dm):
        """One batched phase-ramp shift instead of the reference's serial
        per-channel loop (ism/ism.py:40-74)."""
        freq_array = signal.dat_freq
        time_delays = (DM_K * dm * np.power(freq_array, -2)).to("ms")
        signal.delay = (
            time_delays if signal.delay is None else signal.delay + time_delays
        )
        shift_dt = (1 / signal.samprate).to("ms")
        signal.data = fourier_shift(
            signal.data, time_delays.value, dt=float(shift_dt.value)
        )

    def _disperse_baseband(self, signal, dm):
        """Coherent dispersion via the L&K eq 5.21 transfer function, all
        channels in one batched FFT (reference: ism/ism.py:76-98): the
        float64 host phase of the concrete DM, the rFFT form on the
        signal's device."""
        dt_us = float((1 / signal.samprate).to("us").value)
        signal.data = coherent_dedisperse(
            signal.data,
            float(dm.value),
            float(signal.fcent.to("MHz").value),
            float(signal.bw.to("MHz").value),
            dt_us,
        )

    # -- frequency-dependent (FD) shift ------------------------------------
    def FD_shift(self, signal, FD_params):
        r"""Shift profiles by the NANOGrav FD-parameter delay polynomial
        :math:`\Delta t_{\rm FD} = \sum_i c_i \ln(\nu/1\,{\rm GHz})^i`
        (Arzoumanian et al. 2016; reference: ism/ism.py:100-156).

        FD params are in seconds; delays applied in ms.
        """
        freq_array = signal.dat_freq
        delays_ms = fd_delays_ms(
            freq_array.to("MHz").value,
            [make_quant(c, "s").to("s").value for c in FD_params],
        )
        time_delays = Quantity(delays_ms, "ms")

        signal.delay = (
            time_delays if signal.delay is None else signal.delay + time_delays
        )
        shift_dt = (1 / signal.samprate).to("ms")
        signal.data = fourier_shift(signal.data, delays_ms, dt=float(shift_dt.value))
        signal._FDshifted = True

    # -- scattering --------------------------------------------------------
    def scatter_broaden(self, signal, tau_d, ref_freq, beta=KOLMOGOROV_BETA,
                        convolve=False, pulsar=None):
        """Scatter-broadening delays, either as direct per-channel time shifts
        or by convolving exponential scattering tails into the pulse profiles
        BEFORE ``make_pulses`` (reference: ism/ism.py:158-240).

        Parameters mirror the reference: tau_d [s], ref_freq [MHz], beta
        (scaling law), convolve flag, pulsar (required when convolve=True).
        """
        freq_array = signal.dat_freq
        ref_freq = make_quant(ref_freq, "MHz")
        tau_d = make_quant(tau_d, "s").to("ms")
        tau_d_scaled = self.scale_tau_d(tau_d, ref_freq, freq_array, beta=beta)

        if not convolve:
            signal.delay = (
                tau_d_scaled if signal.delay is None else signal.delay + tau_d_scaled
            )
            shift_dt = (1 / signal.samprate).to("ms")
            signal.data = fourier_shift(
                signal.data, tau_d_scaled.value, dt=float(shift_dt.value)
            )
        else:
            nph = int((signal.samprate * pulsar.period).decompose())
            pulsar.Profiles.init_profiles(nph, signal.Nchan)
            phs = np.linspace(0.0, 1.0, nph)
            full_profs = pulsar.Profiles.calc_profiles(phs, signal.Nchan)
            # exponential scattering tails, one per channel
            t = np.linspace(0, float(pulsar.period.to("ms").value), nph)
            tails = np.exp(-t[None, :] / tau_d_scaled.value[:, None])
            convolved = self.convolve_profile(full_profs, tails, width=nph)
            pulsar._Profiles = DataPortrait(convolved)

    def convolve_profile(self, profiles, convolve_array, width=2048):
        """Flux-preserving FFT convolution of kernels into profiles
        (reference: ism/ism.py:243-288).  Returns the convolved array; does
        NOT reassign any pulsar's profiles.  Host float64."""
        profiles = np.asarray(profiles, dtype=np.float64)
        kernels = np.asarray(convolve_array, dtype=np.float64)
        psum = profiles.sum(axis=-1, keepdims=True)
        ksum = kernels.sum(axis=-1, keepdims=True)
        # sum-normalize with a zero-sum guard (divide by 1 leaves row as-is)
        pnorm = profiles / np.where(psum == 0.0, 1.0, psum)
        knorm = kernels / np.where(ksum == 0.0, 1.0, ksum)
        nfft = pnorm.shape[-1] + knorm.shape[-1] - 1
        conv = np.fft.irfft(
            np.fft.rfft(pnorm, n=nfft, axis=-1) * np.fft.rfft(knorm, n=nfft, axis=-1),
            n=nfft,
            axis=-1,
        )
        return psum * conv[..., :width]

    def convolve_profile_device(self, profiles, convolve_array, width=2048):
        """Device variant of :meth:`convolve_profile` (float32 tensors on
        their device) for ensembles with per-observation scattering."""
        return _convolve_profiles_op(profiles, convolve_array, width)

    # -- scintillation scaling laws (Michael Lam 2017; Stinebring & Condon
    #    1990 for the beta branches; reference: ism/ism.py:300-358) ---------
    @staticmethod
    def _beta_exponent(beta, thin, thick):
        if beta < 4:
            return thin(beta)
        if beta > 4:
            return thick(beta)
        raise ValueError("beta == 4 is a degenerate scaling (reference leaves "
                         "it undefined); use beta < 4 or beta > 4")

    def scale_dnu_d(self, dnu_d, nu_i, nu_f, beta=KOLMOGOROV_BETA):
        """Scintillation bandwidth scaling: dnu_d ∝ nu^(2β/(β-2)) (thin
        screen) (reference: ism/ism.py:300-318)."""
        exp = self._beta_exponent(
            beta, lambda b: 2.0 * b / (b - 2), lambda b: 8.0 / (6 - b)
        )
        return dnu_d * (nu_f / nu_i) ** exp

    def scale_dt_d(self, dt_d, nu_i, nu_f, beta=KOLMOGOROV_BETA):
        """Scintillation timescale scaling: dt_d ∝ nu^(2/(β-2)) (thin screen)
        (reference: ism/ism.py:320-338)."""
        exp = self._beta_exponent(
            beta, lambda b: 2.0 / (b - 2), lambda b: float(b - 2) / (6 - b)
        )
        return dt_d * (nu_f / nu_i) ** exp

    def scale_tau_d(self, tau_d, nu_i, nu_f, beta=KOLMOGOROV_BETA):
        """Scattering timescale scaling: tau_d ∝ nu^(-2β/(β-2)) (thin screen)
        (reference: ism/ism.py:340-358)."""
        return tau_d * (nu_f / nu_i) ** _tau_d_exponent(beta)
