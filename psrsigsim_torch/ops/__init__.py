"""Device numerics of the port (counterpart: psrsigsim_tpu/ops/).

Plain functions on tensors: the random fields (:mod:`.stats`, with the
CUDA sampler kernel in :mod:`.rng_hw` and the exact-gamma kernel in
:mod:`.gamma`), the Fourier shift (:mod:`.shift`, its ramp on
:mod:`.dfloat` and, on the card, the envelope-shift kernel in
:mod:`.envelope_shift`), the PSRFITS quantizer (:mod:`.quantize`), the fused
fold → quantize → pack kernel (:mod:`.fold_quantize`), coherent
(de)dispersion (:mod:`.shift`) and the baseband channelizer
(:mod:`.channelize`), the integrity
lattice's packed-digest kernel (:mod:`.digest`), FFTFIT TOA estimation
(:mod:`.toa`), the profile convolution
(:mod:`.convolve`) and the resamplers (:mod:`.resample`); plus the host
helpers the portrait layer needs (:mod:`.interp`, :mod:`.window`, which
also hold their tensor twins); and the scenario draws (:mod:`.scenario`).
"""

from .interp import (PchipCoeffs, pchip_eval, pchip_eval_np, pchip_fit,
                     pchip_fit_np, pchip_slopes)
from .window import (fold_periods, offpulse_window, offpulse_window_indices,
                     offpulse_window_jax)

# the tensor modules load on first use: a host-only consumer of the numpy
# helpers above (the PSRFITS writer processes unpickling a pulsar's
# portrait) must not pay for importing torch
_LAZY = {
    "clip_cast": "quantize", "subint_quantize": "quantize",
    "subint_dequantize": "quantize", "swap16": "quantize",
    "rng_field": "rng_hw", "rng_field_plain": "rng_hw",
    "rng_flat_field": "rng_hw", "rng_flat_field_plain": "rng_hw",
    "hw_chan_field": "rng_hw", "fourier_shift": "shift",
    "envelope_shift_plain": "envelope_shift",
    "coherent_dedisperse": "shift",
    "coherent_dedispersion_transfer": "shift",
    "channelize_power": "channelize",
    "flat_normal_field": "stats", "flat_chi2_field": "stats",
    "chan_chi2_field": "stats", "chan_normal_field": "stats",
    "chi2_draw_norm": "stats", "chi2_sample": "stats", "normal": "stats",
    "normal_sample": "stats",
    "uniform": "stats", "sampler_backend": "stats",
    "choice": "stats", "fixed_histogram": "stats",
    "fftfit_shift": "toa", "fftfit_batch": "toa", "fftfit_combine": "toa",
    "packed_digest": "digest", "packed_digest_plain": "digest",
    "fft_convolve_full": "convolve", "convolve_profiles": "convolve",
    "block_downsample": "resample", "rebin": "resample",
    "scint_gain": "scenario", "rfi_levels": "scenario",
    "pulse_energies": "scenario",
}


def __getattr__(name):
    import importlib

    if name in ("fold_quantize", "envelope_shift"):
        # the kernel modules, named as their wrappers (``.fold_quantize``,
        # ``.envelope_shift``): importing one binds the module here anyway
        return importlib.import_module(f".{name}", __name__)
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)


__all__ = [
    "PchipCoeffs",
    "pchip_slopes",
    "pchip_fit",
    "pchip_eval",
    "pchip_fit_np",
    "pchip_eval_np",
    "clip_cast",
    "subint_quantize",
    "subint_dequantize",
    "swap16",
    "rng_field",
    "rng_field_plain",
    "rng_flat_field",
    "rng_flat_field_plain",
    "hw_chan_field",
    "fold_quantize",
    "packed_digest",
    "packed_digest_plain",
    "fourier_shift",
    "envelope_shift",
    "envelope_shift_plain",
    "coherent_dedisperse",
    "coherent_dedispersion_transfer",
    "channelize_power",
    "chan_chi2_field",
    "chan_normal_field",
    "flat_normal_field",
    "flat_chi2_field",
    "chi2_draw_norm",
    "chi2_sample",
    "normal",
    "normal_sample",
    "uniform",
    "sampler_backend",
    "choice",
    "fixed_histogram",
    "fftfit_shift",
    "fftfit_batch",
    "fftfit_combine",
    "offpulse_window",
    "offpulse_window_jax",
    "offpulse_window_indices",
    "fold_periods",
    "scint_gain",
    "rfi_levels",
    "pulse_energies",
    "fft_convolve_full",
    "convolve_profiles",
    "block_downsample",
    "rebin",
]
