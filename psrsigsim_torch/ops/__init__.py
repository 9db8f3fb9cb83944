"""Device numerics of the port (counterpart: psrsigsim_tpu/ops/).

Plain functions on tensors: the random fields (:mod:`.stats`, with the
CUDA sampler kernel in :mod:`.rng_hw`), the Fourier shift (:mod:`.shift`,
on :mod:`.dfloat`), the PSRFITS quantizer (:mod:`.quantize`) and the fused
fold → quantize → pack kernel (:mod:`.fold_quantize`); plus the
host helpers the portrait layer needs (:mod:`.interp`, :mod:`.window`).
"""

from . import fold_quantize
from .interp import PchipCoeffs, pchip_eval_np, pchip_fit_np
from .quantize import clip_cast, subint_dequantize, subint_quantize, swap16
from .rng_hw import hw_chan_field, rng_field, rng_field_plain
from .shift import fourier_shift
from .stats import (chan_chi2_field, chan_normal_field, chi2_draw_norm,
                    chi2_sample, normal, sampler_backend, uniform)
from .window import offpulse_window

__all__ = [
    "PchipCoeffs",
    "pchip_fit_np",
    "pchip_eval_np",
    "clip_cast",
    "subint_quantize",
    "subint_dequantize",
    "swap16",
    "rng_field",
    "rng_field_plain",
    "hw_chan_field",
    "fold_quantize",
    "fourier_shift",
    "chan_chi2_field",
    "chan_normal_field",
    "chi2_draw_norm",
    "chi2_sample",
    "normal",
    "uniform",
    "sampler_backend",
    "offpulse_window",
]
