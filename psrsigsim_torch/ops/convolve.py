"""Batched FFT convolution of pulse profiles with kernel arrays
(counterpart: psrsigsim_tpu/ops/convolve.py).

The reference convolves exponential scattering tails into profiles one
channel at a time through ``scipy.signal.convolve(..., method='fft')``
(psrsigsim/ism/ism.py:243-288).  Here all channels convolve in one
zero-padded batched rFFT product, on the tensors' device.
"""

from __future__ import annotations

import torch

__all__ = ["fft_convolve_full", "convolve_profiles"]


def fft_convolve_full(a, b):
    """'full'-mode linear convolution along the last axis via zero-padded
    FFT.  ``a``/``b``: ``(..., N)`` and ``(..., M)`` tensors with
    broadcastable leading axes.  Returns ``(..., N+M-1)``."""
    nfft = a.shape[-1] + b.shape[-1] - 1
    fa = torch.fft.rfft(a, n=nfft, dim=-1)
    fb = torch.fft.rfft(b, n=nfft, dim=-1)
    return torch.fft.irfft(fa * fb, n=nfft, dim=-1)


def convolve_profiles(profiles, kernels, width):
    """Convolve per-channel kernels into profiles, preserving profile flux.

    Reference semantics (ism/ism.py:265-288): normalize both operands to
    unit sum (guarding zero-sum rows), 'full' FFT convolution, truncate to
    ``width`` bins, rescale by the original profile sum.

    Args:
        profiles: ``(Nchan, Nph)`` tensor.
        kernels: ``(Nchan, M)`` tensor (typically M == Nph exponential tails).
        width: output bins, normally Nph.
    """
    psum = profiles.sum(dim=-1, keepdim=True)
    ksum = kernels.sum(dim=-1, keepdim=True)
    # sum-normalize with a zero-sum guard (divide by 1 leaves row as-is)
    pnorm = profiles / torch.where(psum == 0.0, torch.ones_like(psum), psum)
    knorm = kernels / torch.where(ksum == 0.0, torch.ones_like(ksum), ksum)
    conv = fft_convolve_full(pnorm, knorm)[..., :width]
    return psum * conv
