"""Baseband -> filterbank channelization: one batched STFT power detector
(counterpart: psrsigsim_tpu/ops/channelize.py).

The reference stubs every signal conversion (signal/bb_signal.py:58-76);
the JAX package implements the baseband -> filterbank direction as the
critically-sampled FFT filterbank real backends run: a real voltage stream
sampled at ``2*bw`` is cut into length-``2*nchan`` frames, each frame's
rFFT gives ``nchan`` sub-band samples (bins 0..nchan-1, the Nyquist bin
dropped), and the detected intensity sums ``|X|^2`` over polarizations.
The frame transforms run in fixed row groups (:mod:`.shift`), so a
frame's power does not depend on how many frames the call holds.
"""

from __future__ import annotations

import torch

from .shift import _rfft_rows

__all__ = ["channelize_power"]


def channelize_power(data, nchan):
    """Detect a real baseband stream into filterbank powers.

    Args:
        data: ``(Npol, nsamp)`` real voltage tensor at the Nyquist rate.
        nchan: number of output frequency channels (frame length
            ``2*nchan``).

    Returns:
        ``(nchan, nsamp // (2*nchan))`` float32 intensity on ``data``'s
        device, summed over polarizations (AA+BB), channel 0 at the bottom
        of the band.
    """
    npol, nsamp = data.shape
    frame = 2 * int(nchan)
    nframes = nsamp // frame
    x = data[:, :nframes * frame].reshape(npol, nframes, frame)
    spec = _rfft_rows(x.to(torch.float32))[..., :nchan]
    power = (spec.real * spec.real + spec.imag * spec.imag).sum(dim=0)
    return power.T.contiguous()
