"""Batched frequency-domain time shifts (counterpart:
psrsigsim_tpu/ops/shift.py, ``fourier_shift`` only).

The reference shifts one channel at a time in a serial Python loop
(psrsigsim/ism/ism.py:57-60 calling utils.shift_t); here the whole
``(..., Nchan, Nsamp)`` block is shifted with one batched real FFT.  The
small FFT stays on ``torch.fft`` (cuFFT on the card), as the JAX package
leaves it to XLA rather than to a Pallas kernel.

All shifts are in the same physical unit as ``dt`` (canonically ms).
Positive shift delays the signal (reference sign convention).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import to_device
from .dfloat import df_mod1, df_mul_f32, df_recip, split_f64

__all__ = ["fourier_shift"]

_TWO_PI32 = float(np.float32(2 * np.pi))


def fourier_shift(data, shifts, dt=1.0):
    """Shift each row of ``data`` in time by ``shifts`` via the FFT shift
    theorem.

    Args:
        data: real float32 tensor ``(..., Nsamp)``.
        shifts: per-row delays broadcastable against the leading axes of
            ``data`` (e.g. ``(Nchan,)`` or ``(B, Nchan)``), same unit as
            ``dt``.  Host values (numpy / Python numbers) take the
            reference's float64 host ramp; a tensor (a per-observation DM
            computed on the device, the reference's traced shift) takes the
            double-float ramp of :mod:`.dfloat`.
        dt: sample spacing, a Python float or a float32 tensor.

    Returns:
        The shifted float32 tensor, same shape as ``data``.
    """
    n = data.shape[-1]
    spec = torch.fft.rfft(data, dim=-1)
    if not isinstance(shifts, torch.Tensor) and not isinstance(dt, torch.Tensor):
        # host float64 ramp, reduced mod 1 cycle before the float32 cast
        freqs = np.fft.rfftfreq(n, d=float(dt))
        cycles = np.mod(freqs * np.asarray(shifts, np.float64)[..., None], 1.0)
        re = np.cos(2 * np.pi * cycles).astype(np.float32)
        im = (-np.sin(2 * np.pi * cycles)).astype(np.float32)
        filt = torch.complex(torch.from_numpy(re), torch.from_numpy(im))
        return torch.fft.irfft(spec * to_device(filt, data.device), n=n, dim=-1)

    # device ramp in double-float32: the shift/period ratio and the k*ratio
    # products carry ~48 mantissa bits before the mod-1 reduction
    dev = data.device
    if isinstance(dt, torch.Tensor):
        period = float(n) * dt.to(device=dev, dtype=torch.float32)
        rhi, rlo = df_recip(period)
    else:
        rh, rl = split_f64(1.0 / (n * float(dt)))
        rhi = torch.full((), float(rh), dtype=torch.float32, device=dev)
        rlo = torch.full((), float(rl), dtype=torch.float32, device=dev)
    shifts32 = torch.as_tensor(shifts, dtype=torch.float32, device=dev)[..., None]
    ratio_hi, ratio_lo = df_mul_f32(shifts32, rhi, rlo)
    k = torch.arange(n // 2 + 1, dtype=torch.float32, device=dev)
    chi, clo = df_mul_f32(k, ratio_hi, ratio_lo)
    theta = (-_TWO_PI32) * df_mod1(chi, clo)
    phase = torch.complex(torch.cos(theta), torch.sin(theta))
    return torch.fft.irfft(spec * phase, n=n, dim=-1)
