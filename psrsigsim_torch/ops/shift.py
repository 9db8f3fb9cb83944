"""Batched frequency-domain time shifts (counterpart:
psrsigsim_tpu/ops/shift.py, ``fourier_shift`` only).

The reference shifts one channel at a time in a serial Python loop
(psrsigsim/ism/ism.py:57-60 calling utils.shift_t); here the whole
``(..., Nchan, Nsamp)`` block is shifted with batched real FFTs.  The
FFTs stay on ``torch.fft`` (cuFFT on the card), as the JAX package
leaves them to XLA rather than to a Pallas kernel.

A row's result depends on that row alone: cuFFT chooses its algorithm by
the number of rows in a call, and two algorithms round the same row apart
(on the H100, at 2048 samples a row, every row of a 512-row call against
an 8192-row one), so every call here transforms exactly
:func:`fft_group_rows` rows (the last group padded with zero rows, which
are sliced away).  The phase ramp is elementwise.  An observation's
shifted rows are then the same bits whatever batch it ran in.

All shifts are in the same physical unit as ``dt`` (canonically ms).
Positive shift delays the signal (reference sign convention).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import to_device
from .dfloat import df_mod1, df_mul_f32, df_recip, split_f64

__all__ = ["fourier_shift", "fft_group_rows"]

_TWO_PI32 = float(np.float32(2 * np.pi))

# (rows, elements) one FFT call holds at most, by device type.  On the card
# cuFFT takes another algorithm above ~1024-2048 rows of 256-2048 samples,
# whose rounding lies further from the host's (PERF.md section 5): 1024
# rows keep the small-batch algorithm.  The host's pocketfft is per row
# already; a small group keeps the zero padding of small batches cheap.
_GROUP_LIMITS = {"cuda": (1024, 1 << 21), "cpu": (1 << 16, 1 << 16)}


def fft_group_rows(n, device):
    """Rows per FFT call for rows of length ``n`` on ``device``: a function
    of ``n`` and the device type alone, never of the caller's batch."""
    rows, elements = _GROUP_LIMITS.get(torch.device(device).type,
                                       _GROUP_LIMITS["cpu"])
    return max(1, min(rows, elements // n))


def _by_groups(fn, rows, group):
    """``fn`` over the rows of the 2-D ``rows`` in calls of exactly
    ``group`` rows each."""
    out = []
    for r0 in range(0, rows.shape[0], group):
        part = rows[r0:r0 + group]
        r = part.shape[0]
        if r < group:
            part = torch.cat([part, part.new_zeros((group - r,)
                                                   + part.shape[1:])])
        out.append(fn(part)[:r])
    return out[0] if len(out) == 1 else torch.cat(out)


def _rfft_rows(data):
    n = data.shape[-1]
    spec = _by_groups(lambda p: torch.fft.rfft(p, dim=-1),
                      data.reshape(-1, n), fft_group_rows(n, data.device))
    return spec.reshape(data.shape[:-1] + spec.shape[-1:])


def _irfft_rows(spec, n):
    out = _by_groups(lambda p: torch.fft.irfft(p, n=n, dim=-1),
                     spec.reshape(-1, spec.shape[-1]),
                     fft_group_rows(n, spec.device))
    return out.reshape(spec.shape[:-1] + (n,))


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
    spec = _rfft_rows(data)
    if not isinstance(shifts, torch.Tensor) and not isinstance(dt, torch.Tensor):
        # host float64 ramp, reduced mod 1 cycle before the float32 cast
        freqs = np.fft.rfftfreq(n, d=float(dt))
        cycles = np.mod(freqs * np.asarray(shifts, np.float64)[..., None], 1.0)
        re = np.cos(2 * np.pi * cycles).astype(np.float32)
        im = (-np.sin(2 * np.pi * cycles)).astype(np.float32)
        filt = torch.complex(torch.from_numpy(re), torch.from_numpy(im))
        return _irfft_rows(spec * to_device(filt, data.device), n)

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
    return _irfft_rows(spec * phase, n)
