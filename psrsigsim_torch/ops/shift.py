"""Batched frequency-domain time shifts and coherent (de)dispersion
(counterpart: psrsigsim_tpu/ops/shift.py).

The reference shifts one channel at a time in a serial Python loop
(psrsigsim/ism/ism.py:57-60 calling utils.shift_t) and disperses baseband
channels one at a time (ism.py:76-98); here the whole ``(..., Nchan,
Nsamp)`` block is filtered with batched FFTs.  The FFTs stay on
``torch.fft`` (cuFFT on the card), as the JAX package leaves them to XLA
rather than to a Pallas kernel.

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

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import to_device
from .dfloat import df_mod1, df_mul_f32_fused, split_f64
from .envelope_shift import _TWO_PI32, envelope_shift

__all__ = ["fourier_shift", "fft_group_rows",
           "coherent_dedispersion_transfer", "dedispersion_filter",
           "coherent_dedisperse", "OSPlan",
           "plan_dedisperse_os", "coherent_dedisperse_os"]

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


def _fft_rows(z, inverse=False):
    """Complex ``fft`` (``ifft`` with ``inverse``) over the last axis of
    ``z``, in fixed row groups."""
    n = z.shape[-1]
    fn = torch.fft.ifft if inverse else torch.fft.fft
    out = _by_groups(lambda p: fn(p, dim=-1), z.reshape(-1, n),
                     fft_group_rows(n, z.device))
    return out.reshape(z.shape)


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
        dt: sample spacing, a Python float or a float32 tensor
            broadcastable against ``shifts[..., None]`` (one per
            observation: shape ``(..., 1, 1)``).

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
    # products carry ~48 mantissa bits before the mod-1 reduction; on the
    # card one kernel over the broadcast rows (K11), elsewhere torch ops
    return _irfft_rows(envelope_shift(spec, shifts, dt, n), n)


_DM_K_S = 1.0 / 2.41e-4  # s MHz^2 cm^3 / pc


@functools.lru_cache(maxsize=4)
def _cycle_planes(nsamp, fcent_mhz, bw_mhz, dt_us, device):
    """The per-bin cycles per unit DM, ``c(f) = k_DM f² / ((f + f0) f0²)``
    in float64 on the host, as (hi, lo) float32 planes on ``device``.  A
    function of the band geometry alone, which the reference folds into
    its compiled program once; kept here for the last few geometries (at
    config 3's 2^23-point blocks the host arithmetic takes ~0.1 s, more
    than the batch's device work).  Callers must not write into them."""
    f = np.fft.rfftfreq(nsamp, d=dt_us) - bw_mhz / 2.0
    c = 1.0e6 * _DM_K_S * f**2 / ((f + fcent_mhz) * fcent_mhz**2)
    return tuple(to_device(torch.from_numpy(p), device) for p in split_f64(c))


def coherent_dedispersion_transfer(nsamp, dm, fcent_mhz, bw_mhz, dt_us):
    """Transfer function H(f) for coherent (de)dispersion of a baseband
    signal (reference: ``coherent_dedispersion_transfer``; Lorimer & Kramer
    2006 eq. 5.21 as psrsigsim/ism/ism.py:76-98 applies it):
    ``H = exp(+i 2π k_DM DM f² / ((f + f0) f0²))`` with ``f`` the baseband
    offset in ``[-bw/2, +bw/2]`` MHz and ``f0`` the band centre in MHz.

    Returns ``(re, im)`` planes of the rFFT-layout transfer function, each
    ``(..., nsamp//2 + 1)`` float32, by the type of ``dm``:

    * a Python number (or 0-d numpy value): the phase in float64 on the
      host, reduced mod 2π, numpy float32 planes — the reference's
      concrete-DM branch, bit for bit;
    * a tensor (one DM per observation, the reference's traced DM): the
      per-bin cycle coefficients in host float64, split into (hi, lo)
      float32 planes, multiplied by the DM in double-float arithmetic
      (:mod:`.dfloat`, the product's low term fused as XLA compiles it:
      the cycles are the reference's bits) and reduced mod 1 before the
      trig — tensors on the DM's device, one row per DM;
    * a tensor band geometry (``fcent_mhz``, ``bw_mhz`` or ``dt_us``): the
      plain float32 phase (the reference's fully traced branch, ~1e-2 rad
      for MSP-scale phases).
    """
    geometry = (fcent_mhz, bw_mhz, dt_us)
    tensor_geometry = any(isinstance(g, torch.Tensor) for g in geometry)
    if (not isinstance(dm, torch.Tensor) and np.ndim(dm) == 0
            and not tensor_geometry):
        f = np.fft.rfftfreq(nsamp, d=dt_us) - bw_mhz / 2.0
        phase = np.mod(
            2.0e6 * np.pi * _DM_K_S * dm * f**2
            / ((f + fcent_mhz) * fcent_mhz**2), 2 * np.pi)
        return np.cos(phase).astype(np.float32), np.sin(phase).astype(np.float32)

    if not tensor_geometry:
        dm = torch.as_tensor(dm, dtype=torch.float32)
        c_hi, c_lo = _cycle_planes(int(nsamp), float(fcent_mhz),
                                   float(bw_mhz), float(dt_us), dm.device)
        chi, clo = df_mul_f32_fused(dm[..., None], c_hi, c_lo)
        phase = (_TWO_PI32 * df_mod1(chi, clo)).double()
        # float64 trig rounded to float32: the same planes on the card and
        # the host, within 1 ulp of XLA's float32 cos/sin (DIVERGENCES P16)
        return torch.cos(phase).float(), torch.sin(phase).float()

    # a band geometry given as tensors: plain float32
    dev = next(g.device for g in (dm,) + geometry
               if isinstance(g, torch.Tensor))

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    dm, fcent, bw, dt = f32(dm), f32(fcent_mhz), f32(bw_mhz), f32(dt_us)
    k = torch.arange(nsamp // 2 + 1, dtype=torch.float32, device=dev)
    u = k / (dt[..., None] * float(nsamp))
    f = u - bw[..., None] / 2.0
    phase = ((2.0e6 * np.pi * _DM_K_S) * dm[..., None]) * (f * f) / (
        (f + fcent[..., None]) * (fcent * fcent)[..., None])
    return torch.cos(phase), torch.sin(phase)


def _dedisperse_packed(rows, re, im):
    """Filter real streams ``(..., R, n)`` (``n`` even) with the
    real-output transfer function of the rFFT-layout planes ``re``/``im``
    ``(..., n//2 + 1)`` by complex pair packing (reference:
    ``_dedisperse_packed``): streams ``2j`` and ``2j + 1`` of each leading
    index become ``z = x0 + i x1`` (an odd ``R`` gets a zero stream), one
    complex FFT pair filters both, and the pair is ``re(w)``, ``im(w)``.

    The full-grid H is the Hermitian extension of the planes with H
    forced REAL at the DC and Nyquist bins, which is what ``irfft(spec *
    H)`` does implicitly; imaginary parts kept there would leak a
    ~2/sqrt(n) cross term between the packed streams."""
    n = rows.shape[-1]
    r = rows.shape[-2]
    if r % 2:
        rows = torch.cat([rows, rows.new_zeros(rows.shape[:-2] + (1, n))],
                         dim=-2)
    z = torch.complex(rows[..., 0::2, :], rows[..., 1::2, :])
    zero = im.new_zeros(im.shape[:-1] + (1,))
    re_f = torch.cat([re, re[..., 1:-1].flip(-1)], dim=-1)
    im_f = torch.cat([zero, im[..., 1:-1], zero, -im[..., 1:-1].flip(-1)],
                     dim=-1)
    h = torch.complex(re_f, im_f)[..., None, :]
    w = _fft_rows(_fft_rows(z) * h, inverse=True)
    y = torch.stack([w.real, w.imag], dim=-2)   # (..., pairs, 2, n)
    return y.reshape(y.shape[:-3] + (-1, n))[..., :r, :]


def dedispersion_filter(nsamp, dm, fcent_mhz, bw_mhz, dt_us, device):
    """The transfer function of a host DM (a Python number) as one
    complex64 tensor on ``device``: the host float64 planes
    :func:`coherent_dedisperse` multiplies such a DM's spectrum by.  A
    caller that filters many streams of one length builds it once (the
    reference's compiled program folds it once)."""
    re, im = coherent_dedispersion_transfer(nsamp, dm, fcent_mhz, bw_mhz,
                                            dt_us)
    h = torch.complex(torch.from_numpy(re), torch.from_numpy(im))
    return to_device(h, device)


def coherent_dedisperse(data, dm, fcent_mhz, bw_mhz, dt_us, filt=None):
    """Apply the coherent dispersion transfer function to ``(..., Nsamp)``
    float32 data (reference: ``coherent_dedisperse``), all streams in
    batched FFTs in fixed row groups.

    A host DM (a Python number: the object-oriented path) takes the host
    float64 planes and the rFFT form; ``filt`` gives those planes built
    already (:func:`dedispersion_filter` for this length and DM).  A DM
    tensor takes the double-float planes, one row per DM: ``data``'s leading axes start with the DM's,
    and for even ``Nsamp`` pairs of each observation's streams are packed
    into complex streams (:func:`_dedisperse_packed`, the reference's
    in-graph form), else the rFFT form.
    """
    n = data.shape[-1]
    host_dm = not isinstance(dm, torch.Tensor) and np.ndim(dm) == 0
    if filt is None and host_dm and not any(
            isinstance(g, torch.Tensor) for g in (fcent_mhz, bw_mhz, dt_us)):
        filt = dedispersion_filter(n, dm, fcent_mhz, bw_mhz, dt_us,
                                   data.device)
    if filt is not None:
        return _irfft_rows(_rfft_rows(data) * filt, n)
    if isinstance(dm, torch.Tensor):
        dm = to_device(dm, data.device)
    elif not host_dm:
        dm = torch.as_tensor(np.asarray(dm, np.float32), device=data.device)
    re, im = coherent_dedispersion_transfer(n, dm, fcent_mhz, bw_mhz, dt_us)
    rows = data.reshape(re.shape[:-1] + (-1, n))
    if n % 2 == 0:
        out = _dedisperse_packed(rows, re, im)
    else:
        out = _irfft_rows(_rfft_rows(rows)
                          * torch.complex(re, im)[..., None, :], n)
    return out.reshape(data.shape)


class OSPlan(NamedTuple):
    """Static overlap-save decomposition (see :func:`plan_dedisperse_os`)."""

    block: int  # pow2 FFT length per extended block
    hl: int     # left (causal) halo discarded per block
    hr: int     # right halo discarded per block
    L: int      # usable samples per block
    nb: int     # number of blocks


def plan_dedisperse_os(nsamp, dm_max, fcent_mhz, bw_mhz, dt_us,
                       min_margin=1.5):
    """Plan a pow2-block overlap-save decomposition of a length-``nsamp``
    circular coherent (de)dispersion (reference: ``plan_dedisperse_os``,
    host arithmetic copied as it is).

    The JAX package plans it for the TPU's FFT, fast only at powers of two;
    the plan changes the result (the halos truncate the impulse response),
    so the port computes the same function.  Blocks are the smallest pow2
    fitting ``min_margin`` dispersion sweeps per side, with all pow2 slack
    returned to the halos.  Returns ``None`` when blocking is pointless
    (``nsamp`` already pow2, sweep too large, or no plan beats the
    monolithic FFT), else an :class:`OSPlan`.
    """
    if nsamp & (nsamp - 1) == 0:
        return None  # already a fast length
    f_lo = fcent_mhz - bw_mhz / 2.0
    f_hi = fcent_mhz + bw_mhz / 2.0
    sweep = int(np.ceil(
        _DM_K_S * abs(float(dm_max)) * (f_lo**-2 - f_hi**-2) * 1e6 / dt_us
    )) + 1

    def _pow2(x):
        return 1 << int(np.ceil(np.log2(max(2, x))))

    best = None
    for nb in (1, 2, 3, 4, 6, 8):
        L = -(-nsamp // nb)
        block = _pow2(L + 2 * int(min_margin * sweep))
        halo = block - L
        if halo // 2 < min_margin * sweep or (halo - halo // 2) > nsamp:
            # halos must fit the sweep and a single circular wrap
            continue
        work = nb * block * np.log2(block)
        if best is None or work < best[0]:
            best = (work, OSPlan(block=block, hl=halo // 2,
                                 hr=halo - halo // 2, L=L, nb=nb))
    return None if best is None else best[1]


def coherent_dedisperse_os(data, dm, fcent_mhz, bw_mhz, dt_us, plan):
    """Overlap-save circular coherent (de)dispersion with pow2 block FFTs
    (reference: ``coherent_dedisperse_os``): block ``i`` covers the global
    circular samples ``[i·L - hl, i·L + block - hl)``, fetched from a
    doubled copy so the wrap-around agrees with the full-length circular
    filter; each block goes through :func:`coherent_dedisperse` and keeps
    its ``L`` samples after the left halo."""
    n = data.shape[-1]
    block, hl, hr, L, nb = plan
    xx = torch.cat([data[..., n - hl:], data, data, data[..., :hr]], dim=-1)
    exts = torch.stack([xx[..., i * L:i * L + block] for i in range(nb)],
                       dim=-2)                            # (..., nb, block)
    y = coherent_dedisperse(exts, dm, fcent_mhz, bw_mhz, dt_us)
    y = y[..., hl:hl + L]
    return y.reshape(y.shape[:-2] + (nb * L,))[..., :n]
