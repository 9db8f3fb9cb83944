"""The envelope-shift kernel (``csrc/envelope_shift.cu``): the Fourier
shift's double-float dispersion ramp and its spectrum product in one pass.

For rows of an rFFT spectrum and one delay per row, the traced-shift
branch of :func:`~psrsigsim_torch.ops.shift.fourier_shift` multiplies each
harmonic ``k`` by ``exp(i theta)``, ``theta = -2pi frac(k shift / (n
dt))``, the ratio and the products carried in double-float32
(:mod:`.dfloat`) before the mod-1 reduction (counterpart: the traced
branch of psrsigsim_tpu/ops/shift.py's ``fourier_shift``).

* :func:`envelope_shift` — the wrapper.  CUDA tensors launch the kernel
  once (counted in ``envelope_shift.launches``; its rows in the telemetry
  counter ``shift.card_rows``); CPU tensors run
  :func:`envelope_shift_plain`.  There is no fallback from one to the
  other.
* :func:`envelope_shift_plain` — the same function in torch ops on any
  device, one rounded operation at a time; the kernel rounds the same
  operations in the same order, so its ``theta`` is this chain's bit for
  bit, and so is the product (DIVERGENCES P30).
* :func:`ramp_theta` / :func:`ramp_theta_plain` — ``theta`` alone, from
  the kernel and from the chain, for the checks that hold ``theta``
  itself to the chain's bits.

The output rows are the broadcast of the spectrum's leading axes, the
shifts' and the sample spacings'.  The shifts and spacings are expanded
to one value a row (a few bytes a row); a spectrum broadcast over leading
axes only (one portrait under a DM per observation) is read in place,
row ``r % spec_rows``, and copied out to the rows only where it is
broadcast over an inner axis.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..runtime.telemetry import count
from . import _build
from .dfloat import df_mod1, df_mul_f32, df_recip, split_f64

__all__ = ["envelope_shift", "envelope_shift_plain", "ramp_theta",
           "ramp_theta_plain"]

_TWO_PI32 = float(np.float32(2 * np.pi))


def ramp_theta_plain(shifts, dt, n, device):
    """``theta`` ``(..., n//2 + 1)`` float32 on ``device`` in torch ops:
    ``shifts`` ``(...)`` in the unit of ``dt``, ``dt`` a Python float or a
    tensor broadcastable against ``shifts[..., None]``."""
    if isinstance(dt, torch.Tensor):
        period = float(n) * dt.to(device=device, dtype=torch.float32)
        rhi, rlo = df_recip(period)
    else:
        rh, rl = split_f64(1.0 / (n * float(dt)))
        rhi = torch.full((), float(rh), dtype=torch.float32, device=device)
        rlo = torch.full((), float(rl), dtype=torch.float32, device=device)
    shifts32 = torch.as_tensor(shifts, dtype=torch.float32,
                               device=device)[..., None]
    ratio_hi, ratio_lo = df_mul_f32(shifts32, rhi, rlo)
    k = torch.arange(n // 2 + 1, dtype=torch.float32, device=device)
    chi, clo = df_mul_f32(k, ratio_hi, ratio_lo)
    return (-_TWO_PI32) * df_mod1(chi, clo)


def envelope_shift_plain(spec, shifts, dt, n):
    """The kernel's function in torch ops on ``spec``'s device: ``spec``
    ``(..., n//2 + 1)`` complex64 times ``exp(i theta)`` of
    :func:`ramp_theta_plain`, broadcast over the leading axes."""
    theta = ramp_theta_plain(shifts, dt, n, spec.device)
    return spec * torch.complex(torch.cos(theta), torch.sin(theta))


def _lib():
    lib = _build.library("envelope_shift")
    fn = lib.envelope_shift_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _shared_rows(spec_lead, lead):
    """How many spectrum rows output rows ``lead`` cycle through when the
    spectrum's leading shape ``spec_lead`` is broadcast over leading axes
    only (row ``r`` reads row ``r % spec_rows``); None where it is
    broadcast over an inner axis."""
    own = tuple(spec_lead)
    while own and own[0] == 1:
        own = own[1:]
    if own != tuple(lead[len(lead) - len(own):]):
        return None
    return int(np.prod(own, dtype=np.int64))


def _launch(spec, shifts, dt, n, dev):
    """One kernel launch: the shifted spectrum, or ``theta`` where
    ``spec`` is None."""
    nh = n // 2 + 1
    shifts = torch.as_tensor(shifts, dtype=torch.float32, device=dev)
    rhi = rlo = 0.0
    dts = None
    if isinstance(dt, torch.Tensor):
        dts = dt.to(device=dev, dtype=torch.float32)
        if dts.dim():
            if dts.shape[-1] != 1:
                raise ValueError("dt broadcasts against shifts[..., None]: its "
                                 f"last axis must be 1, got {tuple(dt.shape)}")
            dts = dts[..., 0]
    else:
        rh, rl = split_f64(1.0 / (n * float(dt)))
        rhi, rlo = float(rh), float(rl)
    spec_lead = ()   # theta alone: no spectrum read
    if spec is not None:
        if spec.dtype != torch.complex64 or spec.shape[-1] != nh:
            raise ValueError(f"spec must be (..., {nh}) complex64 for n={n}, "
                             f"got {tuple(spec.shape)} {spec.dtype}")
        spec_lead = spec.shape[:-1]
    # numpy's: torch.broadcast_shapes imports sympy at its first call
    lead = np.broadcast_shapes(shifts.shape, spec_lead,
                               () if dts is None else dts.shape)
    shifts = shifts.expand(lead).contiguous()
    if dts is not None:
        dts = dts.expand(lead).contiguous()
    out = torch.empty(lead + (nh,), device=dev,
                      dtype=torch.float32 if spec is None else torch.complex64)
    rows = out.numel() // nh
    if rows == 0:
        return out
    spec_rows = 1
    if spec is not None:
        spec_rows = _shared_rows(spec_lead, lead)
        if spec_rows is None:
            spec, spec_rows = spec.expand(lead + (nh,)), rows
        spec = spec.contiguous()
    err = _lib().envelope_shift_launch(
        None if spec is None else spec.data_ptr(), spec_rows,
        shifts.data_ptr(), None if dts is None else dts.data_ptr(), rhi, rlo,
        out.data_ptr(), int(spec is None), rows, nh, n,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"envelope_shift kernel launch failed: cudaError "
                           f"{err}")
    _build.count_launch(envelope_shift)
    count("shift.card_rows", rows)
    return out


def envelope_shift(spec, shifts, dt, n):
    """Multiply rFFT rows by the dispersion ramp of their delays.

    Args:
        spec: ``(..., n//2 + 1)`` complex64 spectrum rows (the rFFT of
            length-``n`` rows).
        shifts: delays ``(...)`` in the unit of ``dt`` (a tensor, or host
            values, moved to ``spec``'s device).
        dt: sample spacing, a Python float or a float32 tensor
            broadcastable against ``shifts[..., None]``.
        n: the rows' length in samples.

    Returns:
        The shifted spectrum, complex64, its leading axes the broadcast of
        ``spec``'s, ``shifts``' and ``dt``'s, contiguous.  CUDA tensors
        launch the kernel once on the current stream; CPU tensors run
        :func:`envelope_shift_plain`.
    """
    dev = spec.device
    if dev.type == "cpu":
        return envelope_shift_plain(spec, shifts, dt, n)
    if dev.type != "cuda":
        raise ValueError(f"envelope_shift runs on cuda or cpu tensors, not {dev}")
    return _launch(spec, shifts, dt, n, dev)


def ramp_theta(shifts, dt, n, device):
    """``theta`` ``(..., n//2 + 1)`` float32 of :func:`envelope_shift`'s
    ramp on ``device``: the kernel's on the card (one launch), the chain's
    elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return _launch(None, shifts, dt, n, dev)
    return ramp_theta_plain(shifts, dt, n, dev)


envelope_shift.launches = 0
