"""Template-matching TOA estimation (FFTFIT), batched on tensors
(counterpart: psrsigsim_tpu/ops/toa.py).

The classic frequency-domain estimator of Taylor (1992, Phil. Trans. R.
Soc. A 341, 117): ``profile(phi) ~ b · template(phi - tau) + offset +
noise`` with ``tau`` in PHASE TURNS.  The maximum-likelihood ``tau``
maximizes

    C(tau) = sum_k |P_k| |T_k| cos(phase_k + 2 pi k tau)

over the harmonic cross-spectrum (k = 1..K).  The optimum is bracketed by
the first maximum of C on a 16x upsampled grid (a zero-padded inverse
real FFT of the cross-spectrum), then polished by 6 Newton steps on
``dC/dtau`` clipped to half a bin; amplitude and uncertainty follow
Taylor's appendix (``sigma_tau^2 = sigma_n^2 / (2 b^2 sum_k (2 pi k)^2
|T_k|^2)``).

Every leading axis is a batch axis: the Monte-Carlo study measures all
(trial, channel) profiles of a chunk in one call, the FFTs on
``torch.fft`` (cuFFT on the card, as the JAX package leaves them to XLA).
Each sum over harmonics or channels is a fixed pairwise tree of
elementwise adds (:func:`tree_sum`), so a row's bits never depend on how
many rows share the call — the study's results are the same for any
chunk size.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["fftfit_shift", "fftfit_batch", "fftfit_combine", "tree_sum",
           "scalar"]

_UPSAMPLE = 16
_NEWTON_STEPS = 6
_F32 = torch.float32
_TWO_PI32 = float(np.float32(2.0 * np.pi))


def scalar(v, device):
    """A float32 0-dim tensor on ``device``: dividing by it is a true
    division on every device (a Python-number divisor is a multiply by its
    reciprocal on CUDA tensors and a division on CPU ones).  Made by a
    fill, not a host->device copy: a copy from pageable memory waits for
    the stream and would stall the host between launches."""
    return torch.full((), float(v), dtype=_F32, device=device)


def tree_sum(x, dim=-1):
    """Sum over ``dim`` by a fixed pairwise tree of elementwise adds (the
    axis zero-padded to a power of two): the order of the additions
    depends on the axis length only, never on the other axes' sizes or on
    the device's reduction strategy."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    width = 1 << (n - 1).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while width > 1:
        width //= 2
        x = x[..., :width] + x[..., width:]
    return x[..., 0]


def fftfit_shift(profile, template, nharm=None):
    """Phase shift of ``profile`` relative to ``template`` by FFTFIT.

    Args:
        profile: folded profiles ``(..., Nbin)`` (any real dtype).
        template: noise-free templates on the same phase grid, broadcastable
            against ``profile``.
        nharm: harmonics to use (default ``Nbin // 2``, i.e. all).

    Returns:
        ``(shift, sigma, scale)``, each ``(...)`` float32: ``shift`` in
        phase turns in [-0.5, 0.5) (positive = the profile arrives later),
        ``sigma`` Taylor's uncertainty in turns, ``scale`` the fitted
        template amplitude ``b``.
    """
    prof = torch.as_tensor(profile).to(_F32)
    tmpl = torch.as_tensor(template, device=prof.device).to(_F32)
    n = prof.shape[-1]
    half = n // 2
    kmax = half if nharm is None else min(int(nharm), half)
    dev = prof.device

    # the template's spectrum is taken at its own shape (one per channel,
    # not one per profile) and broadcast after
    P = torch.fft.rfft(prof)[..., 1:half + 1]
    T = torch.fft.rfft(tmpl)[..., 1:half + 1]
    absP, absT = P.abs(), T.abs()
    phase = P.angle() - T.angle()
    absP, absT = torch.broadcast_tensors(absP, absT)
    k = torch.arange(1, half + 1, dtype=_F32, device=dev)
    sel = (k <= kmax).to(_F32)
    amp = absP * absT * sel

    # bracket: the first maximum of C on the upsampled circular grid
    full = torch.zeros(phase.shape[:-1] + (_UPSAMPLE * n // 2 + 1,),
                       dtype=torch.complex64, device=dev)
    full[..., 1:half + 1] = torch.polar(amp, phase)
    corr = torch.fft.irfft(full, n=_UPSAMPLE * n)
    del full
    m0 = torch.argmax(corr, dim=-1)
    del corr
    tau = m0.to(_F32) / scalar(_UPSAMPLE * n, dev)

    # polish: Newton on dC/dtau, moving only where the curvature says
    # "maximum here", each step clipped to half a bin
    w = _TWO_PI32 * k
    aw = amp * w
    aww = aw * w
    for _ in range(_NEWTON_STEPS):
        ph = phase + w * tau[..., None]
        d1 = -tree_sum(aw * torch.sin(ph))
        d2 = -tree_sum(aww * torch.cos(ph))
        delta = torch.where(d2 < 0, d1 / d2, torch.zeros_like(d1))
        tau = tau - torch.clamp(delta, -0.5 / n, 0.5 / n)
    tau = torch.remainder(tau + 0.5, 1.0) - 0.5

    # amplitude + uncertainty (Taylor 1992 appendix)
    ph = phase + w * tau[..., None]
    t2 = tree_sum(sel * absT * absT)
    b = tree_sum(amp * torch.cos(ph)) / torch.clamp_min(t2, 1e-30)
    resid = tree_sum(sel * absP * absP) - b * b * t2
    nharm_eff = max(float(kmax), 1.0)
    sigma2_n = torch.clamp_min(resid, 0.0) / scalar(nharm_eff, dev)
    wT = w * absT
    curv = 2.0 * b * b * tree_sum(sel * wT * wT)
    sigma = torch.sqrt(sigma2_n / torch.clamp_min(curv, 1e-30))
    return tau, sigma, b


def fftfit_combine(shifts, sigmas, dim=-1):
    """Inverse-variance combination of per-channel FFTFIT measurements:
    weights ``1/sigma^2`` (sigmas floored at 1e-12), combined uncertainty
    ``1/sqrt(sum 1/sigma^2)``.  Returns ``(shift, sigma)`` with ``dim``
    reduced (by :func:`tree_sum`)."""
    shifts = torch.as_tensor(shifts).to(_F32)
    sigmas = torch.as_tensor(sigmas, device=shifts.device).to(_F32)
    w = 1.0 / torch.clamp_min(sigmas, 1e-12) ** 2
    wsum = tree_sum(w, dim)
    comb = tree_sum(w * shifts, dim) / torch.clamp_min(wsum, 1e-30)
    return comb, 1.0 / torch.sqrt(torch.clamp_min(wsum, 1e-30))


def fftfit_batch(profiles, template, nharm=None):
    """:func:`fftfit_shift` of ``(..., Nbin)`` profiles against one
    ``(Nbin,)`` template -> ``(...)`` ``(shift, sigma, scale)``."""
    return fftfit_shift(profiles, template, nharm=nharm)
