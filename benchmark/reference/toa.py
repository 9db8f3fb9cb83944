"""Plain TOA measurement and the Monte-Carlo study's priors, in float64
NumPy: FFTFIT (Taylor 1992) of each channel's folded profile against its
template, the inverse-variance combination over the band, and the uniform
and log-uniform draws of jax's ``random.uniform`` from a trial's key.
"""

from __future__ import annotations

import math

import numpy as np

from . import keys as K

UPSAMPLE = 16       # the correlation's bracketing grid, points per bin
NEWTON_STEPS = 6    # polishing steps on dC/dtau, each clipped to half a bin


def fftfit(profile, template):
    """``(shift, sigma, scale)`` of profiles ``(..., nbin)`` against
    templates (broadcasting) with every harmonic: the phase of the
    cross-correlation's maximum in turns in [-0.5, 0.5), Taylor's
    uncertainty, and the fitted amplitude."""
    prof = np.asarray(profile, np.float64)
    tmpl = np.asarray(template, np.float64)
    n = prof.shape[-1]
    half = n // 2
    P = np.fft.rfft(prof)[..., 1:half + 1]
    T = np.fft.rfft(tmpl)[..., 1:half + 1]
    absP, absT = np.broadcast_arrays(np.abs(P), np.abs(T))
    phase = np.angle(P) - np.angle(T)
    k = np.arange(1, half + 1, dtype=np.float64)
    amp = absP * absT
    full = np.zeros(phase.shape[:-1] + (UPSAMPLE * n // 2 + 1,), complex)
    full[..., 1:half + 1] = amp * np.exp(1j * phase)
    corr = np.fft.irfft(full, n=UPSAMPLE * n)
    tau = np.argmax(corr, axis=-1) / (UPSAMPLE * n)
    w = 2 * np.pi * k
    for _ in range(NEWTON_STEPS):
        ph = phase + w * tau[..., None]
        d1 = -np.sum(amp * w * np.sin(ph), axis=-1)
        d2 = -np.sum(amp * w * w * np.cos(ph), axis=-1)
        delta = np.where(d2 < 0, d1 / np.where(d2 < 0, d2, 1.0), 0.0)
        tau = tau - np.clip(delta, -0.5 / n, 0.5 / n)
    tau = np.mod(tau + 0.5, 1.0) - 0.5
    ph = phase + w * tau[..., None]
    t2 = np.sum(absT * absT, axis=-1)
    b = np.sum(amp * np.cos(ph), axis=-1) / np.maximum(t2, 1e-30)
    resid = np.sum(absP * absP, axis=-1) - b * b * t2
    sigma2 = np.maximum(resid, 0.0) / max(float(half), 1.0)
    curv = 2.0 * b * b * np.sum((w * absT) ** 2, axis=-1)
    return tau, np.sqrt(sigma2 / np.maximum(curv, 1e-30)), b


def combine(shifts, sigmas):
    """Inverse-variance mean over the last axis and its uncertainty."""
    w = 1.0 / np.maximum(sigmas, 1e-12) ** 2
    ws = np.sum(w, axis=-1)
    return np.sum(w * shifts, axis=-1) / ws, 1.0 / np.sqrt(ws)


def uniform01(k):
    """jax's float32 ``random.uniform(k, ())`` in [0, 1): the top 23 bits
    of the key's first 32-bit word as a mantissa."""
    bits = int(K.random_bits(k, 1)[..., 0])
    return float(np.array([(bits >> 9) | 0x3F800000], np.uint32)
                 .view(np.float32)[0]) - 1.0


def prior(spec, k, dtype=None):
    """One draw of a ``uniform`` or ``loguniform`` prior spec from key
    ``k``, as float32; ``dtype`` (a torch dtype) computes the map from the
    uniform draw in that precision instead (the control)."""
    u = uniform01(k)
    lo, hi = float(spec["lo"]), float(spec["hi"])
    log = spec["dist"] == "loguniform"
    if spec["dist"] not in ("uniform", "loguniform"):
        raise ValueError(f"no reference for prior {spec['dist']!r}")
    if log:
        lo, hi = math.log(lo), math.log(hi)
    lo32, hi32 = np.float32(lo), np.float32(hi)
    span = np.float32(hi32 - lo32)
    if dtype is not None:
        import torch

        v = (torch.tensor(u, dtype=dtype) * torch.tensor(float(span),
                                                         dtype=dtype)
             + torch.tensor(float(lo32), dtype=dtype))
        v = torch.exp(v) if log else v
        return np.float32(float(v))
    v = np.float32(u * float(span) + float(lo32))
    return np.float32(math.exp(v)) if log else v


def trial_params(priors, order, seed, trial, dtype=None):
    """The prior draws of trial ``trial`` of a study under ``seed``: slot
    ``s`` of ``order`` from ``fold_in(stage_key(trial key, "prior"), s)``,
    the trial key ``stage_key(key(seed), "user", trial)``."""
    tk = K.stage_key(K.key(seed), "user", trial)
    pk = K.stage_key(tk, "prior")
    return tk, {name: prior(priors[name], K.fold_in(pk, s), dtype)
                for s, name in enumerate(order)}
