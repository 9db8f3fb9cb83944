"""Plain fold-mode observations: the portrait, the radiometer noise scale,
the dispersion shift of the periodic portrait, the chi-square pulse and
noise fields, the fold, PSRFITS int16 quantization and the folded profile.

Straightforward PyTorch and NumPy: the portrait, noise scale and shift are
worked out in float64 on the host from the configuration, the per-sample
arithmetic in ``dtype`` (float32 for the reference; the control passes a
lower precision).  Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import keys as K
from . import philox

# delay_ms = DM_K_MS * DM / f_MHz^2 (PSRCHIVE's 1 / 2.41e-4 MHz^2 cm^3 s / pc)
DM_K_MS = 1.0 / 2.41e-4 * 1e3
# Boltzmann's constant in Jy m^2 / K
KB_JY_M2_PER_K = 1.38064852e3
_HALF_SPAN = 32767.0


def channel_freqs(fcent, bw, nchan):
    """Channel centres ``arange(fcent - bw/2, fcent + bw/2, bw/nchan)`` as
    float32 MHz."""
    return np.arange(fcent - bw / 2, fcent + bw / 2, bw / nchan).astype(
        np.float32)


def data_portrait(profile, nph, nchan):
    """A sampled profile interpolated by PCHIP (periodic) onto ``nph`` even
    phases, negatives set to 0, normalised to a peak of 1, tiled to
    ``nchan`` channels: ``(nchan, nph)`` float64."""
    from scipy.interpolate import PchipInterpolator

    y = np.clip(np.asarray(profile, np.float64), 0.0, None)
    n = y.shape[-1]
    x = np.arange(n) / n
    if y[0] != y[-1]:
        x = np.arange(n + 1) / n
        y = np.append(y, y[:1])
    with np.errstate(all="ignore"):
        prof = PchipInterpolator(x, y)(np.arange(nph) / nph)
    prof = prof / prof.max()
    return np.tile(prof, (nchan, 1))


def gauss_portrait(peak, width, nph, nchan):
    """One Gaussian component of unit amplitude on ``nph`` even phases,
    normalised to its peak on that grid, tiled: ``(nchan, nph)``."""
    ph = np.arange(nph) / nph
    prof = np.exp(-0.5 * ((ph - peak) / width) ** 2)
    return np.tile(prof / prof.max(), (nchan, 1))


def noise_norm(portrait, smean_jy, tsys_k, area_m2, sublen_s, bw_mhz, nchan):
    """The radiometer noise scale of a fold-mode observation: the
    per-sample noise sigma ``Tsys / G / sqrt(2 dt B_chan)`` in units of the
    pulse's peak flux ``Smax = Smean nph / sum(peak profile)``, over the
    profile's mean, with ``G = area / (2 k_B)``."""
    nph = portrait.shape[-1]
    peak_row = portrait[int(np.argmax(portrait.max(axis=1)))]
    gain = area_m2 / (2 * KB_JY_M2_PER_K)
    dt = sublen_s / nph
    sig = tsys_k / gain / np.sqrt(2 * dt * (bw_mhz / nchan) * 1e6)
    smax = smean_jy * nph / float(np.sum(peak_row))
    return float(sig / smax / (float(np.sum(peak_row)) / nph))


def delays_ms(dm, freqs, device):
    """Dispersion delays ``(..., nchan)`` in float32 ms for DMs ``(...)``."""
    dm = torch.as_tensor(np.asarray(dm, np.float32), device=device)
    f = torch.as_tensor(freqs, device=device)
    return (DM_K_MS * dm[..., None]) / (f * f)


def shift_portrait(portrait, delays, period_ms):
    """The periodic portrait ``(nchan, nph)`` delayed by ``delays``
    ``(..., nchan)`` ms modulo the period, by the Fourier shift theorem in
    float64: ``(..., nchan, nph)`` float32."""
    prof = np.asarray(portrait, np.float64)
    nph = prof.shape[-1]
    d = np.asarray(torch.as_tensor(delays).cpu(), np.float64)
    cycles = np.mod(np.arange(nph // 2 + 1) * (d[..., None] / period_ms), 1.0)
    spec = np.fft.rfft(prof, axis=-1) * np.exp(-2j * np.pi * cycles)
    return np.fft.irfft(spec, n=nph, axis=-1).astype(np.float32)


def fields(obs_key, modes, dfs, nchan, nsamp, device, dtype=torch.float32):
    """The pulse and noise chi-square fields of one observation key."""
    out = []
    for stage, mode, df in zip(("pulse", "noise"), modes, dfs):
        words = K.seed_words(K.stage_key(obs_key, stage)).tolist()
        out.append(philox.field(words, mode, df, nchan, nsamp,
                                device=device, dtype=dtype))
    return out


def fold(pulse, noise, prof, norm, nsub, nph, draw_norm=1.0,
         dtype=torch.float32):
    """``pulse x prof (x draw_norm) + noise x norm``: ``(nchan, nsub*nph)``
    float32, computed in ``dtype``."""
    c = pulse.shape[0]
    p = torch.as_tensor(prof, device=pulse.device).to(dtype)
    x = pulse.to(dtype).reshape(c, nsub, nph) * p[:, None, :]
    if draw_norm != 1.0:
        x = x * draw_norm
    n = torch.full((), float(np.float32(norm)), dtype=torch.float32,
                   device=pulse.device).to(dtype)
    x = x + (noise.to(dtype) * n).reshape(c, nsub, nph)
    return x.reshape(c, nsub * nph).to(torch.float32)


def quantize(x, nsub, nph):
    """PSRFITS int16 per (subint, channel): each row's [min, max] mapped
    onto [-32767, 32767] about its midpoint, round half to even.  Returns
    codes ``(nsub, nchan, nph)`` int16, DAT_SCL and DAT_OFFS ``(nsub,
    nchan)`` float32 (a constant row: scale 1, codes 0)."""
    c = x.shape[0]
    v = x.reshape(c, nsub, nph)
    lo = v.amin(dim=-1)
    hi = v.amax(dim=-1)
    span = hi - lo
    live = span > 0
    one = torch.ones_like(span)
    inv_full = float(np.float32(1.0 / (2.0 * _HALF_SPAN)))
    scl = torch.where(live, span * inv_full, one)
    offs = (hi + lo) * 0.5
    # a true division (a scalar over a tensor would take its reciprocal
    # first and round twice)
    inv = torch.where(live, torch.full_like(span, 2.0 * _HALF_SPAN) / span,
                      one)
    q = torch.round((v - offs[..., None]) * inv[..., None])
    codes = q.clamp(-_HALF_SPAN, _HALF_SPAN).to(torch.int16)
    return (codes.transpose(0, 1).contiguous(), scl.T.contiguous(),
            offs.T.contiguous())


def fold_subints(x, nsub, nph):
    """The folded profile ``(nchan, nph)``: subints added in order."""
    v = x.reshape(x.shape[0], nsub, nph)
    out = v[:, 0]
    for s in range(1, nsub):
        out = out + v[:, s]
    return out
