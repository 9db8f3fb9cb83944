"""Plain scenario factors of one fold-mode observation: scintillation
gains, RFI levels with their ground-truth mask, and single-pulse energies,
applied to the observation's fold before the quantizer.

Written from the scenario engine's published description (the program's
``ops/scenario.py`` docstrings and its DIVERGENCES entry P13), one
observation at a time, every (channel, subint) cell drawn from its own
key: no cell is shared or de-duplicated.

* Keys: ``stage_key(obs_key, stage, 0)`` with the stages ``scint``,
  ``rfi`` and ``transient`` (:mod:`.keys`).
* Scintillation: the scintle cell of channel ``c`` and subint ``s`` is
  ``(cell_f[c], cell_t[c, s])``, with ``N(f) = (fcent/dnu) (x_lo^-3.4 -
  x^-3.4) / 3.4``, ``x = f/fcent`` and ``x_lo`` at the band floor ``fcent -
  bw/2``, and ``cell_t`` the subint midpoint over ``dt · x^1.2``.  Its key
  is ``fold_in(fold_in(k_scint, cell_f[c]), cell_t[c, s])``, its gain one
  unit-mean exponential ``e``, applied as ``g = 1 + m (e - 1)``.
* RFI: ``k_imp, k_nb = fold_in(k_rfi, 0), fold_in(k_rfi, 1)``.  Subint
  ``s`` holds a broadband burst where word ``s`` of ``fold_in(k_imp, 0)``
  gives a uniform below ``imp_prob``, of level ``imp_snr`` times the
  exponential of word ``s`` of ``fold_in(k_imp, 1)``.  Channel ``c``
  (global id) holds a tone where the first word of ``fold_in(fold_in(k_nb,
  c), 0)`` gives a uniform below ``nb_prob``, of level ``nb_snr`` times the
  exponential of ``fold_in(fold_in(k_nb, c), 1)``'s.  Levels are in units
  of the mean noise level ``noise_df · noise_norm``; the mask is burst or
  tone.
* Single-pulse energies (log-normal): ``exp(sigma z - sigma²/2)`` with
  ``z`` the normal of word ``s`` of ``k_transient``.
* jax.random's draws: a uniform in [0, 1) is the top 23 bits of a word
  over ``2**23``; a normal is ``sqrt(2) erfinv(u)`` with ``u`` the same
  bits mapped onto (-1, 1) (``2 u01 + nextafter(-1, 0)``); an exponential
  is ``-log1p(-u)``.
* The fold: ``pulse · prof · gain · energy + noise · norm + level``, one
  rounding per operation in the reference's precision, then
  :func:`.fold.quantize`.

Departures from the program's arithmetic:

* The scintle cell ids are integers, so one ulp at a cell boundary moves a
  whole cell: they are computed with P13's float32 roundings (``x = f ·
  (1/fcent)`` with the float32 reciprocal, the powers rounded from the
  float64 power, the band floor's power and ``N(f)`` in float32, then
  floor and clip to ``2**24``), as the program computes them.
* Every other quantity (exponentials, normals, ``1 + m (e - 1)``, the
  energy's exponent and ``exp``, the RFI sums and their scaling by the
  noise level) is computed in float64 and rounded once, to the fold's
  precision; the program rounds each step to float32, uses XLA's float32
  ``log1p``, ``exp`` and ``erfinv`` polynomials and fused multiply-adds,
  and takes its noise scale in float32.
* The uniforms and the RFI comparisons are exact in both: the uniform is a
  float32 value either way, and the knobs are compared as float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import fold as F
from . import keys as K
from . import observations as O

# thin-screen Kolmogorov scalings: dnu_d ∝ nu^4.4, dt_d ∝ nu^1.2
DNU_EXPONENT = 4.4
DT_EXPONENT = 1.2
MAX_CELL = 1 << 24
STAGES = {"scintillation": "scint", "rfi": "rfi", "single_pulse": "transient"}

_F32 = np.float32
_NORMAL_LO = float(np.nextafter(_F32(-1.0), _F32(0.0)))


@dataclasses.dataclass
class Factors:
    """One observation's factors, None where the effect is off: ``gain``
    and ``level`` ``(C, nsub)``, ``energy`` ``(nsub,)``, float64; ``mask``
    ``(C, nsub)`` bool."""

    gain: torch.Tensor | None
    energy: torch.Tensor | None
    level: torch.Tensor | None
    mask: torch.Tensor | None


def _u01(words):
    """jax's float32 uniform in [0, 1) of 32-bit words, as float64."""
    return (words >> 9).to(torch.float64) * 2.0 ** -23


def _exponential(words):
    return -torch.log1p(-_u01(words))


def _normal(words):
    u = torch.clamp_min(2.0 * _u01(words) + _NORMAL_LO, _NORMAL_LO)
    return np.sqrt(2.0) * torch.erfinv(u)


def _word(k):
    """The first random word of each key ``(..., 2)``: ``(...)``."""
    return K.random_bits(k, 1)[..., 0]


def scint_cells(freqs, nsub, dnu_d_mhz, dt_d_s, fcent_mhz, bw_mhz,
                sublen_s):
    """``(cell_f (C,), cell_t (C, nsub))`` int64 scintle cell ids, in
    P13's float32 roundings."""
    f = np.asarray(freqs, _F32)
    fc = _F32(fcent_mhz)
    x = f * (_F32(1.0) / fc)
    a = _F32(DNU_EXPONENT - 1.0)
    x_lo = _F32(_F32(fcent_mhz - bw_mhz / 2) / fc)
    c_lo = _F32(np.float64(x_lo) ** -np.float64(a))
    x_pow = (x.astype(np.float64) ** np.float64(-a)).astype(_F32)
    scale = fc / max(_F32(dnu_d_mhz), _F32(1e-6))
    n_f = (scale * (c_lo - x_pow)) * (_F32(1.0) / a)
    t_mid = (np.arange(nsub, dtype=_F32) + _F32(0.5)) * _F32(sublen_s)
    b = np.float64(_F32(DT_EXPONENT))
    dt_c = max(_F32(dt_d_s), _F32(1e-6)) * (
        x.astype(np.float64) ** b).astype(_F32)
    n_t = t_mid[None, :] / dt_c[:, None]

    def cell(v):
        return torch.from_numpy(np.clip(np.floor(v), 0, MAX_CELL)
                                .astype(np.int64))

    return cell(n_f), cell(n_t)


def scint_gain(k, knobs, freqs, nsub, fcent_mhz, bw_mhz, sublen_s):
    """Gains ``(C, nsub)`` float64 for the scintillation stage key ``k``."""
    cell_f, cell_t = scint_cells(freqs, nsub, knobs["scint_dnu_d_mhz"],
                                 knobs["scint_dt_d_s"], fcent_mhz, bw_mhz,
                                 sublen_s)
    kf = K.fold_in(k, cell_f)                          # (C, 2)
    kt = K.fold_in(kf[:, None, :], cell_t)             # (C, nsub, 2)
    e = _exponential(_word(kt))
    m = min(max(float(_F32(knobs["scint_mod"])), 0.0), 1.0)
    return 1.0 + m * (e - 1.0)


def rfi_levels(k, knobs, chan_ids, nsub):
    """``(levels (C, nsub) float64 in noise units, mask (C, nsub) bool)``
    for the RFI stage key ``k``."""
    k_imp, k_nb = K.fold_in(k, 0), K.fold_in(k, 1)
    sel = _u01(K.random_bits(K.fold_in(k_imp, 0), nsub))
    e_s = _exponential(K.random_bits(K.fold_in(k_imp, 1), nsub))
    burst = sel < float(_F32(knobs["rfi_imp_prob"]))
    kc = K.fold_in(k_nb, torch.as_tensor(chan_ids, dtype=torch.int64))
    tone = _u01(_word(K.fold_in(kc, 0))) < float(_F32(knobs["rfi_nb_prob"]))
    e_c = _exponential(_word(K.fold_in(kc, 1)))
    imp = float(_F32(knobs["rfi_imp_snr"])) * e_s * burst
    nb = float(_F32(knobs["rfi_nb_snr"])) * e_c * tone
    return imp[None, :] + nb[:, None], burst[None, :] | tone[:, None]


def pulse_energies(k, knobs, nsub, mode):
    """Per-subint energies ``(nsub,)`` float64 for the transient stage key
    ``k`` (the log-normal mode)."""
    if mode != "lognormal":
        raise ValueError(f"the reference draws the lognormal mode only, "
                         f"not {mode!r}")
    sigma = float(_F32(knobs["sp_sigma"]))
    z = _normal(K.random_bits(k, nsub))
    return torch.exp(sigma * z - 0.5 * sigma * sigma)


def parse(effects):
    """``[(name, mode)]`` of effect labels ``name`` or ``name:mode``."""
    out = []
    for label in effects:
        name, _, mode = label.partition(":")
        if name not in STAGES:
            raise ValueError(f"unknown effect {name!r}")
        out.append((name, mode or ("lognormal" if name == "single_pulse"
                                   else "")))
    return out


def factors(obs_key, effects, knobs, *, freqs, nsub, fcent_mhz, bw_mhz,
            sublen_s, noise_level):
    """The :class:`Factors` of the observation with key ``obs_key``:
    ``effects`` are effect labels, ``knobs`` its parameter values,
    ``noise_level`` the mean noise level ``noise_df · noise_norm`` the RFI
    levels are scaled by."""
    gain = energy = level = mask = None
    nchan = len(freqs)
    for name, mode in parse(effects):
        k = K.stage_key(obs_key, STAGES[name], 0)
        if name == "scintillation":
            gain = scint_gain(k, knobs, freqs, nsub, fcent_mhz, bw_mhz,
                              sublen_s)
        elif name == "rfi":
            level, mask = rfi_levels(k, knobs, torch.arange(nchan), nsub)
            level = level * float(noise_level)
        else:
            energy = pulse_energies(k, knobs, nsub, mode)
    return Factors(gain, energy, level, mask)


def fold(pulse, noise, prof, norm, fac, nsub, nph, dtype=torch.float32):
    """``pulse · prof · gain · energy + noise · norm + level`` ``(nchan,
    nsub*nph)`` float32, each operation in ``dtype`` (the factors rounded
    to it once)."""
    c = pulse.shape[0]
    dev = pulse.device

    def cast(t):
        return t.to(dtype).to(dev)

    p = torch.as_tensor(prof, device=dev).to(dtype)
    x = pulse.to(dtype).reshape(c, nsub, nph) * p[:, None, :]
    if fac.gain is not None:
        x = x * cast(fac.gain)[:, :, None]
    if fac.energy is not None:
        x = x * cast(fac.energy)[None, :, None]
    n = torch.full((), float(_F32(norm)), dtype=torch.float32,
                   device=dev).to(dtype)
    x = x + (noise.to(dtype) * n).reshape(c, nsub, nph)
    if fac.level is not None:
        x = x + cast(fac.level)[:, :, None]
    return x.reshape(c, nsub * nph).to(torch.float32)


def observation(geom, obs_key, effects, knobs, *, fcent_mhz, bw_mhz,
                sublen_s, device, dtype=torch.float32):
    """One observation with its scenario, quantized: ``(codes (nsub, C,
    nph) int16, DAT_SCL (nsub, C), DAT_OFFS (nsub, C), mask (C, nsub))``."""
    delays = F.delays_ms(np.float32(geom.dm), geom.freqs, "cpu")
    prof = F.shift_portrait(geom.portrait, delays, geom.period_ms)
    df = float(np.float32(geom.nfold))
    m = O.mode(df)
    pulse, noise = F.fields(obs_key, (m, m), (df, df), geom.nchan,
                            geom.nsamp, device, dtype)
    fac = factors(obs_key, effects, knobs, freqs=geom.freqs, nsub=geom.nsub,
                  fcent_mhz=fcent_mhz, bw_mhz=bw_mhz, sublen_s=sublen_s,
                  noise_level=df * geom.norm)
    x = fold(pulse, noise, prof, geom.norm, fac, geom.nsub, geom.nph, dtype)
    codes, scl, offs = F.quantize(x, geom.nsub, geom.nph)
    return codes, scl, offs, fac.mask
