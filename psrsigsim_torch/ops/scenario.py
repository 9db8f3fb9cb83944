"""Scenario physics: scintillation screens, RFI, pulse energies
(counterpart: psrsigsim_tpu/ops/scenario.py).

The draws behind :mod:`psrsigsim_torch.scenarios`, written out over a
batch of observations: each function takes the observations' stage keys
``(..., 2)`` (the effect's own RNG stage, staged by the caller) and one
parameter per observation, and draws every cell of the whole batch in one
vectorized threefry pass per key level — no loop over observations,
channels or subints.

Reproducibility contract (the JAX package's DIVERGENCES #18): every draw is
keyed by integers GLOBAL to the observation — scintle cell ids, global
channel ids, subint ids — so the same observation gets the same factors in
any batch.  The keys are jax's, bit for bit (:mod:`..utils.rng`); the
float arithmetic is the JAX package's as XLA's CPU backend compiles it
(``pow`` rounded from float64, ``log1p`` and ``exp`` by XLA's
polynomials, its fused multiply-adds, divisions by constants as
multiplications by the float32 reciprocal), evaluated where the keys live
(psrsigsim_torch/DIVERGENCES.md P13): host keys run the torch CPU ops
below; keys on a CUDA device launch the scenario-draws kernel
(:mod:`.scenario_draws`, K10), which gives the same bits.  There is no
knob and no fallback from one route to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.telemetry import count
from ..utils.device import to_device
from ..utils.rng import fold_in, randint
from . import scenario_draws
from .stats import _SQRT2, _from_uniform, _log1p, erf_inv, exp, fma, uniform

__all__ = ["scint_cells", "scint_gain", "rfi_levels", "pulse_energies",
           "SCINT_DNU_EXPONENT", "SCINT_DT_EXPONENT", "SP_MODES"]

# Thin-screen Kolmogorov scaling exponents (beta = 11/3): dnu_d ∝ nu^4.4,
# dt_d ∝ nu^1.2 (the JAX package's ops/scenario.py)
SCINT_DNU_EXPONENT = 4.4
SCINT_DT_EXPONENT = 1.2

#: single-pulse energy-distribution modes (the card's numbering)
SP_MODES = scenario_draws.ENERGY_MODES

# scintle cell ids are clipped into this range before the key fold
_MAX_CELL = 1 << 24

_F32 = torch.float32


def _cell_clip(x):
    """``clip(floor(x), 0, 2**24)`` as int64 cell ids."""
    return torch.clamp(torch.floor(x), 0, _MAX_CELL).to(torch.int64)


def _host(v, shape=()):
    """A float32 host tensor of ``v`` (a number or a tensor of shape
    ``shape``), a number expanded to ``shape``."""
    t = torch.as_tensor(v, dtype=_F32).to("cpu")
    return t.expand(shape) if t.dim() == 0 else t


def _powf(x, y):
    """float32 ``x ** y`` rounded from the float64 power, as XLA's CPU
    backend evaluates it (torch's and numpy's float32 ``pow`` round apart
    by an ulp now and then, enough to move a scintle cell boundary)."""
    return torch.pow(x.double(), y.double()).to(_F32)


def _recip(v):
    """float32 ``1 / v`` of a constant: XLA turns a division by a constant
    into a multiplication by it."""
    return float(np.float32(1.0) / np.float32(v))


def _scint_grid(freqs_mhz, fcent_mhz, f_lo_mhz):
    """The channel grid's part of the scintle cells, on the host: each
    channel's ``x^-3.4`` and ``x^1.2`` ``(C,)`` float32 (``x = f ·
    (1/fcent)``, the powers rounded from the float64 power) and the band
    floor's ``x_lo^-3.4`` (a float32 value; compile-time constants in the
    JAX package)."""
    x = _host(freqs_mhz) * _recip(fcent_mhz)
    a = float(np.float32(SCINT_DNU_EXPONENT - 1.0))    # 3.4
    x_lo = np.float32(np.float32(f_lo_mhz) / np.float32(fcent_mhz))
    c_lo = float(np.float32(np.float64(x_lo) ** -np.float64(np.float32(a))))
    x_pow = _powf(x, torch.tensor(-a, dtype=_F32))
    x_pow_t = _powf(
        x, torch.tensor(float(np.float32(SCINT_DT_EXPONENT)), dtype=_F32))
    return x_pow, x_pow_t, c_lo


def scint_cells(freqs_mhz, nsub, dnu_d_mhz, dt_d_s, fcent_mhz, sublen_s,
                f_lo_mhz):
    """The scintle cell ids: ``cell_f`` ``(..., C)`` (the integrated
    scintle count from the band floor, ``N(f) = (fcent/dnu) (x_lo^-3.4 -
    x^-3.4) / 3.4`` with ``x = f/fcent``) and ``cell_t`` ``(..., C, nsub)``
    (subint midpoints over the channel's timescale ``dt · x^1.2``), for one
    ``dnu_d_mhz`` and ``dt_d_s`` per leading index.  Int64 on the host.

    ``f_lo_mhz`` is the GLOBAL band floor (the fold path anchors it at
    ``fcent - bw/2``, not at the lowest channel), so the cell origin never
    depends on which channels are passed."""
    x_pow, x_pow_t, c_lo = _scint_grid(freqs_mhz, fcent_mhz, f_lo_mhz)
    dnu = torch.clamp_min(_host(dnu_d_mhz), 1e-6)
    dt = torch.clamp_min(_host(dt_d_s), 1e-6)
    a = float(np.float32(SCINT_DNU_EXPONENT - 1.0))    # 3.4
    scale = torch.full((), float(np.float32(fcent_mhz)), dtype=_F32) / dnu
    n_f = (scale[..., None] * (c_lo - x_pow)) * _recip(a)
    cell_f = _cell_clip(n_f)                           # (..., C)
    t_mid = ((torch.arange(int(nsub), dtype=_F32) + 0.5)
             * float(np.float32(sublen_s)))
    dt_c = dt[..., None] * x_pow_t
    cell_t = _cell_clip(t_mid / dt_c[..., None])       # (..., C, nsub)
    return cell_f, cell_t


# the card's copies of channel grids (the scintle powers, the global
# channel ids), made once per grid and device as ops/stats.py makes its
# tables: a chunk's launches then copy only its keys and parameters
_CARD_GRIDS = {}
_CARD_GRIDS_MAX = 64


def _card_grid(key, dev, make):
    """``make()`` (device tensors of a channel grid), cached under ``(key,
    dev)``."""
    k = (key, str(dev))
    v = _CARD_GRIDS.get(k)
    if v is None:
        if len(_CARD_GRIDS) >= _CARD_GRIDS_MAX:
            _CARD_GRIDS.clear()
        v = _CARD_GRIDS[k] = make()
    return v


def scint_gain(keys, freqs_mhz, nsub, dnu_d_mhz, dt_d_s, mod_index,
               fcent_mhz, sublen_s, f_lo_mhz=None):
    """Dynamic-spectrum scintillation gains ``(..., C, nsub)`` float32 for
    the observations' scintillation stage keys ``(..., 2)``.

    Every scintle carries one unit-mean exponential gain drawn from the key
    folded by its frequency cell, then by its time cell (so two channels in
    one scintle draw the same gain); ``mod_index`` in [0, 1] interpolates
    from no modulation to saturated: ``g = 1 + m (e - 1)``.  Parameters
    are one per leading index of ``keys`` (or scalars).  ``f_lo_mhz``: the
    GLOBAL band floor; None takes the lowest of ``freqs_mhz`` (right only
    when they are the whole band)."""
    if f_lo_mhz is None:
        f_lo_mhz = float(_host(freqs_mhz).min())
    if keys.device.type == "cuda":
        return _scint_gain_card(keys, freqs_mhz, nsub, dnu_d_mhz, dt_d_s,
                                mod_index, fcent_mhz, sublen_s, f_lo_mhz)
    keys = keys.to("cpu")
    lead = keys.shape[:-1]
    cell_f, cell_t = scint_cells(freqs_mhz, nsub, _host(dnu_d_mhz, lead),
                                 _host(dt_d_s, lead), fcent_mhz, sublen_s,
                                 f_lo_mhz)
    ukeys, inv = _cell_keys(keys.reshape(-1, 2), cell_f, cell_t)
    g = _exponential1(ukeys)[inv].reshape(cell_t.shape)
    m = torch.clamp(_host(mod_index, lead), 0.0, 1.0)
    # 1 + m (g - 1) with XLA's fused multiply-add
    return fma(m[..., None, None].expand_as(g), g - 1.0, 1.0)


def _scint_gain_card(keys, freqs_mhz, nsub, dnu_d_mhz, dt_d_s, mod_index,
                     fcent_mhz, sublen_s, f_lo_mhz):
    """:func:`scint_gain` for keys on a CUDA device: K10 folds each cell's
    key and draws its gain there, from the channel grid's powers."""
    if isinstance(freqs_mhz, torch.Tensor):
        freqs_mhz = (freqs_mhz if freqs_mhz.device.type == "cpu"
                     else freqs_mhz.cpu()).numpy()
    f = np.ascontiguousarray(freqs_mhz, np.float32)
    if f.ndim != 1:
        raise ValueError("scint_gain on the card takes one channel grid "
                         f"(C,), got {f.shape}")

    def make():
        x_pow, x_pow_t, c_lo = _scint_grid(f, fcent_mhz, f_lo_mhz)
        return to_device(torch.stack((x_pow, x_pow_t)), keys.device), c_lo

    pows, c_lo = _card_grid(("scint", f.tobytes(), float(fcent_mhz),
                             float(f_lo_mhz)), keys.device, make)
    a = float(np.float32(SCINT_DNU_EXPONENT - 1.0))    # 3.4
    return scenario_draws.scint_gains(
        keys, pows, nsub, c_lo, _recip(a), float(np.float32(fcent_mhz)),
        float(np.float32(sublen_s)), dnu_d_mhz, dt_d_s, mod_index)


def _cell_keys(keys, cell_f, cell_t):
    """The distinct keys ``fold_in(fold_in(keys[i], cell_f[i, c]),
    cell_t[i, c, s])`` for keys ``(N, 2)``, and the index of each (i, c, s)
    into them.  Channels of one scintle share their frequency cell and
    subints their time cell, so each distinct (observation, cell_f) and
    (observation, cell_f, cell_t) is folded and drawn once: the same
    draws, several times fewer threefry evaluations.  The distinct keys
    are counted as ``scenario.scint_keys`` in the timers of the span open
    on this thread."""
    cell_f = cell_f.reshape(keys.shape[0], -1).numpy()         # (N, C)
    cell_t = cell_t.reshape(cell_f.shape + (-1,)).numpy()      # (N, C, nsub)
    obs = np.arange(keys.shape[0])[:, None]
    low = (1 << 25) - 1  # cell ids are at most 2**24
    # numpy's unique: torch's (sort-based, with inverse) is ten times slower
    # on the host and pays a second's warm-up on its first call
    u1, inv1 = np.unique(obs * (low + 1) + cell_f, return_inverse=True)
    kc = fold_in(keys[torch.from_numpy(u1 >> 25)],
                 torch.from_numpy(u1 & low))
    u2, inv2 = np.unique(inv1.reshape(cell_f.shape)[..., None] * (low + 1)
                         + cell_t, return_inverse=True)
    count("scenario.scint_keys", len(u2))
    return (fold_in(kc[torch.from_numpy(u2 >> 25)], torch.from_numpy(u2 & low)),
            torch.from_numpy(inv2.reshape(cell_t.shape)))


def _exponential1(keys):
    """One ``jax.random.exponential(key, ())`` draw per key ``(..., 2)``."""
    return -_log1p(-uniform(keys, 1)[..., 0])


def rfi_levels(keys, chan_ids, nsub, imp_prob, imp_snr, nb_prob, nb_snr,
               noise_level=None):
    """RFI injection plan for the observations' RFI stage keys ``(...,
    2)``: ``(levels, mask)``, both ``(..., C, nsub)`` — float32 additive
    levels in units of the caller's mean noise level, and the bool ground
    truth (True = RFI present).

    Impulsive bursts: each subint hosts a broadband burst with probability
    ``imp_prob``, at ``imp_snr`` × one exponential energy, across every
    channel.  Narrowband tones: each GLOBAL channel id carries a persistent
    tone with probability ``nb_prob`` at ``nb_snr`` × its own exponential
    energy.  Parameters are one per leading index (or scalars).
    ``noise_level`` (one per leading index or a scalar), where given,
    multiplies the levels, in float32 after their sum."""
    if keys.device.type == "cuda":
        dev = keys.device
        if isinstance(chan_ids, torch.Tensor) and chan_ids.device == dev:
            ids = chan_ids.to(torch.int64)
        else:
            if isinstance(chan_ids, torch.Tensor):
                chan_ids = (chan_ids if chan_ids.device.type == "cpu"
                            else chan_ids.cpu()).numpy()
            host = np.ascontiguousarray(chan_ids, np.int64)
            ids = _card_grid(("chan_ids", host.tobytes()), dev,
                             lambda: to_device(torch.as_tensor(
                                 host, dtype=torch.int64), dev))
        return scenario_draws.rfi_levels(keys, ids, nsub, imp_prob, imp_snr,
                                         nb_prob, nb_snr, noise_level)
    keys = keys.to("cpu")
    lead = keys.shape[:-1]
    chan_ids = torch.as_tensor(chan_ids, dtype=torch.int64).to("cpu")
    pair = torch.arange(2, dtype=torch.int64)
    k2 = fold_in(keys[..., None, :], pair)                    # imp, nb
    # the burst selection and energy keys, one uniform stream each: the
    # exponential is -log1p(-u) of the same uniform draws
    u_imp = uniform(fold_in(k2[..., 0, None, :], pair), int(nsub))
    burst = u_imp[..., 0, :] < _host(imp_prob, lead)[..., None]
    e_s = -_log1p(-u_imp[..., 1, :])                          # (..., nsub)
    kc = fold_in(k2[..., 1, None, :], chan_ids)               # (..., C, 2)
    u_nb = uniform(fold_in(kc[..., None, :], pair), 1)[..., 0]  # (..., C, 2)
    tone = u_nb[..., 0] < _host(nb_prob, lead)[..., None]
    e_c = -_log1p(-u_nb[..., 1])
    imp_lvl = _host(imp_snr, lead)[..., None] * e_s * burst
    nb_lvl = _host(nb_snr, lead)[..., None] * e_c * tone
    levels = imp_lvl[..., None, :] + nb_lvl[..., :, None]
    mask = burst[..., None, :] | tone[..., :, None]
    if noise_level is not None:
        levels = levels * _host(noise_level, lead)[..., None, None]
    return levels, mask


def pulse_energies(keys, nsub, mode, param):
    """Per-subint energy factors ``(..., nsub)`` float32 for the
    observations' transient stage keys ``(..., 2)``; ``param`` is the
    mode's parameter, one per leading index (or a scalar):

    * ``"lognormal"``: ``exp(sigma z - sigma²/2)``, unit mean;
    * ``"powerlaw"``: unit-mean Pareto ``u^(-1/alpha) (alpha-1)/alpha``
      (alpha clipped to 1.05);
    * ``"frb"``: one uniformly drawn subint carries ``amp``, every other
      subint emits nothing."""
    if mode not in SP_MODES:
        raise ValueError(
            f"unknown single-pulse mode {mode!r}; valid modes: {SP_MODES}")
    if keys.device.type == "cuda":
        return scenario_draws.pulse_energies(keys, nsub, mode, param)
    keys = keys.to("cpu")
    lead = keys.shape[:-1]
    n = int(nsub)
    p = _host(param, lead)[..., None]
    if mode == "lognormal":
        # sigma z - sigma²/2 as XLA compiles it: sqrt(2) of the normal
        # folded into sigma, the subtraction fused
        r = _from_uniform(keys, n, erf_inv)
        s = (p * _SQRT2).expand_as(r)
        return exp(fma(s, r, -((0.5 * p) * p).expand_as(r)))
    if mode == "powerlaw":
        a = torch.clamp_min(p, 1.05)
        u = uniform(keys, n, minval=1e-7, maxval=1.0)
        return _powf(u, -1.0 / a) * (a - 1.0) / a
    j = randint(keys, n)                                      # frb
    onehot = (torch.arange(n) == j[..., None]).to(_F32)
    return p * onehot
