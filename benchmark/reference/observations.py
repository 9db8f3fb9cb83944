"""The reference's fold-mode observations of a configuration, from the
configuration's numbers alone: the staged geometry of each pulsar, then
one observation's float block from its key.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import fold as F

WH_MIN_DF = 50.0   # the chi-square map's validity floor (Wilson-Hilferty)


@dataclasses.dataclass
class Geometry:
    """One pulsar's fold-mode observation geometry."""

    nchan: int
    nsub: int
    nph: int
    nfold: float        # chi-square df of the pulse and the noise fields
    dt_ms: float        # sample spacing (float32 where it is per pulsar)
    freqs: np.ndarray   # float32 MHz
    portrait: np.ndarray  # (nchan, nph) float64, peak 1
    norm: float         # radiometer noise scale
    dm: float

    @property
    def nsamp(self):
        return self.nsub * self.nph

    @property
    def period_ms(self):
        return self.nph * self.dt_ms


def _norm(config, portrait, sublen_s):
    t = config["telescope"]
    return F.noise_norm(portrait, config["smean_jy"], t["tsys_k"],
                        t["area_m2"], sublen_s, config["bw_mhz"],
                        config["nchan"])


def single_pulsar(config, profile):
    """The geometry of a one-pulsar configuration with a sampled profile."""
    nph = int(config["sample_rate_mhz"] * config["period_s"] * 1e6)
    nsub = int(np.round(config["tobs_s"] / config["sublen_s"]))
    portrait = F.data_portrait(profile, nph, config["nchan"])
    return Geometry(
        nchan=config["nchan"], nsub=nsub, nph=nph,
        nfold=config["sublen_s"] / config["period_s"],
        dt_ms=1e3 / (config["sample_rate_mhz"] * 1e6),
        freqs=F.channel_freqs(config["fcent_mhz"], config["bw_mhz"],
                              config["nchan"]),
        portrait=portrait, norm=_norm(config, portrait, config["sublen_s"]),
        dm=config["dm"])


def _choose_nbin(natural, grid):
    for g in sorted(grid):
        if g >= natural:
            return g
    return max(grid)


def population(config, pulsars):
    """The geometry of each pulsar ``(period_s, smean_jy, peak, width,
    dm)`` of a population on the padded bin grid."""
    nsub = int(np.round(config["tobs_s"] / config["sublen_s"]))
    freqs = F.channel_freqs(config["fcent_mhz"], config["bw_mhz"],
                            config["nchan"])
    out = []
    for period, smean, peak, width, dm in pulsars:
        natural = int(config["sample_rate_mhz"] * period * 1e6)
        nph = _choose_nbin(natural, config["pad_nbin"])
        portrait = F.gauss_portrait(peak, width, nph, config["nchan"])
        norm = _norm(dict(config, smean_jy=smean), portrait,
                     config["sublen_s"])
        out.append(Geometry(
            nchan=config["nchan"], nsub=nsub, nph=nph,
            nfold=config["sublen_s"] / period,
            dt_ms=float(np.float32(period * 1e3 / nph)), freqs=freqs,
            portrait=portrait, norm=norm, dm=dm))
    return out


def mode(df):
    """The chi-square map of a df (the sampler's modes)."""
    if df == 1.0:
        return "chi2_1"
    if df >= WH_MIN_DF:
        return "chi2_wh"
    raise ValueError(f"df {df} is outside the sampler's modes")


def observation(geom, obs_key, device, dtype=torch.float32, mode_of=mode):
    """One observation's float block ``(nchan, nsub*nph)`` for its key:
    the portrait shifted by the DM delays, times the pulse field, plus the
    noise field times the noise scale."""
    delays = F.delays_ms(np.float32(geom.dm), geom.freqs, "cpu")
    prof = F.shift_portrait(geom.portrait, delays, geom.period_ms)
    df = float(np.float32(geom.nfold))
    m = mode_of(df)
    pulse, noise = F.fields(obs_key, (m, m), (df, df), geom.nchan,
                            geom.nsamp, device, dtype)
    return F.fold(pulse, noise, prof, geom.norm, geom.nsub, geom.nph,
                  dtype=dtype)
