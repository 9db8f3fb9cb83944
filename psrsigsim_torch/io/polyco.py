"""Polyco generation for PSRFITS phase connection — PINT replacement.

The reference delegates to ``pint.polycos`` with a TEMPO-style fit over
the full timing model — binary orbit, astrometry, dispersion variation
included (reference: io/psrfits.py:116-181).  Here the same thing is done
natively: :class:`psrsigsim_torch.io.timing.TimingModel` evaluates absolute
phase (spin + solar-system barycentering + binary delays + DM/DMX/FD) on
a Chebyshev node grid across the span, and the TEMPO polyco coefficient
convention

    phi(t) = REF_PHS + 60*REF_F0*dt_min + COEFF[0] + COEFF[1]*dt_min + ...

is least-squares fitted to it.  The fit reproduces the model's own phase
to < 1e-6 cycles over the span (asserted by tests/test_timing.py); the
model's absolute accuracy against a JPL-ephemeris fit is set by the
analytic ephemeris (see :mod:`psrsigsim_torch.io.ephem`).

Models with terms that cannot be honored (unknown time-unit systems,
unknown binary models or site codes, malformed glitch groups) raise
:class:`UnsupportedTimingModelError` under ``strict=True`` rather than
mispredicting silently.  ``UNITS TCB`` par files are accepted: the
timing model converts them to TDB with the IAU scaling at construction
(:func:`psrsigsim_torch.io.timing.tcb_to_tdb_params`).
"""

from __future__ import annotations

import os
import warnings

import numpy as np

from .timing import (TimingModel, UnsupportedTimingModelError,
                     check_model_supported, parse_par_full)

__all__ = ["parse_par", "generate_polyco", "generate_polycos",
           "polyco_phase", "UnsupportedTimingModelError",
           "check_par_supported"]

# (par fingerprint, fit args) -> polyco dict; see generate_polyco
_POLYCO_CACHE = {}


def check_par_supported(params, parfile="<par>"):
    """Raise :class:`UnsupportedTimingModelError` if ``params`` holds
    terms the numeric polyco fit cannot honor.  The numeric timing model
    covers binary, astrometric and DM-variation terms, glitches and FB
    series, and converts TCB units to TDB, so only unknown unit systems,
    unknown binary models, malformed glitch groups, and unknown site
    codes remain unsupported."""
    check_model_supported(params, parfile=parfile)


def parse_par(parfile):
    """Parse a TEMPO/PINT-style .par file into a dict of strings/floats.

    Alias for :func:`psrsigsim_torch.io.timing.parse_par_full`: flag-style
    values stay strings, numeric values become floats (longdouble for
    epoch keys), repeated flagged lines (JUMP/T2EFAC/...) are collected
    under ``key + "#"``.
    """
    return parse_par_full(parfile)


def generate_polyco(parfile, MJD_start, segLength=60.0, ncoeff=15,
                    strict=True, obs_freq=None, site=None):
    """Numeric TEMPO-style polyco fit over the full timing model.

    Evaluates :class:`~psrsigsim_torch.io.timing.TimingModel` absolute phase
    (spin + barycentric Roemer/parallax/Shapiro + binary + DM/DMX/FD) on
    Chebyshev nodes across the span and least-squares fits the TEMPO
    coefficient form — the same construction the reference obtains from
    ``pint.polycos`` (reference: io/psrfits.py:116-181).

    Args:
        parfile: path to the .par file.
        MJD_start: start MJD (UTC for topocentric sites; TDB for '@').
        segLength: span length in minutes (NSPAN).
        ncoeff: number of coefficients (NCOEF).
        strict: when True (default), raise
            :class:`UnsupportedTimingModelError` for model terms that
            cannot be honored (unknown unit systems, unknown binary
            models/site codes, malformed glitch groups).
            ``strict=False`` ignores them.  TCB par files are honored
            (converted to TDB at model construction).
        obs_freq: observing frequency in MHz for the dispersion terms
            (default: the par file's TZRFRQ).
        site: TEMPO observatory code the polyco is computed for
            (default: the par file's TZRSITE).

    Returns:
        dict with the keys the PSRFITS POLYCO table wants: NSPAN, NCOEF,
        REF_FREQ, NSITE, REF_F0, COEFF, REF_MJD, REF_PHS — mirroring the
        reference's polyco_dict (io/psrfits.py:144-177).
    """
    # bulk exports fit the same polyco for thousands of files; memoize on
    # the par file's identity (path + mtime + size) and the fit arguments
    try:
        st = os.stat(parfile)
        cache_key = (os.path.realpath(parfile), st.st_mtime_ns, st.st_size,
                     float(MJD_start), float(segLength), int(ncoeff),
                     bool(strict),
                     None if obs_freq is None else float(obs_freq),
                     None if site is None else str(site))
    except OSError:
        cache_key = None
    if cache_key is not None and cache_key in _POLYCO_CACHE:
        hit = _POLYCO_CACHE[cache_key]
        return {**hit, "COEFF": hit["COEFF"].copy()}

    model = TimingModel.from_par(parfile, strict=strict)
    f0 = float(model.f_terms[0])
    if site is None:
        site = model.tzrsite
    if obs_freq is None:
        obs_freq = model.tzrfrq
    # no frequency anywhere -> phases are infinite-frequency (no
    # dispersion); REF_FREQ=0 marks that honestly instead of claiming a
    # band the fit was never computed for
    ref_freq = float(obs_freq) if obs_freq else 0.0

    half_min = segLength / 2.0
    # anchor the fit at the float64-representable midpoint: REF_MJD is
    # stored as a double in the POLYCO table, and a sub-ulp mismatch
    # between the fit anchor and the stored value leaks F0 * 3e-7 s
    # (~5e-5 cycles) of constant phase error into every prediction
    tmid = np.longdouble(np.float64(MJD_start + segLength / 2880.0))

    # Chebyshev-distributed nodes over the span (8x oversampled LSQ)
    nnodes = max(8 * ncoeff, 48)
    xnodes = np.cos(np.pi * np.arange(nnodes) / (nnodes - 1))  # [-1, 1]
    t_nodes = tmid + np.asarray(xnodes * (half_min / 1440.0),
                                np.float64).astype(np.longdouble)
    phases = model.phase(t_nodes, freq_mhz=obs_freq, site=site)
    phase_mid = model.phase(np.atleast_1d(tmid), freq_mhz=obs_freq,
                            site=site)[0]

    # subtract the TEMPO linear term and the midpoint phase in longdouble;
    # the residual is small enough for a float64 Chebyshev fit
    dt_min = np.asarray((t_nodes - tmid) * 1440.0, np.float64)
    lin = (np.longdouble(60.0 * f0) *
           (t_nodes - tmid) * np.longdouble(1440.0))
    resid = np.asarray(phases - phase_mid - lin, np.float64)

    deg = min(ncoeff - 1, nnodes - 1)
    cheb_coef = np.polynomial.chebyshev.chebfit(
        dt_min / half_min, resid, deg)
    poly_coef = np.polynomial.chebyshev.cheb2poly(cheb_coef)
    coeffs = np.zeros(ncoeff, np.float64)
    scale = np.power(half_min, -np.arange(len(poly_coef), dtype=np.float64))
    coeffs[:len(poly_coef)] = poly_coef * scale

    fit = np.polynomial.polynomial.polyval(dt_min, coeffs)
    fit_err = float(np.max(np.abs(fit - resid)))
    if fit_err > 1e-6:
        warnings.warn(
            f"polyco fit residual {fit_err:.2e} cycles exceeds 1e-6 over "
            f"a {segLength:.0f}-minute span; use a shorter segLength or "
            f"more coefficients", RuntimeWarning)

    ref_phs = np.float64(phase_mid - np.floor(phase_mid))

    result = {
        "NSPAN": segLength,
        "NCOEF": ncoeff,
        "REF_FREQ": ref_freq,
        "NSITE": str(site).encode("utf-8"),
        "REF_F0": f0,
        "COEFF": coeffs,
        "REF_MJD": np.double(tmid),
        "REF_PHS": np.double(ref_phs),
    }
    if cache_key is not None:
        if len(_POLYCO_CACHE) > 256:
            _POLYCO_CACHE.clear()
        _POLYCO_CACHE[cache_key] = {**result, "COEFF": coeffs.copy()}
    return result


def generate_polycos(parfile, MJD_start, duration_min, segLength=60.0,
                     **kwargs):
    """Polyco segments covering ``duration_min`` minutes from
    ``MJD_start``: one TEMPO-form fit per ``segLength``-minute span
    (ceil-covered, so the last segment may extend past the end).

    Observations longer than one span need a POLYCO table, not a single
    row — the folding software picks the matching segment by date.
    Returns a list of dicts as :func:`generate_polyco`.
    """
    n = max(1, int(np.ceil(float(duration_min) / float(segLength))))
    return [
        generate_polyco(parfile, MJD_start + i * segLength / 1440.0,
                        segLength=segLength, **kwargs)
        for i in range(n)
    ]


def polyco_phase(polyco, mjd):
    """Evaluate a polyco dict at an MJD (cycles relative to REF_PHS) —
    used for self-consistency tests and by downstream folding tools."""
    dt_min = (np.asarray(mjd, np.float64) - polyco["REF_MJD"]) * 1440.0
    coeffs = np.asarray(polyco["COEFF"], np.float64)
    poly = np.polynomial.polynomial.polyval(dt_min, coeffs)
    return polyco["REF_PHS"] + poly + 60.0 * polyco["REF_F0"] * dt_min
