"""Pulsar timing model: par file -> absolute phase vs topocentric UTC.

This is the framework's replacement for the reference's use of PINT
(reference: io/psrfits.py:116-181 builds polycos from a full PINT model;
utils/utils.py:342-348 loads models).  It evaluates, for a topocentric
UTC arrival time at an observatory:

    t_ssb  = TDB(t) + Roemer + parallax - Shapiro_sun - DM(t)/2.41e-4/f^2
             - FD(f)                                     [seconds]
    t_em   = t_ssb - binary_delay(t_em)                  [iterated]
    phase  = F0*dt + F1/2*dt^2 + ... ,  dt = t_em - PEPOCH

with the phase zero-point tied to the par file's TZRMJD/TZRFRQ/TZRSITE
arrival, like TEMPO/PINT.  Supported components:

- astrometry: RAJ/DECJ or ecliptic LAMBDA/BETA (ELONG/ELAT), proper
  motion, parallax (annual curvature term);
- spin: any number of frequency derivatives F0..Fn;
- dispersion: DM + DM1/DM2 polynomial + piecewise DMX ranges + FD terms;
- binary: BT, DD, DDS, DDK, ELL1, ELL1H via an exact Kepler solve;
  orbital frequency either as PB/PBDOT or as the FB-series Taylor
  expansion FB0..FBn (the BTX-style parameterization black-widow pulsars
  are fit with — evaluated directly as orbital phase)
  (ELL1 eccentric parameters are converted to e/omega/T0, which is the
  exact form of the same orbit; DDK's Kopeikin annual-orbital-parallax
  corrections to x and omega are ~us-level and deliberately omitted);
  ELL1H Shapiro from STIG/H4, or the H3-only third-harmonic form
  (Freire & Wex 2010) when only H3 is given;
- glitches: GLEP/GLPH/GLF0/GLF1/GLF2 plus the GLF0D/GLTD decaying term.

Phase arithmetic is carried in numpy longdouble (80-bit on x86): with
|phase| ~ 1e10 cycles over a NANOGrav span the representation error is
~1e-9 cycles.  Solar-system geometry comes from the analytic ephemeris in
:mod:`psrsigsim_torch.io.ephem`; see that module's accuracy statement.
"""

from __future__ import annotations

import os
import re

import numpy as np

from ..utils.constants import _DM_K_VALUE as _DM_K  # s * MHz^2 / (pc cm^-3)
from . import ephem

__all__ = ["TimingModel", "parse_par_full", "UnsupportedTimingModelError",
           "tcb_to_tdb_params"]

_DEG = np.pi / 180.0
_SEC_PER_DAY = 86400.0
_MAS_PER_YR = _DEG / 3600.0 / 1000.0 / 365.25  # mas/yr -> rad/day
_PC_LTS = 3.0856775814913673e16 / 299792458.0  # parsec in light-seconds


class UnsupportedTimingModelError(ValueError):
    """The par file carries timing-model terms this model cannot honor
    (TCB units, unknown binary models, unknown glitch-family or site
    codes).  The reference handles arbitrary models through PINT
    (reference: io/psrfits.py:144-177); here unsupported terms must be
    rejected loudly rather than silently ignored.  (FB-series
    orbital-frequency derivatives are evaluated directly — see
    :meth:`TimingModel._binary_delay_at`.)"""


# multi-line flagged terms (noise/jump descriptors) collected as lists by
# the parser; none enter deterministic phase prediction
_IGNORABLE_PREFIXES = (
    "JUMP", "T2EFAC", "T2EQUAD", "ECORR", "EFAC", "EQUAD", "DMJUMP",
    "RNAMP", "RNIDX", "TNRED", "TNDM", "TNECORR", "FD",
)
_BINARY_OK = frozenset({"BT", "DD", "DDS", "DDK", "ELL1", "ELL1H"})

# high-precision epochs: parse as longdouble, not float64 (float64 MJD
# quantizes at ~0.6 us -> ~1e-4 cycles of absolute phase for a MSP)
_LONGDOUBLE_KEYS = frozenset({"TZRMJD", "PEPOCH", "T0", "TASC", "POSEPOCH"})
_LONGDOUBLE_PREFIXES = ("GLEP_",)  # glitch epochs need the same precision


def parse_par_full(parfile):
    """Parse a TEMPO/PINT par file keeping every line.

    Returns a dict; scalar values are float64 (longdouble for the epoch
    keys above), flag-style values stay strings, repeated keys (JUMP,
    T2EFAC, ...) are collected into lists under ``key + "#"``.
    """
    params = {}
    with open(parfile) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0].upper()
            if len(parts) == 1:
                params.setdefault(key, "")
                continue
            val = parts[1]
            if key.startswith(_IGNORABLE_PREFIXES) and not _is_number(val):
                params.setdefault(key + "#", []).append(parts[1:])
                continue
            parsed = _parse_value(key, val)
            params[key] = parsed
    return params


_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eEdD][+-]?\d+)?$")


def _is_number(s):
    return bool(_NUM_RE.match(s))


def _parse_value(key, val):
    if key in ("TZRSITE", "NSITE") or not _is_number(val):
        return val  # site codes are labels even when they look numeric
    txt = val.replace("D", "E").replace("d", "e")
    if key in _LONGDOUBLE_KEYS or key.startswith(_LONGDOUBLE_PREFIXES):
        return np.longdouble(txt)
    return float(txt)


def check_model_supported(params, parfile="<par>"):
    """Raise :class:`UnsupportedTimingModelError` for terms that would be
    silently mispredicted: unknown time units, unknown binary models,
    unknown glitch-family terms, incomplete glitch groups, unknown
    observatory codes.  FB-series orbital-frequency derivatives
    (FB0..FBn) are implemented (``_init_binary``/``_binary_delay_at``);
    ``UNITS TCB`` pars are accepted too — :class:`TimingModel` converts
    them to TDB with the IAU scaling (:func:`tcb_to_tdb_params`) before
    any evaluation — so only genuinely unknown unit systems reject."""
    bad = []
    glitch_idx = set()
    for key, val in params.items():
        kb = key.rstrip("#")
        m = re.match(r"^GL(EP|PH|F0D|F0|F1|F2|TD)_(\d+)$", kb)
        if m:
            # glitch terms are implemented (TimingModel._init_glitches);
            # collect indices to cross-check completeness below
            glitch_idx.add(m.group(2))
        elif kb.startswith("GL"):
            bad.append(key)  # unknown glitch-family term
    for idx in sorted(glitch_idx):
        if f"GLEP_{idx}" not in params:
            bad.append(f"GLF*_{idx} (without GLEP_{idx})")
        f0d = params.get(f"GLF0D_{idx}", 0.0)
        if (isinstance(f0d, (float, np.floating)) and f0d != 0.0
                and not params.get(f"GLTD_{idx}", 0.0)):
            bad.append(f"GLF0D_{idx} (without GLTD_{idx})")
    units = str(params.get("UNITS", "TDB")).upper()
    if units not in ("TDB", "TCB", ""):
        bad.append(f"UNITS={units}")
    binary = str(params.get("BINARY", "")).strip().upper()
    if binary and binary not in _BINARY_OK:
        bad.append(f"BINARY={binary}")
    if binary in ("ELL1", "ELL1H"):
        # EPS1DOT/EPS2DOT map onto EDOT/OMDOT (see _init_binary), which
        # needs a defined eccentricity direction
        dots = [k for k in ("EPS1DOT", "EPS2DOT")
                if isinstance(params.get(k), (float, np.floating))
                and params[k] != 0.0]
        if dots and float(np.hypot(params.get("EPS1", 0.0) or 0.0,
                                   params.get("EPS2", 0.0) or 0.0)) == 0.0:
            bad.extend(dots)
    if not binary:
        # orbital parameters without a BINARY model would be silently
        # dropped — reject them instead
        orphans = [k for k in params
                   if (k in ("PB", "A1", "T0", "TASC", "EPS1", "EPS2")
                       or re.match(r"^FB\d+$", k))
                   and isinstance(params.get(k), (float, np.floating))
                   and params[k] != 0.0]
        bad.extend(sorted(orphans))
    site = str(params.get("TZRSITE", "@")).strip().lower()
    if site not in ephem.BARYCENTRIC_SITES:
        try:
            # resolves built-ins, register_observatory/load_tempo_obsys
            # entries, and explicit "xyz:..." forms alike
            ephem.observatory_itrf(site)
        except ephem.UnknownObservatoryError:
            bad.append(f"TZRSITE={params['TZRSITE']}")
    if bad:
        raise UnsupportedTimingModelError(
            f"par file {parfile} contains timing-model terms this model "
            f"cannot honor: {sorted(set(bad))}. Generate polycos with "
            "PINT/TEMPO externally, or pass strict=False to knowingly "
            "ignore them.")


# IAU 2006 Resolution B3: TDB = TCB - L_B * (JD_TCB - T_0) * 86400 + TDB_0
_TCB_L_B = 1.550519768e-8
_TCB_T0_MJD = np.longdouble("43144.0003725")   # 1977 Jan 1.0 TAI
_TCB_TDB0_S = -6.55e-5                          # seconds

# time-dimension exponents of the scaled par quantities: a value with
# units s^d transforms as  q_TDB = q_TCB * (1 - L_B)^d  (tempo2's
# TCB->TDB transformation; frequencies d=-1, periods/amplitudes d=+1).
# DM rides along because the dispersion DELAY is a time: with the
# dispersion constant held fixed, DM_TDB = DM_TCB / (1 - L_B), and each
# per-year derivative picks up one more inverse power.
_TCB_SCALE_EXPONENTS = {
    "PB": 1, "A1": 1, "GAMMA": 1, "H3": 1, "H4": 1, "M2": 1,
    "EDOT": -1, "OMDOT": -1, "EPS1DOT": -1, "EPS2DOT": -1,
    "DM": -1, "DM1": -2, "DM2": -3, "DM3": -4,
}


def _tcb_epoch_to_tdb(mjd):
    """One absolute epoch, TCB MJD -> TDB MJD (longdouble)."""
    t = np.longdouble(mjd)
    return (t - np.longdouble(_TCB_L_B) * (t - _TCB_T0_MJD)
            + np.longdouble(_TCB_TDB0_S) / np.longdouble(_SEC_PER_DAY))


def tcb_to_tdb_params(params):
    """Convert a parsed ``UNITS TCB`` par dict to TDB (IAU scaling).

    TCB ticks faster than TDB by the defining constant
    ``L_B = 1.550519768e-8`` (IAU 2006 B3), so a par file fit in TCB
    carries epochs on a different clock and every dimensioned parameter
    scaled by powers of ``(1 - L_B)``.  The standard transformation
    (what ``tempo2 -upd`` / PINT apply):

    * absolute epochs (PEPOCH, POSEPOCH, DMEPOCH, T0, TASC, TZRMJD,
      glitch epochs, DMX range edges) map through
      ``TDB = TCB - L_B (TCB - T_0) + TDB_0``;
    * spin terms scale as frequencies, ``F_k -> F_k / (1-L_B)^(k+1)``,
      and the FB orbital-frequency series and glitch F-terms likewise;
    * periods/amplitudes measured in seconds (PB, A1, GAMMA, H3/H4,
      M2·T_sun) scale by ``(1-L_B)``, rate terms by its inverse, and DM
      (a delay in disguise) by ``1/(1-L_B)``.

    Dimensionless terms (PBDOT, XDOT, SINI, angles, PX at our accuracy)
    pass through.  Returns a NEW dict with ``UNITS`` set to ``TDB``;
    spin/epoch arithmetic stays in longdouble so the round-trip against
    an equivalently-fit TDB par agrees to <1e-6 cycles
    (tests/test_timing.py)."""
    one_minus = np.longdouble(1.0) - np.longdouble(_TCB_L_B)
    out = dict(params)
    out["UNITS"] = "TDB"

    def _num(v):
        return isinstance(v, (float, np.floating))

    for key, val in params.items():
        if not _num(val):
            continue
        if key in _LONGDOUBLE_KEYS or key.startswith(_LONGDOUBLE_PREFIXES):
            out[key] = _tcb_epoch_to_tdb(val)
            continue
        if key in ("DMEPOCH",) or re.match(r"^DMXR[12]_\d+$", key):
            out[key] = float(_tcb_epoch_to_tdb(val))
            continue
        m = re.match(r"^F(\d*)$", key)
        if m:
            k = int(m.group(1) or 0)
            out[key] = float(np.longdouble(val) / one_minus ** (k + 1))
            continue
        m = re.match(r"^FB(\d+)$", key)
        if m:
            out[key] = float(
                np.longdouble(val) / one_minus ** (int(m.group(1)) + 1))
            continue
        m = re.match(r"^GLF(0D|0|1|2)_(\d+)$", key)
        if m:
            order = {"0": 1, "0D": 1, "1": 2, "2": 3}[m.group(1)]
            out[key] = float(np.longdouble(val) / one_minus ** order)
            continue
        if re.match(r"^GLTD_\d+$", key):
            out[key] = float(np.longdouble(val) * one_minus)
            continue
        m = re.match(r"^DMX_\d+$", key)
        if m:
            out[key] = float(np.longdouble(val) / one_minus)
            continue
        exp = _TCB_SCALE_EXPONENTS.get(key)
        if exp is not None:
            out[key] = float(np.longdouble(val) * one_minus ** exp)
    return out


def _parse_sexagesimal(val, hours):
    """'hh:mm:ss.s' / 'dd:mm:ss.s' -> radians."""
    if isinstance(val, (float, np.floating)):
        return float(val) * (_DEG * 15.0 if hours else _DEG)
    parts = str(val).split(":")
    sign = -1.0 if parts[0].strip().startswith("-") else 1.0
    nums = [abs(float(p)) for p in parts]
    deg = nums[0] + nums[1] / 60.0 + (nums[2] if len(nums) > 2 else 0.0) / 3600.0
    return sign * deg * (15.0 if hours else 1.0) * _DEG


# (par fingerprint, strict) -> TimingModel; see TimingModel.from_par
_MODEL_CACHE = {}


class TimingModel:
    """Deterministic pulsar phase predictor built from a par file.

    Instances are treated as immutable after construction (from_par
    memoizes them by file fingerprint); do not mutate a returned model."""

    def __init__(self, params, parfile="<par>", strict=True):
        if str(params.get("UNITS", "TDB")).upper() == "TCB":
            # the last loud-rejection class (now that FB-series landed):
            # convert once at construction so every epoch/spin/binary
            # term below is already TDB — the root DIVERGENCES.md #31
            params = tcb_to_tdb_params(params)
        self.params = params
        self.parfile = parfile
        if strict:
            check_model_supported(params, parfile)
        p = params

        # -- spin --------------------------------------------------------
        f_idx = [int(k[1:]) for k in p
                 if re.match(r"^F\d+$", k)
                 and isinstance(p[k], (float, np.floating))]
        if f_idx:
            nmax = max(f_idx)
            fs = [np.longdouble(p.get(f"F{n}", 0.0))
                  for n in range(nmax + 1)]  # gaps (e.g. F0+F2) are zeros
        elif "F" in p:
            fs = [np.longdouble(p["F"])]
        else:
            raise ValueError(f"par file {parfile} has no F0")
        self.f_terms = fs
        self.pepoch = np.longdouble(p.get("PEPOCH", 56000.0))
        self._init_glitches(p)

        # -- astrometry --------------------------------------------------
        self._init_direction(p)
        px = float(p.get("PX", 0.0))  # mas
        self.dist_lts = (1000.0 / px) * _PC_LTS if px > 0 else None

        # -- dispersion --------------------------------------------------
        self.dm = float(p.get("DM", 0.0))
        self.dm_derivs = [float(p.get(f"DM{i}", 0.0)) for i in (1, 2, 3)]
        self.dmepoch = float(p.get("DMEPOCH", p.get("PEPOCH", 56000.0)))
        r1s, r2s, vals = [], [], []
        for key, val in p.items():
            m = re.match(r"^DMX_(\d+)$", key)
            if m and isinstance(val, (float, np.floating)):
                idx = m.group(1)
                if f"DMXR1_{idx}" in p and f"DMXR2_{idx}" in p:
                    r1s.append(float(p[f"DMXR1_{idx}"]))
                    r2s.append(float(p[f"DMXR2_{idx}"]))
                    vals.append(float(val))
        order = np.argsort(r1s) if r1s else []
        self.dmx_r1 = np.asarray(r1s, np.float64)[order] if r1s else None
        self.dmx_r2 = np.asarray(r2s, np.float64)[order] if r1s else None
        self.dmx_val = np.asarray(vals, np.float64)[order] if r1s else None
        self.fd_terms = []
        i = 1
        while f"FD{i}" in p:
            self.fd_terms.append(float(p[f"FD{i}"]))
            i += 1

        # -- binary ------------------------------------------------------
        self.binary = str(p.get("BINARY", "")).strip().upper() or None
        if self.binary and self.binary not in _BINARY_OK:
            # only reachable with strict=False: drop the unknown model
            self.binary = None
        if self.binary:
            self._init_binary(p)

        # -- phase zero point (TZR) -------------------------------------
        self.tzrmjd = p.get("TZRMJD", None)
        self.tzrfrq = float(p.get("TZRFRQ", 0.0)) or None
        self.tzrsite = str(p.get("TZRSITE", "@")).strip()
        self._phase0 = np.longdouble(0.0)
        if self.tzrmjd is not None:
            self._phase0 = self._phase_raw(
                np.atleast_1d(np.longdouble(self.tzrmjd)),
                freq_mhz=self.tzrfrq, site=self.tzrsite)[0]

    # -- construction helpers -------------------------------------------

    @classmethod
    def from_par(cls, parfile, strict=True):
        """Build from a par file, memoized on (path, mtime, size, strict):
        multi-segment polyco tables and bulk exports evaluate the same
        model hundreds of times (one fit per span / file), and parsing a
        NANOGrav par (hundreds of DMX lines) dominates a single fit."""
        try:
            st = os.stat(parfile)
            key = (os.path.realpath(parfile), st.st_mtime_ns, st.st_size,
                   bool(strict))
        except OSError:
            key = None
        if key is not None and key in _MODEL_CACHE:
            return _MODEL_CACHE[key]
        model = cls(parse_par_full(parfile), parfile=str(parfile),
                    strict=strict)
        if key is not None:
            if len(_MODEL_CACHE) > 64:
                _MODEL_CACHE.clear()
            _MODEL_CACHE[key] = model
        return model

    def _init_glitches(self, p):
        """Collect GLEP_i/GLPH_i/GLF0_i/GLF1_i/GLF2_i/GLF0D_i/GLTD_i
        glitch terms (TEMPO/PINT semantics: for t >= GLEP_i the phase
        gains GLPH + GLF0*dt + GLF1*dt^2/2 + GLF2*dt^3/6 +
        GLF0D*tau*(1 - exp(-dt/tau)), dt in seconds, tau = GLTD days).
        The reference accepts these through PINT
        (psrsigsim/io/psrfits.py:116-181)."""
        self.glitches = []
        for key in p:
            m = re.match(r"^GLEP_(\d+)$", key)
            if not m:
                continue
            i = m.group(1)
            self.glitches.append({
                "ep": np.longdouble(p[key]),
                "ph": float(p.get(f"GLPH_{i}", 0.0)),
                "f0": float(p.get(f"GLF0_{i}", 0.0)),
                "f1": float(p.get(f"GLF1_{i}", 0.0)),
                "f2": float(p.get(f"GLF2_{i}", 0.0)),
                "f0d": float(p.get(f"GLF0D_{i}", 0.0)),
                "td_s": float(p.get(f"GLTD_{i}", 0.0)) * _SEC_PER_DAY,
            })
        self.glitches.sort(key=lambda g: g["ep"])

    def _init_direction(self, p):
        """Unit vector to the pulsar (equatorial J2000) with proper
        motion, from equatorial or ecliptic par coordinates."""
        if "RAJ" in p or "RA" in p:
            self.ra0 = _parse_sexagesimal(p.get("RAJ", p.get("RA")),
                                          hours=True)
            self.dec0 = _parse_sexagesimal(p.get("DECJ", p.get("DEC")),
                                           hours=False)
            pm_lon = float(p.get("PMRA", 0.0))
            pm_lat = float(p.get("PMDEC", 0.0))
            self._pm_frame_equatorial = True
        else:
            lam = p.get("LAMBDA", p.get("ELONG"))
            beta = p.get("BETA", p.get("ELAT"))
            if lam is None or beta is None:
                raise ValueError(
                    f"par file {self.parfile} has no sky position "
                    "(RAJ/DECJ or LAMBDA/BETA)")
            self.lam0 = float(lam) * _DEG
            self.beta0 = float(beta) * _DEG
            pm_lon = float(p.get("PMLAMBDA", p.get("PMELONG", 0.0)))
            pm_lat = float(p.get("PMBETA", p.get("PMELAT", 0.0)))
            self._pm_frame_equatorial = False
        self.pm_lon = pm_lon * _MAS_PER_YR  # rad/day (mu_lon * cos(lat))
        self.pm_lat = pm_lat * _MAS_PER_YR
        self.posepoch = float(p.get("POSEPOCH", p.get("PEPOCH", 56000.0)))

    def direction(self, mjd):
        """Pulsar unit vector(s), equatorial J2000, PM-propagated."""
        dt = np.asarray(mjd, np.float64) - self.posepoch
        if self._pm_frame_equatorial:
            ra = self.ra0 + self.pm_lon * dt / np.cos(self.dec0)
            dec = self.dec0 + self.pm_lat * dt
            v = np.stack([np.cos(dec) * np.cos(ra),
                          np.cos(dec) * np.sin(ra),
                          np.sin(dec)], axis=-1)
            return v
        lam = self.lam0 + self.pm_lon * dt / np.cos(self.beta0)
        beta = self.beta0 + self.pm_lat * dt
        ecl = np.stack([np.cos(beta) * np.cos(lam),
                        np.cos(beta) * np.sin(lam),
                        np.sin(beta)], axis=-1)
        return ephem._ecl_to_equ(ecl)

    def _init_binary(self, p):
        b = self.binary
        self._h3_only = 0.0
        # FB-series orbital-frequency derivatives (TEMPO2/PINT's BTX-style
        # parameterization, standard for black-widow systems whose orbital
        # period wanders non-linearly): orbital phase is evaluated as the
        # Taylor series  nb(t) = Σ_k FBk · dt^(k+1)/(k+1)!  [dt in s]
        # directly, superseding the PB/PBDOT form.  Engaged only when a
        # nonzero FB1+ term is present, so FB0-only and PB par files keep
        # the PB/PBDOT arithmetic exactly.
        fbs = {}
        for key, val in p.items():
            m = re.match(r"^FB(\d+)$", key)
            if m and isinstance(val, (float, np.floating)):
                fbs[int(m.group(1))] = float(val)
        self.fb_terms = None
        if fbs and any(v != 0.0 for i, v in fbs.items() if i >= 1):
            if fbs.get(0, 0.0) == 0.0:
                raise ValueError(
                    f"binary model {b} has FB1+ derivatives without FB0")
            nmax = max(fbs)
            self.fb_terms = [fbs.get(i, 0.0) for i in range(nmax + 1)]
        if "PB" in p:
            self.pb = float(p["PB"])  # days
        elif "FB0" in p:
            self.pb = 1.0 / (float(p["FB0"]) * _SEC_PER_DAY)
        else:
            raise ValueError(f"binary model {b} without PB/FB0")
        self._eps_edot = 0.0
        self._eps_omdot = 0.0
        if b in ("ELL1", "ELL1H"):
            eps1 = float(p.get("EPS1", 0.0))
            eps2 = float(p.get("EPS2", 0.0))
            self.ecc = float(np.hypot(eps1, eps2))
            self.om0 = float(np.arctan2(eps1, eps2))
            tasc = np.longdouble(p["TASC"])
            # T0 (periastron) = TASC + (omega / 2 pi) * PB — exact
            # reparameterization of the same Keplerian orbit
            self.t0 = tasc + np.longdouble(self.om0 / (2 * np.pi) * self.pb)
            # EPS1DOT/EPS2DOT: linear Laplace-parameter drift is exactly a
            # joint (EDOT, OMDOT) drift to first order —
            # e_dot = (e1 e1dot + e2 e2dot)/e, om_dot = (e1dot e2 - e1 e2dot)/e^2
            e1d = float(p.get("EPS1DOT", 0.0))
            e2d = float(p.get("EPS2DOT", 0.0))
            # TEMPO legacy 1e-12 unit heuristic, as for PBDOT/EDOT below
            if abs(e1d) > 1e-7:
                e1d *= 1e-12
            if abs(e2d) > 1e-7:
                e2d *= 1e-12
            if (e1d or e2d) and self.ecc > 0.0:
                self._eps_edot = (eps1 * e1d + eps2 * e2d) / self.ecc  # 1/s
                self._eps_omdot = ((e1d * eps2 - eps1 * e2d)
                                   / self.ecc**2)  # rad/s
        else:
            self.ecc = float(p.get("ECC", p.get("E", 0.0)))
            self.om0 = float(p.get("OM", 0.0)) * _DEG
            self.t0 = np.longdouble(p.get("T0", p.get("TASC", 56000.0)))
        self.a1 = float(p.get("A1", 0.0))  # light-seconds

        def _dot(key, alt=None):
            # TEMPO legacy convention: PBDOT/XDOT/EDOT values with
            # |v| > 1e-7 are given in units of 1e-12 (PINT applies the
            # same heuristic); e.g. the vendored J1910 par has
            # 'XDOT -0.023017' meaning -2.3e-14 lt-s/s
            v = float(p.get(key, p.get(alt, 0.0) if alt else 0.0))
            return v * 1e-12 if abs(v) > 1e-7 else v

        self.pbdot = _dot("PBDOT")
        self.omdot = (float(p.get("OMDOT", 0.0)) * _DEG / 365.25
                      + self._eps_omdot * _SEC_PER_DAY)  # rad/day
        self.xdot = _dot("XDOT", "A1DOT")  # lt-s/s
        self.edot = _dot("EDOT") + self._eps_edot  # 1/s
        self.gamma = float(p.get("GAMMA", 0.0))  # s
        # Shapiro parameterization: SINI/M2 (BT/DD/DDK via KIN), or
        # DDS SHAPMAX, or ELL1H H3/STIG orthometric
        self.m2 = float(p.get("M2", 0.0))  # Msun
        if b == "DDK" and "KIN" in p:
            self.sini = float(np.sin(float(p["KIN"]) * _DEG))
        elif b == "DDS" and "SHAPMAX" in p:
            self.sini = 1.0 - float(np.exp(-float(p["SHAPMAX"])))
        elif b == "ELL1H":
            h3 = float(p.get("H3", 0.0))
            stig = float(p.get("STIG", p.get("VARSIGMA", 0.0)))
            if stig <= 0.0 and h3 > 0.0 and float(p.get("H4", 0.0)) > 0.0:
                # orthometric H3/H4 form (Freire & Wex 2010): stig = H4/H3
                stig = float(p["H4"]) / h3
            if stig > 0:
                self.sini = 2.0 * stig / (1.0 + stig**2)
                self.m2 = (h3 / stig**3) / ephem.SUN_T
            elif h3 != 0.0:
                # H3-only orthometric model (Freire & Wex 2010 eq 19, the
                # form PINT/TEMPO2 fit when only H3 is measurable): keep
                # exactly the third harmonic of the Shapiro expansion,
                # Delta_S3 = -(4/3) h3 sin(3 Phi) with Phi the orbital
                # phase from the ascending node.  The k<3 harmonics are
                # covariant with the Roemer parameters and the k>3 terms
                # are O(h3*stig) — unmeasurable when only H3 fits.
                self._h3_only = h3  # seconds
                self.sini = 0.0
        else:
            self.sini = float(p.get("SINI", 0.0))

    # -- delays ----------------------------------------------------------

    def binary_delay(self, t_ssb_mjd):
        """Total binary delay (seconds) at barycentric emission time,
        found by iterating t_em = t_arr - Delta(t_em); the Roemer +
        Einstein + Shapiro forms follow Blandford & Teukolsky / Damour &
        Deruelle as implemented by TEMPO's BT/DD family."""
        if not self.binary:
            return np.zeros(np.shape(t_ssb_mjd))
        t = np.asarray(t_ssb_mjd, np.longdouble)
        delay = np.zeros(np.shape(t), np.float64)
        for _ in range(4):
            delay = self._binary_delay_at(t - delay / _SEC_PER_DAY)
        return delay

    def _binary_delay_at(self, t_mjd):
        dt_days = np.asarray(t_mjd - self.t0, np.float64)
        dt_sec = dt_days * _SEC_PER_DAY
        if self.fb_terms is not None:
            # orbital phase from the FB Taylor series (orbits since T0):
            # nb = FB0·dt + FB1·dt²/2! + FB2·dt³/3! + ...  — Horner form
            # in dt, factorials folded into the running coefficient
            nb = np.zeros(np.shape(dt_sec))
            for k in range(len(self.fb_terms) - 1, -1, -1):
                nb = (nb * dt_sec / (k + 2)) + self.fb_terms[k]
            nb = nb * dt_sec
            m_anom = 2.0 * np.pi * nb
        else:
            nb = dt_days / self.pb  # orbits since T0
            m_anom = 2.0 * np.pi * (nb - 0.5 * self.pbdot * nb * nb)
        ecc = np.clip(self.ecc + self.edot * dt_sec, 0.0, 0.999999)
        x = self.a1 + self.xdot * dt_sec
        om = self.om0 + self.omdot * dt_days
        E = ephem.solve_kepler(np.mod(m_anom + np.pi, 2 * np.pi) - np.pi,
                               ecc)
        cE, sE = np.cos(E), np.sin(E)
        so, co = np.sin(om), np.cos(om)
        sq = np.sqrt(1.0 - ecc * ecc)
        alpha = x * so
        beta = x * sq * co
        roemer = alpha * (cE - ecc) + beta * sE
        einstein = self.gamma * sE
        delay = roemer + einstein
        if self.m2 > 0.0 and self.sini > 0.0:
            r = ephem.SUN_T * self.m2
            arg = 1.0 - ecc * cE - self.sini * (so * (cE - ecc)
                                                + sq * co * sE)
            delay = delay - 2.0 * r * np.log(np.maximum(arg, 1e-12))
        elif self._h3_only:
            # Freire & Wex 2010 eq 19: third harmonic of the Shapiro
            # expansion.  Phi (phase from ascending node) = M + omega in
            # the low-eccentricity ELL1 regime this model applies to.
            phi = m_anom + om
            delay = delay - (4.0 / 3.0) * self._h3_only * np.sin(3.0 * phi)
        return delay

    def dm_at(self, mjd):
        """DM(t): base + polynomial derivatives + DMX piecewise offsets."""
        mjd = np.asarray(mjd, np.float64)
        dm = np.full(mjd.shape, self.dm)
        if any(self.dm_derivs):
            dt_yr = (mjd - self.dmepoch) / 365.25
            for i, d in enumerate(self.dm_derivs, start=1):
                dm = dm + d * dt_yr**i
        if self.dmx_val is not None:
            inside = ((mjd[..., None] >= self.dmx_r1)
                      & (mjd[..., None] <= self.dmx_r2))
            dm = dm + np.sum(np.where(inside, self.dmx_val, 0.0), axis=-1)
        return dm

    def _geometric_delays(self, mjd_utc, freq_mhz, site):
        """Sum of delays (seconds, to ADD to topocentric TDB) for the
        barycentric infinite-frequency arrival time."""
        mjd64 = np.asarray(mjd_utc, np.float64)
        total = np.zeros(mjd64.shape)
        site_l = str(site).strip().lower()
        if site_l not in ephem.BARYCENTRIC_SITES:
            r_obs, r_sun = ephem.observatory_ssb(mjd64, site_l)
            phat = self.direction(mjd64)
            rdotp = np.sum(r_obs * phat, axis=-1)
            total = total + rdotp  # Roemer
            if self.dist_lts is not None:
                r2 = np.sum(r_obs * r_obs, axis=-1)
                total = total - (r2 - rdotp**2) / (2.0 * self.dist_lts)
            # solar Shapiro: diverges when the pulsar is occulted
            svec = r_obs - r_sun
            snorm = np.linalg.norm(svec, axis=-1)
            cossun = np.sum(svec * phat, axis=-1) / np.maximum(snorm, 1e-9)
            total = total + 2.0 * ephem.SUN_T * np.log(
                np.maximum(1.0 + cossun, 1e-12))
        if freq_mhz:
            total = total - _DM_K * self.dm_at(mjd64) / float(freq_mhz)**2
            if self.fd_terms:
                logf = np.log(float(freq_mhz) / 1000.0)
                fd = sum(c * logf**i
                         for i, c in enumerate(self.fd_terms, start=1))
                total = total - fd
        return total

    # -- phase -----------------------------------------------------------

    def _spin_phase(self, t_em_mjd):
        """Taylor spin phase (longdouble cycles) at emission-frame TDB,
        plus post-glitch terms."""
        t = np.asarray(t_em_mjd, np.longdouble)
        dt = (t - self.pepoch) * np.longdouble(_SEC_PER_DAY)
        phase = np.zeros(dt.shape, np.longdouble)
        fact = np.longdouble(1.0)
        for n, fn in enumerate(self.f_terms):
            fact = fact * np.longdouble(n + 1)
            phase = phase + fn * dt ** (n + 1) / fact
        for g in self.glitches:
            dtg = np.asarray((t - g["ep"]) * np.longdouble(_SEC_PER_DAY),
                             np.float64)
            on = dtg >= 0.0
            dtg = np.where(on, dtg, 0.0)
            gph = (g["ph"] + g["f0"] * dtg + g["f1"] / 2.0 * dtg**2
                   + g["f2"] / 6.0 * dtg**3)
            if g["f0d"] and g["td_s"]:
                gph = gph + g["f0d"] * g["td_s"] * (
                    1.0 - np.exp(-dtg / g["td_s"]))
            phase = phase + np.where(on, gph, 0.0).astype(np.longdouble)
        return phase

    def _phase_raw(self, mjd_utc, freq_mhz=None, site="@"):
        site_l = str(site).strip().lower()
        if site_l in ephem.BARYCENTRIC_SITES:
            # barycentric input: treated as TDB at the SSB already
            # (the closed-form semantics for '@' pars)
            t_tdb = np.asarray(mjd_utc, np.longdouble)
        else:
            t64 = np.asarray(mjd_utc, np.float64)
            off_s = ephem.tdb_minus_utc_seconds(t64)
            t_tdb = (np.asarray(mjd_utc, np.longdouble)
                     + (off_s / _SEC_PER_DAY).astype(np.longdouble))
        delays = self._geometric_delays(mjd_utc, freq_mhz, site_l)
        t_ssb = t_tdb + (delays / _SEC_PER_DAY).astype(np.longdouble)
        bdelay = self.binary_delay(t_ssb)
        t_em = t_ssb - (bdelay / _SEC_PER_DAY).astype(np.longdouble)
        return self._spin_phase(t_em)

    def phase(self, mjd_utc, freq_mhz=None, site=None):
        """Absolute pulse phase (longdouble cycles; 0 at the TZR arrival).

        Args:
            mjd_utc: topocentric UTC MJD(s); interpreted as barycentric
                TDB when ``site`` is barycentric ('@').
            freq_mhz: observing frequency for dispersion/FD terms
                (default: TZRFRQ).
            site: TEMPO observatory code (default: TZRSITE).
        """
        if site is None:
            site = self.tzrsite
        if freq_mhz is None:
            freq_mhz = self.tzrfrq
        mjd = np.atleast_1d(np.asarray(mjd_utc, np.longdouble))
        return self._phase_raw(mjd, freq_mhz=freq_mhz, site=site) - self._phase0

    def apparent_spin_freq(self, mjd_utc, freq_mhz=None, site=None,
                           eps_days=2e-4):
        """Apparent topocentric spin frequency (Hz) via central difference
        of :meth:`phase` — used for polyco sanity checks."""
        ph = self.phase(np.asarray([np.asarray(mjd_utc) - eps_days,
                                    np.asarray(mjd_utc) + eps_days]),
                        freq_mhz=freq_mhz, site=site)
        return float((ph[1] - ph[0]) / (2 * eps_days * _SEC_PER_DAY))
