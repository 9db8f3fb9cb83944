"""Canonical simulation request specs: validation, canonicalization, hashing
(counterpart: psrsigsim_tpu/serve/spec.py; host only, the same bytes).

A serving request is a plain JSON dict describing one fold-mode
observation — pulsar, telescope, geometry, plus the per-request knobs
(``seed``, ``dm``, ``noise_scale``, ``null_frac``).  Everything the
serving layer does hangs off two derived identities:

* ``spec_hash`` — sha256 of the canonical JSON of the FULL spec.  It is
  the request id, the content address of the result cache entry, and
  (folded into the PRNG key with the seed) the root of the request's
  random streams — so a result is a pure function of its spec.
* ``geometry_hash`` — sha256 of the canonical JSON of the subset of
  fields that determine the staged program (everything except
  ``seed``/``dm``/``noise_scale``/``null_frac``).  Requests sharing a
  geometry hash coalesce into one device batch and share one staged
  bucket per width.

Canonicalization is strict on purpose: unknown keys are rejected loudly
(a typo like ``noise_scael`` silently defaulting would serve the wrong
physics and cache it forever under a hash the caller believes means
something else), numeric fields are normalized to float/int before
hashing so ``1`` and ``1.0`` address the same result, and validation
errors name every bad field at once.
"""

from __future__ import annotations

import hashlib
import json

from ..scenarios.registry import EFFECT_ORDER, EFFECTS, parse_stack

__all__ = ["SpecError", "canonicalize", "spec_hash", "geometry_hash",
           "geometry_fields", "build_geometry", "REQUEST_FIELDS",
           "GEOMETRY_FIELDS", "SCENARIO_FIELD", "SCENARIO_PARAM_FIELDS",
           "scenario_stack", "scenario_param_vector"]


class SpecError(ValueError):
    """A request spec failed validation; ``errors`` lists every problem."""

    def __init__(self, errors):
        self.errors = list(errors)
        super().__init__("invalid request spec: " + "; ".join(self.errors))


# field -> (type caster, default or REQUIRED, (lo, hi) inclusive bounds)
_REQUIRED = object()

#: geometry/physics fields: together they determine the staged program
#: (static shapes + the staged portrait and noise normalization)
GEOMETRY_FIELDS = {
    "nchan": (int, _REQUIRED, (1, 65536)),
    "fcent_mhz": (float, _REQUIRED, (1.0, 1e6)),
    "bw_mhz": (float, _REQUIRED, (0.001, 1e5)),
    "sample_rate_mhz": (float, _REQUIRED, (1e-6, 1e4)),
    "sublen_s": (float, _REQUIRED, (1e-4, 1e5)),
    "tobs_s": (float, _REQUIRED, (1e-4, 1e6)),
    "period_s": (float, _REQUIRED, (1e-5, 100.0)),
    "smean_jy": (float, _REQUIRED, (0.0, 1e4)),
    "profile_peak": (float, 0.5, (0.0, 1.0)),
    "profile_width": (float, 0.05, (1e-4, 0.5)),
    "profile_amp": (float, 1.0, (0.0, 1e3)),
    "aperture_m": (float, 100.0, (1.0, 1e4)),
    "area_m2": (float, 5500.0, (1.0, 1e7)),
    "tsys_k": (float, 35.0, (0.1, 1e5)),
}

#: per-request fields: per-row program inputs, free to vary inside a batch
REQUEST_FIELDS = {
    "seed": (int, _REQUIRED, (0, 2**31 - 1)),
    "dm": (float, _REQUIRED, (0.0, 1e4)),
    "noise_scale": (float, 1.0, (0.0, 1e3)),
    "null_frac": (float, 0.0, (0.0, 1.0)),
}

#: the scenario-selection geometry field: a list of effect labels
#: (``"scintillation"``, ``"rfi"``, ``"single_pulse[:mode]"``).  It is
#: PROGRAM-SHAPING (part of the geometry hash): which effects run is a
#: static choice of the staged bucket, which is what keeps scenario-free
#: requests bit-identical to the pre-scenario pipeline.  Absent/empty ⇒
#: the key never enters the canonical spec, so every pre-scenario spec
#: keeps its exact hash (= cache address = PRNG fold).
SCENARIO_FIELD = "scenarios"

#: per-request scenario parameters, one field per registered effect
#: parameter (the psrsigsim_torch.scenarios registry is the single schema
#: source).  Per request — free to vary inside a batch — but only
#: VALID (and only canonicalized, defaults included) when the owning
#: effect is enabled in ``scenarios``: a parameter for a disabled effect
#: is rejected loudly rather than silently ignored and mis-cached.
SCENARIO_PARAM_FIELDS = {
    p.name: (float, p.default, (p.lo, p.hi))
    for n in EFFECT_ORDER for p in EFFECTS[n].params
}
_PARAM_EFFECT = {p.name: n for n in EFFECT_ORDER
                 for p in EFFECTS[n].params}

_ALL_FIELDS = {**GEOMETRY_FIELDS, **REQUEST_FIELDS,
               **SCENARIO_PARAM_FIELDS}


def canonicalize(spec):
    """Validate ``spec`` and return the canonical dict (defaults filled,
    numerics normalized).  Raises :class:`SpecError` naming EVERY bad
    field — unknown keys, missing required fields, wrong types, and
    out-of-range values are all collected before raising."""
    if not isinstance(spec, dict):
        raise SpecError([f"spec must be a JSON object, got {type(spec).__name__}"])
    errors = []
    unknown = sorted(set(spec) - set(_ALL_FIELDS) - {SCENARIO_FIELD})
    if unknown:
        errors.append(f"unknown field(s) {unknown}; valid fields: "
                      f"{sorted(_ALL_FIELDS) + [SCENARIO_FIELD]}")
    stack = None
    if SCENARIO_FIELD in spec:
        raw = spec[SCENARIO_FIELD]
        if (not isinstance(raw, (list, tuple))
                or not all(isinstance(x, str) for x in raw)):
            errors.append(f"{SCENARIO_FIELD}: expected a list of effect "
                          f"labels, got {raw!r}")
        else:
            try:
                stack = parse_stack(raw)
            except ValueError as err:
                errors.append(f"{SCENARIO_FIELD}: {err}")
    enabled_params = set(stack.param_names()) if stack is not None else set()
    out = {}
    for name, (cast, default, (lo, hi)) in _ALL_FIELDS.items():
        if name in SCENARIO_PARAM_FIELDS and name not in enabled_params:
            if name in spec:
                errors.append(
                    f"{name}: requires effect "
                    f"{_PARAM_EFFECT[name]!r} enabled in "
                    f"'{SCENARIO_FIELD}' (a parameter for a disabled "
                    "effect would be silently dead physics)")
            continue
        if name in spec:
            raw = spec[name]
            if isinstance(raw, bool) or isinstance(raw, (list, dict)):
                errors.append(f"{name}: expected {cast.__name__}, "
                              f"got {type(raw).__name__}")
                continue
            try:
                val = cast(raw)
            except (TypeError, ValueError):
                errors.append(f"{name}: expected {cast.__name__}, "
                              f"got {raw!r}")
                continue
            if cast is int and float(raw) != val:
                errors.append(f"{name}: expected integer, got {raw!r}")
                continue
        elif default is _REQUIRED:
            errors.append(f"{name}: required")
            continue
        else:
            val = cast(default)
        if not (lo <= val <= hi):
            errors.append(f"{name}: {val!r} outside [{lo}, {hi}]")
            continue
        out[name] = val
    if stack is not None:
        out[SCENARIO_FIELD] = stack.describe()
    if errors:
        raise SpecError(errors)
    return out


def _canonical_json(d):
    # sort_keys + tight separators + repr-stable floats: the SAME bytes
    # for the same canonical spec on every process, forever — these bytes
    # are the cache address and the PRNG fold, so format drift would both
    # orphan every cached result and silently change served randomness
    return json.dumps(d, sort_keys=True, separators=(",", ":"))


def spec_hash(canonical):
    """sha256 hex of the canonical spec (the request id / cache address)."""
    return hashlib.sha256(_canonical_json(canonical).encode()).hexdigest()


def geometry_fields(canonical):
    """The geometry-only subset of a canonical spec (the ``scenarios``
    selection is program-shaping, so it rides along when present)."""
    g = {k: canonical[k] for k in GEOMETRY_FIELDS}
    if SCENARIO_FIELD in canonical:
        g[SCENARIO_FIELD] = canonical[SCENARIO_FIELD]
    return g


def scenario_stack(canonical):
    """The static :class:`~psrsigsim_torch.scenarios.ScenarioStack` of a
    canonical spec (None for scenario-free specs)."""
    return parse_stack(canonical.get(SCENARIO_FIELD))


def scenario_param_vector(canonical):
    """The request's scenario-parameter row, ordered by the
    stack's ``param_names()`` (empty tuple for scenario-free specs).
    Canonicalization guarantees every enabled parameter is present."""
    stack = scenario_stack(canonical)
    if stack is None:
        return ()
    return tuple(float(canonical[n]) for n in stack.param_names())


def geometry_hash(canonical):
    """sha256 hex of the geometry subset (the program-bucket key)."""
    return hashlib.sha256(
        _canonical_json(geometry_fields(canonical)).encode()).hexdigest()


def build_geometry(canonical):
    """Stage one geometry bucket: ``(cfg, profiles, noise_norm)`` from a
    canonical spec's geometry fields, via the same object-oriented
    configuration path every other entry point uses
    (:func:`~psrsigsim_torch.simulate.build_fold_config`), so a served
    observation and a batch observation of the same physics are
    configured identically.  Host only: nothing goes to a device here."""
    from ..models.pulsar.profiles import GaussProfile
    from ..models.pulsar.pulsar import Pulsar
    from ..models.telescope.backend import Backend
    from ..models.telescope.receiver import Receiver
    from ..models.telescope.telescope import Telescope
    from ..signal import FilterBankSignal
    from ..simulate import build_fold_config
    from ..utils import make_quant

    g = geometry_fields(canonical)
    sig = FilterBankSignal(g["fcent_mhz"], g["bw_mhz"],
                           Nsubband=g["nchan"],
                           sample_rate=g["sample_rate_mhz"],
                           sublen=g["sublen_s"], fold=True)
    sig._tobs = make_quant(g["tobs_s"], "s")
    psr = Pulsar(g["period_s"], g["smean_jy"],
                 GaussProfile(peak=g["profile_peak"],
                              width=g["profile_width"],
                              amp=g["profile_amp"]),
                 name="SERVE")
    tscope = Telescope(g["aperture_m"], area=g["area_m2"],
                       Tsys=g["tsys_k"], name="ServeScope")
    tscope.add_system(
        "ServeSys",
        Receiver(fcent=g["fcent_mhz"], bandwidth=g["bw_mhz"], name="R"),
        Backend(samprate=12.5, name="B"))
    return build_fold_config(sig, psr, tscope, "ServeSys")
