"""Canonical dataset specs: validation, canonical JSON, fingerprint hash
(a copy of psrsigsim_tpu/datasets/spec.py, staged through the port's
models: for the same spec the canonical JSON and the fingerprint are the
JAX package's, byte for byte).

A labeled-training-corpus run is described by ONE plain JSON dict — the
SEARCH-mode observation geometry, the scenario stack whose effects
become label classes, the per-record prior space, and the corpus shape
(seed / record count / shard count).  Everything the factory does hangs
off the spec's canonical form, the way the JAX package's serving layer
hangs off its ``serve/spec.py`` (the same strictness, for the same
reason: a typo'd knob silently defaulting would bake the wrong physics
into a corpus some model then trains on):

* unknown keys are rejected loudly, naming every bad field at once;
* numerics are normalized (``1`` and ``1.0`` fingerprint identically);
* a prior or a parameter for a DISABLED effect is an error, never dead
  physics;
* the **fingerprint hash** — sha256 of the canonical JSON plus the
  record-format version — is the corpus identity: the manifest guard
  refuses to resume a directory written under a different fingerprint,
  and readers can trust that equal fingerprints mean byte-identical
  corpora (record content is a pure function of the spec).

The spec's randomness contract: record ``i``'s key derives exactly like
ensemble observation ``i``'s (``stage_key(key(seed), "user", i)``), and
prior draws live on the dedicated ``"dataset"`` RNG stage
(:data:`psrsigsim_torch.utils.rng.STAGES`) — so a record depends only on
``(seed, global record index)``, independent of chunk size, shard
count, and how often the factory died.
"""

from __future__ import annotations

import hashlib
import json

from ..mc.priors import parse_prior
from ..scenarios.registry import EFFECT_ORDER, EFFECTS, parse_stack

__all__ = ["DatasetSpecError", "canonicalize", "fingerprint_hash",
           "canonical_json", "scenario_stack", "knob_order",
           "build_search_geometry", "GEOMETRY_FIELDS", "DATASET_FIELDS",
           "SCENARIO_FIELD", "PRIORS_FIELD", "BASE_KNOBS",
           "RECORD_FORMAT_VERSION"]

#: bumped whenever the on-disk record layout changes — part of the
#: fingerprint, so an old corpus directory can never be silently resumed
#: (or mis-read) under a new layout
RECORD_FORMAT_VERSION = 1


class DatasetSpecError(ValueError):
    """A dataset spec failed validation; ``errors`` lists every problem."""

    def __init__(self, errors):
        self.errors = list(errors)
        super().__init__("invalid dataset spec: " + "; ".join(self.errors))


_REQUIRED = object()

#: SEARCH-mode observation geometry: together these determine the
#: compiled record program (static shapes + closed-over portrait and
#: noise normalization).  The serve layer's fold-mode table minus
#: ``sublen_s`` — in SEARCH mode one pulse IS the subintegration.
GEOMETRY_FIELDS = {
    "nchan": (int, _REQUIRED, (1, 65536)),
    "fcent_mhz": (float, _REQUIRED, (1.0, 1e6)),
    "bw_mhz": (float, _REQUIRED, (0.001, 1e5)),
    "sample_rate_mhz": (float, _REQUIRED, (1e-6, 1e4)),
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

#: corpus-shape + base-physics fields.  ``dm``/``noise_scale`` are the
#: base values a record uses when no prior varies them.
DATASET_FIELDS = {
    "seed": (int, _REQUIRED, (0, 2**31 - 1)),
    # bounded at int32 on purpose: record indices ride the in-graph key
    # derivation as int32 (the ensemble/study convention) — a larger
    # bound would silently wrap indices past 2**31 and break the
    # (seed, index) content contract
    "n_records": (int, _REQUIRED, (1, 2**31 - 1)),
    "shards": (int, 1, (1, 4096)),
    "dm": (float, _REQUIRED, (0.0, 1e4)),
    "noise_scale": (float, 1.0, (0.0, 1e3)),
}

#: the scenario-selection field: list of effect labels, the JAX package's
#: serve layer's field — which effects run is fixed per corpus, and each
#: enabled effect's ground truth becomes a label field in every record
SCENARIO_FIELD = "scenarios"

#: the per-record prior space: ``{knob: prior spec dict}``
#: (:func:`psrsigsim_torch.mc.priors.parse_prior` specs).  Valid knobs are
#: :data:`BASE_KNOBS` plus every parameter of an ENABLED effect.
PRIORS_FIELD = "priors"

#: base knobs a prior may vary independent of any scenario
BASE_KNOBS = ("dm", "noise_scale")

# fixed per-corpus scenario parameter fields (one per registered effect
# parameter, the registry as single schema source) — valid only when the
# owning effect is enabled; a prior on the same knob supersedes the
# fixed value per record
_SCENARIO_PARAM_FIELDS = {
    p.name: (float, p.default, (p.lo, p.hi))
    for n in EFFECT_ORDER for p in EFFECTS[n].params
}
_PARAM_EFFECT = {p.name: n for n in EFFECT_ORDER
                 for p in EFFECTS[n].params}

_ALL_FIELDS = {**GEOMETRY_FIELDS, **DATASET_FIELDS,
               **_SCENARIO_PARAM_FIELDS}


def canonicalize(spec):
    """Validate ``spec`` and return the canonical dict (defaults filled,
    numerics normalized, priors in canonical described form).  Raises
    :class:`DatasetSpecError` naming EVERY bad field."""
    if not isinstance(spec, dict):
        raise DatasetSpecError(
            [f"spec must be a JSON object, got {type(spec).__name__}"])
    errors = []
    unknown = sorted(set(spec) - set(_ALL_FIELDS)
                     - {SCENARIO_FIELD, PRIORS_FIELD})
    if unknown:
        errors.append(
            f"unknown field(s) {unknown}; valid fields: "
            f"{sorted(_ALL_FIELDS) + [PRIORS_FIELD, SCENARIO_FIELD]}")
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
    enabled = set(stack.param_names()) if stack is not None else set()

    out = {}
    for name, (cast, default, (lo, hi)) in _ALL_FIELDS.items():
        if name in _SCENARIO_PARAM_FIELDS and name not in enabled:
            if name in spec:
                errors.append(
                    f"{name}: requires effect {_PARAM_EFFECT[name]!r} "
                    f"enabled in '{SCENARIO_FIELD}' (a parameter for a "
                    "disabled effect would be silently dead physics)")
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

    valid_knobs = BASE_KNOBS + (tuple(stack.param_names())
                                if stack is not None else ())
    priors = {}
    if PRIORS_FIELD in spec:
        raw = spec[PRIORS_FIELD]
        if not isinstance(raw, dict):
            errors.append(f"{PRIORS_FIELD}: expected an object of "
                          f"{{knob: prior spec}}, got {raw!r}")
        else:
            for knob in sorted(raw):
                if knob not in valid_knobs:
                    scoped = ("an enabled-effect parameter or one of "
                              f"{list(BASE_KNOBS)}")
                    errors.append(
                        f"{PRIORS_FIELD}.{knob}: not {scoped} (enabled "
                        f"knobs: {list(valid_knobs)})")
                    continue
                try:
                    priors[knob] = parse_prior(raw[knob]).describe()
                except ValueError as err:
                    errors.append(f"{PRIORS_FIELD}.{knob}: {err}")
    if stack is not None:
        out[SCENARIO_FIELD] = stack.describe()
    # canonical knob order, never dict insertion order
    out[PRIORS_FIELD] = {k: priors[k] for k in valid_knobs if k in priors}
    if errors:
        raise DatasetSpecError(errors)
    return out


def canonical_json(canonical):
    """The canonical bytes (sort_keys + tight separators + repr-stable
    floats): the SAME bytes for the same spec on every process, forever
    — these bytes are the fingerprint, and the fingerprint is the
    corpus's resume/read identity."""
    return json.dumps(canonical, sort_keys=True, separators=(",", ":"))


def fingerprint_hash(canonical):
    """sha256 hex over (canonical spec, record-format version): the
    corpus identity."""
    body = {"spec": canonical, "record_format": RECORD_FORMAT_VERSION}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True,
                   separators=(",", ":")).encode()).hexdigest()


def scenario_stack(canonical):
    """The static :class:`~psrsigsim_torch.scenarios.ScenarioStack` of a
    canonical spec (None for scenario-free corpora)."""
    return parse_stack(canonical.get(SCENARIO_FIELD))


def knob_order(canonical):
    """Canonical per-record knob order: :data:`BASE_KNOBS` then the
    enabled stack's parameters in registry order — prior key-fold slots
    and the record's ``params`` label columns both follow it."""
    stack = scenario_stack(canonical)
    return BASE_KNOBS + (tuple(stack.param_names())
                         if stack is not None else ())


def build_search_geometry(canonical):
    """Stage the SEARCH-mode geometry: ``(cfg, profiles, noise_norm)``
    from a canonical spec, via the same OO configuration path every
    other entry point uses (:func:`simulate.build_single_config`) — a
    dataset record and a batch-CLI SEARCH observation of the same
    physics are configured identically."""
    from ..models.pulsar.profiles import GaussProfile
    from ..models.pulsar.pulsar import Pulsar
    from ..models.telescope.backend import Backend
    from ..models.telescope.receiver import Receiver
    from ..models.telescope.telescope import Telescope
    from ..signal import FilterBankSignal
    from ..simulate.pipeline import build_single_config
    from ..utils import make_quant

    g = canonical
    sig = FilterBankSignal(g["fcent_mhz"], g["bw_mhz"],
                           Nsubband=g["nchan"],
                           sample_rate=g["sample_rate_mhz"], fold=False)
    sig._tobs = make_quant(g["tobs_s"], "s")
    psr = Pulsar(g["period_s"], g["smean_jy"],
                 GaussProfile(peak=g["profile_peak"],
                              width=g["profile_width"],
                              amp=g["profile_amp"]),
                 name="DATASET")
    tscope = Telescope(g["aperture_m"], area=g["area_m2"],
                       Tsys=g["tsys_k"], name="DatasetScope")
    tscope.add_system(
        "DatasetSys",
        Receiver(fcent=g["fcent_mhz"], bandwidth=g["bw_mhz"], name="R"),
        Backend(samprate=12.5, name="B"))
    return build_single_config(sig, psr, tscope, "DatasetSys")
