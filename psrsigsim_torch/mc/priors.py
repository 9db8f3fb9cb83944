"""Declarative parameter priors for Monte-Carlo studies (counterpart:
psrsigsim_tpu/mc/priors.py).

A study declares "what varies" as ``{knob_name: Prior}``; every trial's
parameters are drawn from per-trial folded keys, ``fold_in(stage_key(
trial_key, "prior"), slot)``, with the trial key derived from (study
seed, GLOBAL trial index) exactly as :class:`~psrsigsim_torch.parallel.
FoldEnsemble` derives observation keys.  So any trial is reproducible on
its own, and the parameters do not depend on the chunk size.

The draws are the JAX package's, bit for bit (jax's threefry keys and
its ``uniform``/``normal``/``randint``/``choice`` in
:mod:`psrsigsim_torch.utils.rng` and :mod:`psrsigsim_torch.ops.stats`),
with the float32 arithmetic XLA compiles for them: the affine maps are
fused multiply-adds, and :class:`Normal` folds ``sqrt(2)·sigma`` into one
constant, and :class:`LogUniform`'s ``exp`` is XLA's polynomial
(:func:`psrsigsim_torch.ops.stats.exp`).  A batch of keys ``(B, 2)`` draws
a ``(B,)`` float32 tensor on the keys' device.

Priors are frozen dataclasses with hashable fields; ``describe()`` gives
the canonical dict of study fingerprints and the CLI's TOML/JSON specs
(:func:`parse_prior` is its inverse).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops.stats import (_NORMAL_LO, _SQRT2, choice, erf_inv, exp, fma,
                         uniform)
from ..utils.rng import fold_in, stage_key

__all__ = ["Prior", "Fixed", "Uniform", "LogUniform", "Normal", "Grid",
           "Choice", "parse_prior", "sample_priors"]

_F32 = torch.float32


def _f32(v):
    return float(np.float32(v))


def _uniform01(key):
    return uniform(key, 1)[..., 0]


@dataclasses.dataclass(frozen=True)
class Prior:
    """Base class: a scalar per-trial parameter distribution."""

    def sample(self, key, idx):
        """Draw one float32 value per key: ``key`` ``(B, 2)`` (already
        folded per (trial, parameter slot)), ``idx`` the ``(B,)`` GLOBAL
        trial indices (read only by the deterministic :class:`Grid`)."""
        raise NotImplementedError

    def support(self):
        """``(lo, hi)`` floats bounding (essentially) all mass — sizes the
        study's fixed histogram bins and conditional-statistics bins."""
        raise NotImplementedError

    def describe(self):
        """Canonical JSON-able spec dict (study fingerprints, CLI)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Fixed(Prior):
    """Degenerate prior: every trial gets ``value`` (pins a knob while
    keeping it in the recorded parameter columns)."""

    value: float

    def sample(self, key, idx):
        return torch.full(key.shape[:-1], _f32(self.value), dtype=_F32,
                          device=key.device)

    def support(self):
        v = float(self.value)
        pad = max(abs(v) * 0.5, 0.5)
        return v - pad, v + pad

    def describe(self):
        return {"dist": "fixed", "value": float(self.value)}


@dataclasses.dataclass(frozen=True)
class Uniform(Prior):
    """Uniform on ``[lo, hi)``."""

    lo: float
    hi: float

    def __post_init__(self):
        if not float(self.hi) > float(self.lo):
            raise ValueError(f"Uniform needs hi > lo, got [{self.lo}, {self.hi})")

    def sample(self, key, idx):
        lo, hi = _f32(self.lo), _f32(self.hi)
        return fma(_uniform01(key), _f32(hi - lo), lo)

    def support(self):
        return float(self.lo), float(self.hi)

    def describe(self):
        return {"dist": "uniform", "lo": float(self.lo), "hi": float(self.hi)}


@dataclasses.dataclass(frozen=True)
class LogUniform(Prior):
    """Log-uniform on ``[lo, hi)`` (both positive) — the natural prior for
    scale knobs (scattering tau, S/N, T_sys factors)."""

    lo: float
    hi: float

    def __post_init__(self):
        if not 0.0 < float(self.lo) < float(self.hi):
            raise ValueError(
                f"LogUniform needs 0 < lo < hi, got [{self.lo}, {self.hi})")

    def sample(self, key, idx):
        llo = _f32(math.log(float(self.lo)))
        lhi = _f32(math.log(float(self.hi)))
        return exp(fma(_uniform01(key), _f32(lhi - llo), llo))

    def support(self):
        return float(self.lo), float(self.hi)

    def describe(self):
        return {"dist": "loguniform", "lo": float(self.lo),
                "hi": float(self.hi)}


@dataclasses.dataclass(frozen=True)
class Normal(Prior):
    """Gaussian ``N(mean, sigma^2)``; histogram support spans ±4 sigma
    (tails clamp into the edge bins)."""

    mean: float
    sigma: float

    def __post_init__(self):
        if not float(self.sigma) > 0.0:
            raise ValueError(f"Normal needs sigma > 0, got {self.sigma}")

    def sample(self, key, idx):
        # XLA folds the normal's sqrt(2) and sigma into one float32
        # constant: mean + (sqrt(2)·sigma)·erf_inv(u), fused
        u = uniform(key, 1, _NORMAL_LO, 1.0)[..., 0]
        scale = _f32(np.float32(_SQRT2) * np.float32(self.sigma))
        return fma(erf_inv(u), scale, _f32(self.mean))

    def support(self):
        m, s = float(self.mean), float(self.sigma)
        return m - 4.0 * s, m + 4.0 * s

    def describe(self):
        return {"dist": "normal", "mean": float(self.mean),
                "sigma": float(self.sigma)}


@dataclasses.dataclass(frozen=True)
class Grid(Prior):
    """Deterministic grid sweep: trial ``i`` gets ``values[i % len]`` —
    the one prior that ignores its key."""

    values: tuple

    def __post_init__(self):
        vals = tuple(float(v) for v in self.values)
        if not vals:
            raise ValueError("Grid needs at least one value")
        object.__setattr__(self, "values", vals)

    def sample(self, key, idx):
        vals = torch.tensor(self.values, dtype=_F32, device=key.device)
        idx = torch.as_tensor(idx, device=key.device).to(torch.int64)
        return vals[torch.remainder(idx, len(self.values))]

    def support(self):
        lo, hi = min(self.values), max(self.values)
        if hi == lo:
            hi = lo + max(abs(lo), 1.0)
        return lo, hi

    def describe(self):
        return {"dist": "grid", "values": [float(v) for v in self.values]}


@dataclasses.dataclass(frozen=True)
class Choice(Prior):
    """Random draw from a finite value set, optionally weighted."""

    values: tuple
    probs: tuple = None

    def __post_init__(self):
        vals = tuple(float(v) for v in self.values)
        if not vals:
            raise ValueError("Choice needs at least one value")
        object.__setattr__(self, "values", vals)
        if self.probs is not None:
            p = tuple(float(x) for x in self.probs)
            if len(p) != len(vals):
                raise ValueError(
                    f"Choice probs length {len(p)} != values length {len(vals)}")
            tot = sum(p)
            if not tot > 0:
                raise ValueError("Choice probs must sum to a positive value")
            object.__setattr__(self, "probs", tuple(x / tot for x in p))

    def sample(self, key, idx):
        vals = torch.tensor(self.values, dtype=_F32, device=key.device)
        return vals[choice(key, len(self.values), p=self.probs)]

    def support(self):
        lo, hi = min(self.values), max(self.values)
        if hi == lo:
            hi = lo + max(abs(lo), 1.0)
        return lo, hi

    def describe(self):
        out = {"dist": "choice", "values": [float(v) for v in self.values]}
        if self.probs is not None:
            out["probs"] = [float(p) for p in self.probs]
        return out


_DISTS = {
    "fixed": lambda s: Fixed(s["value"]),
    "uniform": lambda s: Uniform(s["lo"], s["hi"]),
    "loguniform": lambda s: LogUniform(s["lo"], s["hi"]),
    "normal": lambda s: Normal(s["mean"], s["sigma"]),
    "grid": lambda s: Grid(tuple(s["values"])),
    "choice": lambda s: Choice(tuple(s["values"]),
                               tuple(s["probs"]) if s.get("probs") else None),
}


def sample_priors(priors, names, key, idx, stage="prior"):
    """All prior draws for a batch of trials: the draw for slot ``s`` of
    ``names`` comes from ``fold_in(stage_key(key, stage), s)``, so adding
    or removing one prior never perturbs another's stream.

    Args:
        priors: ``{name: Prior}``.
        names: slot order (the canonical knob order, never raw dict order).
        key: trial keys ``(B, 2)`` (derived from (seed, global index)).
        idx: ``(B,)`` global trial indices (Grid priors read them).
        stage: RNG stage name (:data:`psrsigsim_torch.utils.rng.STAGES`).

    Returns ``{name: (B,) float32}`` on the keys' device.
    """
    pk = stage_key(key, stage)
    return {name: priors[name].sample(fold_in(pk, slot), idx)
            for slot, name in enumerate(names)}


def parse_prior(spec):
    """A :class:`Prior` from its canonical spec dict (the CLI's TOML/JSON
    form; inverse of :meth:`Prior.describe`)."""
    if isinstance(spec, Prior):
        return spec
    if not isinstance(spec, dict) or "dist" not in spec:
        raise ValueError(
            f"prior spec must be a dict with a 'dist' key, got {spec!r}")
    dist = str(spec["dist"]).lower()
    maker = _DISTS.get(dist)
    if maker is None:
        raise ValueError(
            f"unknown prior dist {dist!r}; known: {sorted(_DISTS)}")
    try:
        return maker(spec)
    except KeyError as err:
        raise ValueError(
            f"prior spec {spec!r} missing required field {err}") from None
