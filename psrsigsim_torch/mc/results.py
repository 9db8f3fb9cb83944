"""Study results: merged accumulators, queries, and the fingerprinted artifact
(counterpart: psrsigsim_tpu/mc/results.py, host numpy, unchanged).

A :class:`StudyResult` owns the sweep's merged state — the trial-indexed
metric matrix (a few float32 per trial; the profiles never left the
device), the integer fixed-bin histograms, and the min/max — plus the
study fingerprint.  Everything derived (moments, percentiles, ECDFs,
conditional per-parameter-bin statistics) is computed from that state
with deterministic host reductions, which is what makes the acceptance
guarantees checkable: identical state -> byte-identical artifact,
regardless of chunking or how many times the sweep was killed.

The artifact is two files written atomically into the study's out_dir:

* ``study_result.json`` — spec echo + the full summary (sorted keys, no
  timestamps or telemetry, so the bytes are a pure function of the
  sweep's defining parameters);
* ``trials.npy`` — the per-trial metric matrix (``keep_trials=True``),
  i.e. the machine-learning dataset / exact-quantile store.

Their joint sha256 is the artifact fingerprint, recorded in
``study_manifest.json`` (alongside the run's stage telemetry, which is
deliberately OUTSIDE the fingerprinted files).
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

__all__ = ["StudyResult"]

_RESULT_NAME = "study_result.json"
_TRIALS_NAME = "trials.npy"

#: percentiles reported in the artifact summary
PERCENTILES = (1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0)

#: conditional-statistics resolution (bins over each parameter's support)
COND_BINS = 8


class StudyResult:
    """Merged outcome of one Monte-Carlo study.

    Attributes
    ----------
    metric_names : tuple[str]
        Column names of ``metrics`` (sampled parameters first, derived
        TOA metrics after).
    param_names : tuple[str]
        The sampled-parameter subset of ``metric_names``.
    metrics : ``(n_trials, M)`` float32
        Per-trial metric matrix in trial order.
    hist : ``(M, B)`` int64
        Merged fixed-bin histogram counts (exact integer merges of the
        in-graph per-chunk reductions).
    hist_ranges : dict ``{metric: (lo, hi)}``
    minmax : ``(mn, mx)`` float32 arrays of length M
    spec : dict
        The study fingerprint (:meth:`MonteCarloStudy.fingerprint`).
    telemetry : dict or None
        Stage-timer snapshot of the run that produced this result.
    fingerprint : str or None
        sha256 over the artifact bytes — set by :meth:`save`/:meth:`load`.
    """

    def __init__(self, metric_names, param_names, metrics, hist,
                 hist_ranges, minmax, spec, telemetry=None):
        self.metric_names = tuple(metric_names)
        self.param_names = tuple(param_names)
        self.metrics = np.asarray(metrics, np.float32)
        self.hist = np.asarray(hist, np.int64)
        self.hist_ranges = {k: (float(lo), float(hi))
                            for k, (lo, hi) in dict(hist_ranges).items()}
        self.minmax = (np.asarray(minmax[0], np.float32),
                       np.asarray(minmax[1], np.float32))
        self.spec = dict(spec)
        self.telemetry = telemetry
        self.fingerprint = None

    # -- queries -----------------------------------------------------------

    @property
    def n_trials(self):
        return int(self.metrics.shape[0])

    def _col(self, metric):
        try:
            j = self.metric_names.index(metric)
        except ValueError:
            raise KeyError(
                f"unknown metric {metric!r}; have {list(self.metric_names)}"
            ) from None
        return self.metrics[:, j]

    def column(self, metric):
        """The per-trial values of one metric (trial order)."""
        return np.array(self._col(metric))

    def percentile(self, metric, q):
        """Exact percentile(s) of a metric over the trial set."""
        return np.percentile(self._col(metric).astype(np.float64), q)

    def ecdf(self, metric):
        """Empirical CDF of a metric: ``(sorted values, P(X <= value))``."""
        vals = np.sort(self._col(metric).astype(np.float64))
        return vals, np.arange(1, vals.size + 1) / vals.size

    def hist_edges(self, metric):
        """The fixed-bin edges of a metric's streaming histogram."""
        lo, hi = self.hist_ranges[metric]
        return np.linspace(lo, hi, self.hist.shape[1] + 1)

    def conditional(self, param, metric, bins=COND_BINS):
        """Per-parameter-bin conditional statistics of ``metric``: bin
        trials by the sampled ``param`` over its prior support, return a
        dict of ``edges`` plus per-bin ``count``/``mean``/``std`` — the
        "TOA error vs DM" curve a study exists to produce."""
        if param not in self.param_names:
            raise KeyError(f"{param!r} is not a sampled parameter "
                           f"({list(self.param_names)})")
        p = self._col(param).astype(np.float64)
        v = self._col(metric).astype(np.float64)
        lo, hi = self.hist_ranges[param]
        edges = np.linspace(lo, hi, int(bins) + 1)
        idx = np.clip(((p - lo) / max(hi - lo, 1e-30) * bins).astype(int),
                      0, int(bins) - 1)
        count = np.bincount(idx, minlength=int(bins)).astype(np.int64)
        s1 = np.bincount(idx, weights=v, minlength=int(bins))
        s2 = np.bincount(idx, weights=v * v, minlength=int(bins))
        safe = np.maximum(count, 1)
        mean = s1 / safe
        var = np.maximum(s2 / safe - mean ** 2, 0.0)
        return {"edges": edges, "count": count, "mean": mean,
                "std": np.sqrt(var)}

    # -- the canonical summary --------------------------------------------

    def summary(self):
        """The full JSON-able summary: per-metric moments, extrema,
        percentiles, histograms, and conditional tables.  Deterministic
        given the merged state (sorted keys, float64 reductions over the
        trial-ordered matrix, integer histograms)."""
        per_metric = {}
        for j, name in enumerate(self.metric_names):
            col = self.metrics[:, j].astype(np.float64)
            qs = np.percentile(col, PERCENTILES) if col.size else []
            per_metric[name] = {
                "count": int(col.size),
                "mean": float(col.mean()) if col.size else None,
                "std": float(col.std(ddof=0)) if col.size else None,
                "min": float(self.minmax[0][j]),
                "max": float(self.minmax[1][j]),
                "percentiles": {str(p): float(v)
                                for p, v in zip(PERCENTILES, qs)},
                "hist": {
                    "lo": self.hist_ranges[name][0],
                    "hi": self.hist_ranges[name][1],
                    "counts": [int(c) for c in self.hist[j]],
                },
            }
        conditionals = {}
        for pname in self.param_names:
            for mname in self.metric_names:
                if mname in self.param_names:
                    continue
                c = self.conditional(pname, mname)
                conditionals[f"{mname}|{pname}"] = {
                    "edges": [float(e) for e in c["edges"]],
                    "count": [int(n) for n in c["count"]],
                    "mean": [float(m) for m in c["mean"]],
                    "std": [float(s) for s in c["std"]],
                }
        return {
            "spec": self.spec,
            "n_trials": self.n_trials,
            "metrics": list(self.metric_names),
            "params": list(self.param_names),
            "per_metric": per_metric,
            "conditional": conditionals,
        }

    # -- artifact ----------------------------------------------------------

    def save(self, out_dir, keep_trials=True):
        """Write the artifact (atomic per file) and record its joint
        sha256 fingerprint in the study manifest; returns the
        fingerprint.  The fingerprinted files carry NO wall-clock state,
        so an interrupted-and-resumed sweep reproduces them byte for
        byte."""
        from ..runtime.journal import atomic_write_json

        os.makedirs(out_dir, exist_ok=True)
        blob = (json.dumps(self.summary(), sort_keys=True, indent=1)
                + "\n").encode()
        res_path = os.path.join(out_dir, _RESULT_NAME)
        tmp = res_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, res_path)
        h = hashlib.sha256(blob)
        if keep_trials:
            npy_path = os.path.join(out_dir, _TRIALS_NAME)
            tmp = npy_path + ".tmp"
            with open(tmp, "wb") as f:
                np.save(f, self.metrics)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, npy_path)
            with open(npy_path, "rb") as f:
                h.update(f.read())
        self.fingerprint = h.hexdigest()

        man_path = os.path.join(out_dir, "study_manifest.json")
        man = {}
        if os.path.exists(man_path):
            try:
                with open(man_path) as f:
                    man = json.load(f)
            except json.JSONDecodeError:
                man = {}
        man["artifact_sha256"] = self.fingerprint
        man["artifact_files"] = ([_RESULT_NAME, _TRIALS_NAME]
                                 if keep_trials else [_RESULT_NAME])
        if self.telemetry is not None and any(
                self.telemetry.get(f"{s}_calls", 0)
                for s in ("dispatch", "fetch", "write")):
            # a fully-resumed no-op rerun touches only the host "reduce"
            # stage (journal reloads): it must not replace the real
            # sweep's durable bottleneck record (same rule as the export
            # manifest's pipeline key)
            man["pipeline"] = self.telemetry
        atomic_write_json(man_path, man, indent=1)
        return self.fingerprint

    @classmethod
    def load(cls, out_dir):
        """Rebuild a result from a saved artifact (summary + trials
        matrix; histograms/extrema come back from the summary)."""
        with open(os.path.join(out_dir, _RESULT_NAME), "rb") as f:
            blob = f.read()
        summary = json.loads(blob)
        names = tuple(summary["metrics"])
        params = tuple(summary["params"])
        npy_path = os.path.join(out_dir, _TRIALS_NAME)
        if os.path.exists(npy_path):
            metrics = np.load(npy_path)
        else:
            metrics = np.zeros((0, len(names)), np.float32)
        per = summary["per_metric"]
        hist = np.asarray([per[n]["hist"]["counts"] for n in names],
                          np.int64)
        ranges = {n: (per[n]["hist"]["lo"], per[n]["hist"]["hi"])
                  for n in names}
        mn = np.asarray([per[n]["min"] for n in names], np.float32)
        mx = np.asarray([per[n]["max"] for n in names], np.float32)
        out = cls(names, params, metrics, hist, ranges, (mn, mx),
                  summary["spec"])
        h = hashlib.sha256(blob)
        if os.path.exists(npy_path):
            with open(npy_path, "rb") as f:
                h.update(f.read())
        out.fingerprint = h.hexdigest()
        return out

    def __repr__(self):
        return (f"StudyResult(n_trials={self.n_trials}, "
                f"metrics={list(self.metric_names)}, "
                f"fingerprint={self.fingerprint and self.fingerprint[:12]})")
