"""Monte-Carlo study engine: parameter space -> trials -> results
(counterpart: psrsigsim_tpu/mc/study.py).

One trial is a complete program on the device — pulse synthesis, ISM
delays, radiometer noise (the two χ² fields drawn by the sampler kernel
on the card), the fold over subintegrations, and
:func:`~psrsigsim_torch.ops.toa.fftfit_shift` TOA measurement of every
channel — run for a whole chunk of trials at once, so a 100k-trial sweep
moves only a few floats per trial over the host link (the ``(Nchan,
Nsamp)`` blocks never leave the device).

Reproducibility contract:

* trial ``i``'s key is ``stage_key(key(seed), "user", i)`` — the SAME
  derivation :class:`~psrsigsim_torch.parallel.FoldEnsemble` uses for
  observation ``i``, so a study whose priors leave the profile untouched
  can export its exact trials as PSRFITS through the streaming exporter
  (:meth:`MonteCarloStudy.export_psrfits`); its trial block IS
  :func:`~psrsigsim_torch.simulate.fold_pipeline`'s block;
* parameters are drawn on the host from per-trial folded keys (the
  priors module), bit for bit the JAX package's, so every quantity
  depends only on (seed, global trial index);
* the fold over subints and every sum over harmonics or channels run in
  a fixed order of elementwise adds, so a trial's metric row does not
  depend on the chunk it ran in.

Streaming reduction: each chunk is reduced ON THE DEVICE to a per-trial
metric row plus integer histogram counts and min/max; the host merges
integers (exact, order-independent) and fills a trial-indexed metric
matrix, so the merged summary and the result artifact are bit-identical
for ANY chunking.

Resumable sweeps: per-chunk metric rows land in ``trials.f32``
(positional pwrite + fsync), then an fsync'd append-only journal line
(sha256, histogram, min/max), then an atomic cursor — a SIGKILL at any
point loses at most one uncommitted chunk, and the resumed run's artifact
is byte-identical to an uninterrupted one (the ``mc.kill`` fault point).
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from ..ops.stats import fixed_histogram
from ..ops.toa import fftfit_combine, fftfit_shift, scalar, tree_sum
from ..scenarios.registry import scenario_knobs as _scenario_knobs
from ..scenarios.registry import stack_from_knobs
from ..simulate.pipeline import (_dispersion_delays, fold_pipeline,
                                 fold_subints)
from ..parallel.mesh import CHAN_AXIS, MeshSlabs, mesh_devices
from ..runtime.telemetry import span
from ..utils.device import to_device
from ..utils.rng import key as make_key
from ..utils.rng import stage_key
from .priors import Prior, parse_prior, sample_priors

__all__ = ["MonteCarloStudy", "StudyManifestError", "KNOBS",
           "DERIVED_METRICS"]

_MANIFEST_NAME = "study_manifest.json"
_JOURNAL_NAME = "mc_journal.jsonl"
_CURSOR_NAME = "mc_cursor.json"
_TRIALS_RAW = "trials.f32"

#: the physics/instrument knobs a prior may vary:
#:
#: ``dm``           dispersion measure (pc/cm^3) — replaces the base DM.
#: ``tau_d_ms``     scattering tau at the band center (ms), scaled per
#:                  channel by the Kolmogorov thin-screen law f^-4.4 and
#:                  added to the dispersion delays.
#: ``width``        Gaussian profile width (phase turns) — switches the
#:                  trial to a Gaussian portrait (peak 0.5).
#: ``amp``          profile amplitude factor (with ``width``'s portrait).
#: ``noise_scale``  radiometer noise-norm factor (the T_sys knob).
#: ``null_frac``    per-subint nulling probability: nulled subints carry
#:                  only radiometer noise.
#:
#: Every parameter registered with the scenario engine
#: (:mod:`psrsigsim_torch.scenarios`) is also a knob, appended after the
#: base six in registry order (the tuple's order fixes every prior's
#: key-fold slot): ``scint_*`` knobs enable the scintillation gain screen,
#: ``rfi_*`` knobs RFI injection, and exactly one of
#: ``sp_sigma``/``sp_alpha``/``sp_amp`` single-pulse emission in
#: log-normal / power-law / FRB one-off mode.  The stack is inferred from
#: the knobs that carry priors (:func:`~psrsigsim_torch.scenarios.
#: stack_from_knobs`); unsampled parameters of an enabled effect take
#: registry defaults.
KNOBS = (("dm", "tau_d_ms", "width", "amp", "noise_scale", "null_frac")
         + _scenario_knobs())

#: derived per-trial metrics appended after the sampled parameters:
#: inverse-variance-combined TOA residual (turns, after subtracting the
#: known delay curve), rms of per-channel residuals, combined reported
#: sigma, and the mean fitted template amplitude.
DERIVED_METRICS = ("toa_err", "toa_rms", "toa_sigma", "fit_amp")

# Kolmogorov thin-screen scattering: beta = 11/3 -> -2*beta/(beta-2) = -4.4
_SCATTER_EXPONENT = -4.4

# default histogram support of the derived metrics (tails clamp into the
# edge bins — ops/stats.fixed_histogram)
_DERIVED_RANGES = {
    "toa_err": (-0.5, 0.5),
    "toa_rms": (0.0, 0.5),
    "toa_sigma": (0.0, 0.1),
    "fit_amp": (0.0, 4.0),
}

_F32 = torch.float32


class StudyManifestError(RuntimeError):
    """``resume=True`` against an out_dir written by a DIFFERENT study.

    Carries the per-field disagreement so an operator can tell a stale
    out_dir from a config typo."""

    def __init__(self, out_dir, mismatches):
        self.out_dir = out_dir
        self.mismatches = dict(mismatches)
        lines = [f"  - {k}: out_dir has {v[0]!r}, this run has {v[1]!r}"
                 for k, v in sorted(self.mismatches.items())]
        super().__init__(
            f"out_dir {out_dir} holds a study with different parameters; "
            "resuming would silently mix two sweeps.  Differing fields:\n"
            + "\n".join(lines)
            + "\nUse a fresh out_dir, or resume=False to overwrite.")


def _f32(v):
    return float(np.float32(v))


class MonteCarloStudy:
    """A declarative Monte-Carlo study over the fold-mode pipeline.

    Parameters
    ----------
    cfg : :class:`~psrsigsim_torch.simulate.pipeline.FoldPipelineConfig`
        Static observation geometry (envelope shift mode).
    profiles : array ``(Nchan, Nph)``
        Base noise-free portrait (the trial template, unless a
        ``width``/``amp`` prior switches to a Gaussian).
    noise_norm : float
        Base radiometer noise norm (scaled per trial by ``noise_scale``).
    priors : dict ``{knob: Prior-or-spec-dict}``
        What varies; knobs from :data:`KNOBS`.  An empty dict is legal (a
        pure repeat-trial noise study).
    seed : int
        Study seed; trial keys derive as ``stage_key(key(seed), "user",
        trial_index)``.
    dm : float
        Base DM when no ``dm`` prior is given.
    mesh : an ``(obs, chan)`` :class:`~psrsigsim_torch.parallel.Mesh`,
        optional: trials split over ``obs`` (a chunk pads to the obs
        shards), each position's trials on its device, the rows assembled
        on the mesh's first device (a different ``device`` raises).  The
        chan axis must be 1.  Rows are bit-identical for any obs-shard
        count.
    nharm : int, optional
        FFTFIT harmonic cap (default all).
    hist_bins : int
        Fixed-bin histogram resolution of the streaming reduction.
    hist_ranges : dict, optional
        ``{metric: (lo, hi)}`` overrides of the default histogram support
        (params default to their prior's support).
    device : str or torch.device, optional
        Where the trials run: the CUDA card by default (raises without
        one); ``"cpu"`` runs them on the host.
    """

    def __init__(self, cfg, profiles, noise_norm, priors, seed=0, dm=0.0,
                 mesh=None, nharm=None, hist_bins=32, hist_ranges=None,
                 base_width=0.05, device=None):
        self.mesh, self.device = mesh_devices(mesh, device)
        self.cfg = cfg
        self._profiles_np = np.ascontiguousarray(profiles, np.float32)
        self.noise_norm = float(noise_norm)
        self.dm = float(dm)
        self.seed = int(seed)
        self.nharm = None if nharm is None else int(nharm)
        self.hist_bins = int(hist_bins)
        self.base_width = float(base_width)
        self._simulation = None

        priors = {k: parse_prior(v) for k, v in dict(priors).items()}
        unknown = set(priors) - set(KNOBS)
        if unknown:
            raise ValueError(
                f"unknown study knob(s) {sorted(unknown)}; valid knobs: "
                f"{list(KNOBS)}")
        for k, v in priors.items():
            if not isinstance(v, Prior):
                raise TypeError(f"prior for {k!r} is not a Prior: {v!r}")
        # stable slot order = KNOBS order, so a prior's key fold never
        # depends on dict insertion order
        self.param_names = tuple(k for k in KNOBS if k in priors)
        self.priors = {k: priors[k] for k in self.param_names}
        self.metric_names = self.param_names + DERIVED_METRICS
        # the scenario stack the declared priors imply (None: scenario-free)
        self._scenario = stack_from_knobs(self.param_names)

        if getattr(cfg, "shift_mode", "envelope") != "envelope":
            # the trial is fold_pipeline's envelope branch; an exact-FFT
            # config would make the study measure other data than
            # run()/export simulate
            raise ValueError(
                "MonteCarloStudy implements the envelope-mode trial "
                f"program only; cfg.shift_mode={cfg.shift_mode!r}. Build "
                "the config with shift_mode='envelope' (unset "
                "PSS_EXACT_SHIFT) to run studies.")
        nchan = cfg.meta.nchan
        n_chan_shards = self.mesh.shape[CHAN_AXIS]
        if nchan % n_chan_shards:
            raise ValueError(
                f"Nchan={nchan} must be divisible by the chan mesh axis "
                f"({n_chan_shards})")
        if n_chan_shards > 1:
            # fftfit's channel combine is a cross-channel reduction; a
            # trial keeps its channels on one device
            raise ValueError(
                "MonteCarloStudy shards trials only: use a mesh with "
                "chan axis 1 (the default make_mesh())")

        self._hist_ranges = {}
        overrides = dict(hist_ranges or {})
        for name in self.metric_names:
            if name in overrides:
                lo, hi = overrides.pop(name)
            elif name in self.priors:
                lo, hi = self.priors[name].support()
            else:
                lo, hi = _DERIVED_RANGES[name]
            lo, hi = float(lo), float(hi)
            if not hi > lo:
                raise ValueError(f"hist range for {name}: hi must exceed lo")
            self._hist_ranges[name] = (lo, hi)
        if overrides:
            raise ValueError(
                f"hist_ranges for unknown metrics: {sorted(overrides)}")

        self._tau_ref_mhz = float(cfg.meta.fcent_mhz)
        dev = self.device
        self._profiles = torch.as_tensor(self._profiles_np, device=dev)
        self._freqs = torch.as_tensor(
            np.asarray(cfg.meta.dat_freq_mhz(), np.float32), device=dev)
        # global channel ids stay on the host (the sampler reads the first)
        self._chan_ids = torch.arange(cfg.meta.nchan)
        self._hist_lo = torch.tensor(
            [self._hist_ranges[m][0] for m in self.metric_names],
            dtype=_F32, device=dev)
        self._hist_hi = torch.tensor(
            [self._hist_ranges[m][1] for m in self.metric_names],
            dtype=_F32, device=dev)
        self._slabs = MeshSlabs(self.mesh, self._profiles, self._freqs)

    # -- construction bridges ---------------------------------------------

    @classmethod
    def from_simulation(cls, sim, priors, seed=0, mesh=None, **kw):
        """Build from a configured
        :class:`~psrsigsim_torch.simulate.Simulation` (runs ``init_all`` +
        ``build_fold_config``) on the simulation's device; keeps the
        simulation for :meth:`export_psrfits`."""
        from ..simulate.pipeline import build_fold_config

        sim.init_all()
        cfg, profiles, noise_norm = build_fold_config(
            sim.signal, sim.pulsar, sim.tscope, sim.system_name)
        dm = float(sim.signal.dm.value) if sim.signal.dm is not None else 0.0
        kw.setdefault("device", sim._device)
        study = cls(cfg, profiles, noise_norm, priors, seed=seed, dm=dm,
                    mesh=mesh, **kw)
        study._simulation = sim
        return study

    # -- the trial ---------------------------------------------------------

    def _trial_keys(self, idx):
        """Keys ``(B, 2)`` on the host for global trial indices ``idx``."""
        with span("keys"):
            return stage_key(make_key(self.seed, "cpu"), "user",
                             torch.as_tensor(np.asarray(idx),
                                             dtype=torch.int64))

    def _sample_params(self, keys, idx):
        """All prior draws of a batch of trials, on the host: the key fold
        is (trial key -> "prior" stage -> parameter slot), so adding or
        removing one prior never perturbs another's stream."""
        with span("priors"):
            return sample_priors(self.priors, self.param_names, keys,
                                 torch.as_tensor(np.asarray(idx)),
                                 stage="prior")

    def _trial_block(self, keys, p, profiles=None, freqs=None):
        """The trials' blocks ``(B, Nchan, Nsamp)``, their delay curves
        ``(B, Nchan)`` and templates, on the device of ``profiles`` and
        ``freqs`` (a mesh position's; default the study's):
        :func:`fold_pipeline` with each trial's DM, extra (scattering)
        delays, portrait, nulling probability and noise norm — so a study
        whose priors touch only dm/noise draws the ensemble's observations
        bit for bit."""
        cfg = self.cfg
        if profiles is None:
            profiles, freqs = self._profiles, self._freqs
        dev = profiles.device
        B = keys.shape[0]

        def param(name, default):
            if name in p:
                return to_device(p[name], dev)
            return torch.full((B,), _f32(default), dtype=_F32, device=dev)

        dm = param("dm", self.dm)
        scen = None
        if self._scenario is not None:
            # the trial's sampled scenario knobs (host tensors, as the
            # ensemble's); unsampled ones take registry defaults
            scen = {n: p[n] for n in self._scenario.param_names() if n in p}
        extra = None
        if "tau_d_ms" in p:
            ratio = freqs / scalar(self._tau_ref_mhz, dev)
            extra = param("tau_d_ms", 0.0)[:, None] * ratio ** _f32(
                _SCATTER_EXPONENT)
        if "width" in p or "amp" in p:
            width = param("width", self.base_width)
            amp = param("amp", 1.0)
            ph = (torch.arange(cfg.nph, dtype=_F32, device=dev) + 0.5) \
                / scalar(cfg.nph, dev)
            row = amp[:, None] * torch.exp(
                -0.5 * ((ph - 0.5) / width[:, None]) ** 2)
            prof = row[:, None, :]                   # one per trial
            portrait = prof.expand(B, cfg.meta.nchan, cfg.nph)
        else:
            prof = portrait = profiles
        # f32 base norm times the f32 scale, as the JAX package's trial
        nn = param("noise_scale", 1.0) * _f32(self.noise_norm)
        null = param("null_frac", 0.0) if "null_frac" in p else None
        # scenario effects on the trial's own noise level: the pipeline's
        # order and draws, so a trial equals the ensemble's observation
        block = fold_pipeline(keys, dm, nn, portrait, cfg, freqs=freqs,
                              chan_ids=self._chan_ids, extra_delays_ms=extra,
                              null_frac=null, scenario=self._scenario,
                              scenario_params=scen)
        return block, _dispersion_delays(dm, freqs, extra), prof

    def _trial_rows(self, keys, idx, profiles, freqs):
        """The trials' metric rows ``(B, M)`` float32 on the device of
        ``profiles`` (a mesh position's): fold on the device, FFTFIT every
        channel against the trial's own template, subtract the known delay
        curve, combine across the band."""
        cfg = self.cfg
        dev = profiles.device
        p = self._sample_params(keys, idx)
        block, delays_ms, prof = self._trial_block(keys, p, profiles, freqs)
        folded = fold_subints(block, cfg.nsub, cfg.nph)
        del block
        s, e, b = fftfit_shift(folded, prof, nharm=self.nharm)
        del folded
        period_ms = scalar(cfg.period_s * 1e3, dev)
        expect = torch.remainder(delays_ms / period_ms + 0.5, 1.0) - 0.5
        resid = torch.remainder(s - expect + 0.5, 1.0) - 0.5
        comb, comb_sigma = fftfit_combine(resid, e)
        nchan = scalar(resid.shape[-1], dev)
        rms = torch.sqrt(tree_sum(resid * resid) / nchan)
        vals = [to_device(p[n], dev) for n in self.param_names]
        vals += [comb, rms, comb_sigma, tree_sum(b) / nchan]
        return torch.stack(vals, dim=1)

    # -- the chunk program -------------------------------------------------

    def _chunk_program(self, start, n_trials, width, count):
        """One chunk on the device: metric rows ``(width, M)``, the
        per-metric int32 histograms ``(M, hist_bins)`` and min/max of the
        first ``count`` rows.  Indices wrap modulo ``n_trials`` (the
        ensemble's padding rule); wrapped rows are masked out of the
        reduction and trimmed before the matrix fill.

        The JAX package compiles an audit instance of its program for the
        integrity layer's duplicate execution; here every call is an
        independent launch of the same deterministic work, so the audit
        runs this same function (psrsigsim_torch/DIVERGENCES.md P10)."""
        idx = (start + np.arange(width)) % n_trials
        # each obs shard's trials on its device (the chan axis is 1)
        rows = self._slabs.run(
            lambda k, cols, r, prof, freqs, c: self._trial_rows(
                k, cols[0], prof, freqs),
            self._trial_keys(idx), (idx,), None, (0, None), self.device)
        valid = torch.arange(width, device=self.device) < count
        cols = rows.T
        hist = fixed_histogram(cols, self._hist_lo, self._hist_hi,
                               self.hist_bins,
                               weights=valid.to(torch.int32)[None, :])
        inf = scalar(float("inf"), self.device)
        mn = torch.where(valid[None, :], cols, inf).amin(dim=1)
        mx = torch.where(valid[None, :], cols, -inf).amax(dim=1)
        return rows, hist, mn, mx

    # -- fingerprint / manifest -------------------------------------------

    def fingerprint(self, n_trials):
        """Canonical study fingerprint: everything that defines the
        sweep's OUTPUT (chunk size, device and writer knobs are absent:
        they cannot change the bytes) — the JAX package's dict."""
        cfg = self.cfg
        fp = {
            "kind": "mc_study",
            "n_trials": int(n_trials),
            "seed": int(self.seed),
            "priors": {k: self.priors[k].describe()
                       for k in self.param_names},
            "metrics": list(self.metric_names),
            "hist_bins": int(self.hist_bins),
            "hist_ranges": {m: [self._hist_ranges[m][0],
                                self._hist_ranges[m][1]]
                            for m in self.metric_names},
            "nharm": self.nharm,
            "base_width": self.base_width,
            "config": {
                "nchan": int(cfg.meta.nchan),
                "nph": int(cfg.nph),
                "nsub": int(cfg.nsub),
                "nfold": float(cfg.nfold),
                "noise_df": float(cfg.noise_df),
                "dt_ms": float(cfg.dt_ms),
                "period_s": float(cfg.period_s),
                "draw_norm": float(cfg.draw_norm),
                "dm": float(self.dm),
                "noise_norm": float(self.noise_norm),
                "tau_ref_mhz": float(self._tau_ref_mhz),
                "profiles_sha256": hashlib.sha256(
                    self._profiles_np.tobytes()).hexdigest(),
            },
        }
        if self._scenario is not None:
            # stamped only when a scenario is active, so scenario-free
            # sweep directories keep their manifests; the registry defaults
            # of prior-less knobs are stamped too, so a changed default
            # refuses to resume an old sweep
            from ..scenarios.registry import _param

            fp["scenarios"] = self._scenario.describe()
            fp["scenario_defaults"] = {
                n: float(_param(n).default)
                for n in self._scenario.param_names()
                if n not in self.priors}
        return fp

    def _fingerprint_digest(self, n_trials):
        return hashlib.sha256(json.dumps(self.fingerprint(n_trials),
                                         sort_keys=True).encode()).hexdigest()

    @staticmethod
    def _check_manifest(out_dir, fp, resume):
        from ..runtime.journal import atomic_write_json

        path = os.path.join(out_dir, _MANIFEST_NAME)
        old = None
        if os.path.exists(path):
            try:
                with open(path) as f:
                    old = json.load(f)
            except json.JSONDecodeError:
                if resume:
                    raise RuntimeError(
                        f"manifest {path} exists but is unreadable; cannot "
                        "prove the out_dir holds this study. Use "
                        "resume=False to overwrite, or a fresh out_dir.")
        if old is not None and resume:
            mismatches = {k: (old.get(k), fp[k])
                          for k in fp if old.get(k) != fp[k]}
            if mismatches:
                raise StudyManifestError(out_dir, mismatches)
            merged = {**{k: v for k, v in old.items() if k not in fp}, **fp}
        else:
            merged = dict(fp)
        atomic_write_json(path, merged, indent=1)

    # -- the sweep ---------------------------------------------------------

    def run(self, n_trials, chunk_size=256, out_dir=None, resume=True,
            telemetry=None, progress=None, faults=None, keep_trials=True,
            integrity=None, _stop_after_chunks=None):
        """Run (or resume) the sweep; returns a
        :class:`~psrsigsim_torch.mc.StudyResult`.

        Args:
            n_trials: total trials of the study.
            chunk_size: trials per dispatch (every value yields
                bit-identical results).
            out_dir: enables the crash-safe journal + the result artifact
                (``study_result.json`` + ``trials.npy``); None runs in
                memory.
            resume: skip chunks the journal records as committed (verified
                by sha256 against ``trials.f32``); ``False`` starts clean.
            telemetry: optional
                :class:`~psrsigsim_torch.runtime.StageTimers` (stages
                dispatch/fetch/reduce/write; one is created otherwise and
                lands on the result + manifest).
            progress: optional callable ``progress(done, total)``.
            faults: optional :class:`~psrsigsim_torch.runtime.FaultPlan`
                (tests only; arms ``mc.kill`` — and, with ``integrity``,
                ``device.sdc`` / ``host.corrupt`` / ``disk.bitrot``).
            integrity: the silent-corruption defense
                (:mod:`psrsigsim_torch.runtime.integrity`): ``None``
                consults ``PSS_INTEGRITY`` (unset = off); when armed, each
                chunk's metric rows carry a device-computed digest
                re-checked on the host before the commit, a deterministic
                ``audit_frac`` of chunks is executed twice, disagreements
                heal by verified re-execution, the journal's commit
                records carry the device-attested ``dig`` claim, and the
                run stamps ``integrity`` counters into the manifest.
            keep_trials: write the per-trial metric matrix into the
                artifact.
            _stop_after_chunks: TESTING hook — stop cleanly after N fresh
                chunk commits (an interrupted sweep without a
                subprocess); returns None.
        """
        import time as _time

        from ..runtime.dist import is_leader
        from ..runtime.integrity import (device_digest_rows, digest_rows,
                                         maybe_bitrot, refuse_on_pod,
                                         resolve_integrity)
        from ..runtime.journal import (ChunkJournal, load_chunk_journal,
                                       remove_files, stamp_manifest)
        from ..runtime.telemetry import StageTimers
        from .results import StudyResult

        n_trials = int(n_trials)
        if n_trials <= 0:
            raise ValueError("n_trials must be positive")
        if telemetry is None:
            telemetry = StageTimers(extra_stages=("reduce",))
        M = len(self.metric_names)
        chunk_size = min(int(chunk_size), n_trials)
        if chunk_size <= 0:
            raise ValueError("chunk_size must be positive")
        # every chunk pads to the obs shards (the ensemble's rule)
        chunk_size = self.mesh.padded(chunk_size)
        width = chunk_size

        checker = resolve_integrity(
            integrity, fingerprint=self._fingerprint_digest(n_trials),
            faults=faults)
        refuse_on_pod(checker is not None, "sweeps")
        # under a pod every process computes the FULL result (the exchange
        # gives each the whole chunk), but exactly one owns the durable
        # side effects: manifest, journal, raw rows, cursor, artifact.
        # Followers read the same journal and rows for their resume
        # decisions — identical inputs, identical branches, which keeps
        # the pod in lockstep.
        lead = is_leader()

        matrix = np.empty((n_trials, M), np.float32)
        hist_tot = np.zeros((M, self.hist_bins), np.int64)
        mn_tot = np.full(M, np.inf, np.float32)
        mx_tot = np.full(M, -np.inf, np.float32)

        journal = raw_fd = None
        done = {}
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            journal_path = os.path.join(out_dir, _JOURNAL_NAME)
            cursor_path = os.path.join(out_dir, _CURSOR_NAME)
            raw_path = os.path.join(out_dir, _TRIALS_RAW)
            if lead:
                self._check_manifest(out_dir, self.fingerprint(n_trials),
                                     resume)
                if not resume:
                    remove_files(journal_path, cursor_path, raw_path)
                raw_fd = os.open(raw_path, os.O_RDWR | os.O_CREAT, 0o644)
                journal = ChunkJournal(journal_path, cursor_path,
                                       faults=faults)
            elif resume and os.path.exists(raw_path):
                # a follower reads the leader's rows, never writes them
                raw_fd = os.open(raw_path, os.O_RDONLY)
            if resume:
                # a follower never truncates the journal the live leader
                # appends to
                done = load_chunk_journal(journal_path, truncate=lead)

        commits = 0
        done_trials = 0

        def _report(count):
            nonlocal done_trials
            done_trials += count
            if progress is not None:
                progress(done_trials, n_trials)

        def _merge(start, count, rows, hist, mn, mx):
            nonlocal hist_tot, mn_tot, mx_tot
            t0 = _time.perf_counter()
            matrix[start:start + count] = rows
            hist_tot += np.asarray(hist, np.int64)
            mn_tot = np.minimum(mn_tot, mn)
            mx_tot = np.maximum(mx_tot, mx)
            telemetry.add("reduce", _time.perf_counter() - t0)

        def _resume_chunk(start, count, rec):
            """A journaled chunk: its rows from trials.f32 (sha-verified)
            and its integer accumulators from the journal line; False when
            the record does not check out (the chunk then recomputes —
            identical bytes land back in place)."""
            if raw_fd is None or int(rec.get("count", -1)) != count:
                return False
            nbytes = count * M * 4
            blob = os.pread(raw_fd, nbytes, start * M * 4)
            if len(blob) != nbytes:
                return False
            if hashlib.sha256(blob).hexdigest() != rec.get("sha"):
                return False
            rows = np.frombuffer(blob, np.float32).reshape(count, M)
            hist = np.asarray(rec["hist"], np.int64).reshape(
                M, self.hist_bins)
            mn = np.asarray(rec["mn"], np.float32)
            mx = np.asarray(rec["mx"], np.float32)
            _merge(start, count, rows, hist, mn, mx)
            return True

        def _commit(start, count, rows, hist, mn, mx, dig=None):
            """Durable record of one fresh chunk: rows land positionally in
            trials.f32 (pwrite + fsync), THEN the journal line, THEN the
            atomic cursor — a SIGKILL leaves either a committed record or
            none."""
            nonlocal commits
            commits += 1
            if journal is None:
                # an in-memory run, or a pod follower (the leader owns the
                # durable record)
                return
            t0 = _time.perf_counter()
            blob = rows.tobytes()
            os.pwrite(raw_fd, blob, start * M * 4)
            os.fsync(raw_fd)
            rec = {"e": "chunk", "start": int(start), "count": int(count),
                   "sha": hashlib.sha256(blob).hexdigest(),
                   "hist": [int(v) for v in np.asarray(hist).reshape(-1)],
                   "mn": [float(v) for v in mn],
                   "mx": [float(v) for v in mx]}
            if dig is not None:
                # the device-attested claim, checked equal before this
                # commit ran
                rec["dig"] = int(np.bitwise_xor.reduce(
                    np.asarray(dig, np.uint32)[:count]))
            journal.commit(rec)
            telemetry.add("write", _time.perf_counter() - t0)
            # disk.bitrot: decay THIS chunk's freshly journaled rows
            # (tests) — found by scrub_mc_dir / the sha-verifying resume,
            # never served as good
            maybe_bitrot(faults, raw_path, token=f"start={start}",
                         offset=start * M * 4)
            journal.maybe_kill("mc.kill", start)

        def _dispatch(start, count):
            """Launch one chunk: its device tensors and, on the card, the
            event that marks them complete."""
            with telemetry.span("dispatch", chunk=start):
                out = self._chunk_program(start, n_trials, width, count)
                if checker is not None:
                    # device.sdc perturbs the metric rows BEFORE the digest
                    # attests them (the corruption only the audit can see)
                    metrics = checker.apply_sdc(out[0], ident=start)
                    out = (metrics,) + tuple(out[1:]) \
                        + (device_digest_rows(metrics),)
                ready = None
                if out[0].is_cuda:
                    ready = torch.cuda.Event()
                    ready.record(torch.cuda.current_stream(out[0].device))
            telemetry.track_live(out)
            return out, ready

        def _host(dev):
            return tuple(t.cpu().numpy() for t in dev)

        def _integrity_verify(s0, c0, host):
            """The verdict on one fetched chunk (checksum lattice +
            sampled duplicate execution); returns the (possibly healed)
            host tuple ``(metrics, hist, mn, mx)`` and the trusted device
            digest."""
            metrics, hist, mn, mx, dig_dev = host
            metrics = checker.corrupt_host(metrics, ident=s0)

            def _reexec(audit):
                out = self._chunk_program(s0, n_trials, width, c0)
                return (lambda: _host(out),
                        device_digest_rows(out[0]).cpu().numpy())

            fetched, dig, event = checker.verify_chunk(
                dig_dev, (metrics, hist, mn, mx),
                lambda a: digest_rows(np.ascontiguousarray(a[0])), _reexec,
                producer="mc", ident=s0, rows=c0,
                evidence={"start": int(s0)})
            if event is not None and journal is not None:
                journal.append({"e": "integrity", "kind": event[0],
                                "start": int(s0), "healed": True,
                                "rows": event[1]})
            return tuple(fetched), dig

        def _fetch(start, dev, ready):
            """The chunk on the host.  ``fetch.wait`` is the wait for this
            chunk's own launches; the copies' ``.cpu()`` then also waits
            for whatever was launched behind it."""
            with telemetry.span("fetch", chunk=start) as sp:
                if ready is not None:
                    with span("wait"):
                        ready.synchronize()
                host = _host(dev)
                telemetry.untrack_live(dev)
                sp.nbytes = sum(a.nbytes for a in host)
            return host

        stopped = False
        try:
            # dispatch-ahead of one chunk: the device computes chunk N+1
            # while the host merges/journals chunk N
            inflight = []  # [(start, count, (device tensors, event))]

            def _drain_one():
                nonlocal stopped
                s0, c0, (dev, ready) = inflight.pop(0)
                host = _fetch(s0, dev, ready)
                del dev
                dig = None
                if checker is not None:
                    (metrics, hist, mn, mx), dig = _integrity_verify(
                        s0, c0, host)
                else:
                    metrics, hist, mn, mx = host
                rows = np.ascontiguousarray(metrics[:c0])
                _merge(s0, c0, rows, hist, mn, mx)
                _commit(s0, c0, rows, hist, mn, mx, dig=dig)
                _report(c0)
                if (_stop_after_chunks is not None
                        and commits >= _stop_after_chunks):
                    stopped = True

            for start in range(0, n_trials, chunk_size):
                count = min(chunk_size, n_trials - start)
                rec = done.get(start)
                if rec is not None and _resume_chunk(start, count, rec):
                    _report(count)
                    continue
                inflight.append((start, count, _dispatch(start, count)))
                if len(inflight) > 1:
                    _drain_one()
                    if stopped:
                        return None
            while inflight:
                _drain_one()
                if stopped:
                    return None
        finally:
            if journal is not None:
                journal.close()
            if raw_fd is not None:
                os.close(raw_fd)

        if checker is not None and out_dir is not None:
            # the sweep's integrity verdict joins the durable record
            stamp_manifest(os.path.join(out_dir, _MANIFEST_NAME),
                           integrity=checker.stats())

        telemetry.gauge("pod_leader", int(lead))
        result = StudyResult(
            metric_names=self.metric_names,
            param_names=self.param_names,
            metrics=matrix,
            hist=hist_tot,
            hist_ranges=dict(self._hist_ranges),
            minmax=(mn_tot, mx_tot),
            spec=self.fingerprint(n_trials),
            telemetry=telemetry.snapshot(),
        )
        if out_dir is not None and lead:
            result.save(out_dir, keep_trials=keep_trials)
        return result

    # -- host-side conveniences -------------------------------------------

    def sampled_params(self, n_trials, chunk=4096):
        """The FULL per-trial parameter table ``(n_trials, n_params)`` as
        host float32 — the same draws the trials run (they are made on the
        host in both), in chunks."""
        names = self.param_names
        n_trials = int(n_trials)
        out = np.empty((n_trials, len(names)), np.float32)
        if not names:
            return out
        for start in range(0, n_trials, chunk):
            idx = np.arange(start, min(start + chunk, n_trials))
            p = self._sample_params(self._trial_keys(idx), idx)
            out[idx[0]:idx[-1] + 1] = torch.stack(
                [p[n] for n in names], dim=1).numpy()
        return out

    def export_psrfits(self, n_trials, out_dir, template, *,
                       supervised=True, **export_kw):
        """Export the study's trials as PSRFITS through the streaming
        exporter — the dataset-generation exit path.

        Valid when the priors leave the pulse profile and nulling alone
        (``dm`` / ``noise_scale`` only): trial keys equal ensemble
        observation keys, so the exported files ARE the study's trials
        (same seed, with the sampled DMs and noise norms passed per
        observation).  Requires :meth:`from_simulation` construction.  The
        export manifest is stamped with this study's fingerprint digest
        (``mc_study`` key).
        """
        if self._simulation is None:
            raise RuntimeError(
                "export_psrfits needs a study built via from_simulation "
                "(the exporter rebuilds the ensemble from the Simulation)")
        unsupported = set(self.param_names) - {"dm", "noise_scale"}
        if unsupported:
            raise NotImplementedError(
                f"PSRFITS trial export supports only dm/noise_scale "
                f"priors (the ensemble's per-observation inputs); got "
                f"{sorted(unsupported)}")
        params = self.sampled_params(n_trials)
        dms = None
        noise_norms = None
        for j, name in enumerate(self.param_names):
            if name == "dm":
                dms = np.asarray(params[:, j], np.float64)
            elif name == "noise_scale":
                # multiply in float32, exactly as the trial does (f32 base
                # * f32 scale): the exported stream must be the trial's
                noise_norms = np.asarray(
                    np.float32(self.noise_norm) * params[:, j], np.float64)
        ens = self._simulation.to_ensemble(mesh=self.mesh)
        common = dict(seed=self.seed, dms=dms, noise_norms=noise_norms,
                      manifest_extra={
                          "mc_study": self._fingerprint_digest(n_trials)},
                      **export_kw)
        if supervised:
            from ..runtime import supervised_export

            return supervised_export(ens, int(n_trials), out_dir, template,
                                     ens.pulsar, **common)
        from ..io.export import export_ensemble_psrfits

        return export_ensemble_psrfits(ens, int(n_trials), out_dir,
                                       template, ens.pulsar, **common)
