"""The Monte-Carlo TOA study: ``MonteCarloStudy.from_simulation(
Simulation(...), priors, seed).run(n_trials, chunk_size)`` in memory.

Traffic (the cell's parameters): studies of ``n_trials`` trials in chunks
of ``chunk_size`` under the ``priors``, back to back, each under the next
seed drawn from the run's seed.  A trial is counted when its chunk's rows
reach the host (the study's progress report); the study running at the
window's close is stopped there.  A sample of the trials of the studies
that completed in the window, drawn from the seed, is held to the
reference after the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import sampling
from ..harness import CellBase
from ..objects import profile_data
from ..reference import fold as F
from ..reference import observations as O
from ..reference import toa as T


class _WindowClosed(Exception):
    pass


def simulation(config, device):
    """The configuration as a ``Simulation`` (its psrdict)."""
    from psrsigsim_torch.simulate import Simulation

    t = config["telescope"]
    psrdict = dict(
        fcent=config["fcent_mhz"], bandwidth=config["bw_mhz"],
        sample_rate=config["sample_rate_mhz"], Nchan=config["nchan"],
        fold=True, sublen=config["sublen_s"], tobs=config["tobs_s"],
        period=config["period_s"], Smean=config["smean_jy"],
        name=config["pulsar"], profiles=profile_data(config),
        dm=config["dm"], tscope_name="BenchScope", aperture=t["aperture_m"],
        area=t["area_m2"], Tsys=t["tsys_k"], system_name="BenchSys",
        rcvr_fcent=config["fcent_mhz"], rcvr_bw=config["bw_mhz"],
        rcvr_name="Rcvr", backend_samprate=t["backend_samprate_mhz"],
        backend_name="Back", seed=0)
    return Simulation(psrdict=psrdict, device=device)


class Cell(CellBase):

    def setup(self):
        from psrsigsim_torch.mc import MonteCarloStudy
        from psrsigsim_torch.runtime.telemetry import StageTimers

        p = self.params
        self.MonteCarloStudy = MonteCarloStudy
        self.sim = simulation(self.config, self.ctx.device)
        rng = np.random.default_rng(self.ctx.seed)
        self.seeds = rng.integers(0, 2**31 - 1, size=p["max_studies"] + 1)
        self.sample = sampling.Reservoir(p["check_trials"], rng)
        self.timers = StageTimers(extra_stages=("reduce",))
        # warm-up: two chunks of a study under a seed of its own
        study = MonteCarloStudy.from_simulation(
            self.sim, p["priors"], seed=int(self.seeds[-1]))
        study.run(2 * p["chunk_size"], chunk_size=p["chunk_size"])

    def window(self, seconds):
        p = self.params
        t0 = time.perf_counter()
        deadline = t0 + seconds
        self.trials = self.chunks = 0
        self.studies = []
        t_end = None

        def progress(done, total):
            # each report is one chunk whose rows reached the host
            self.chunks += 1
            self.trials = base + done
            if time.perf_counter() >= deadline:
                raise _WindowClosed

        for s in range(p["max_studies"]):
            seed = int(self.seeds[s])
            base = self.trials
            study = self.MonteCarloStudy.from_simulation(
                self.sim, p["priors"], seed=seed)
            try:
                with self.ctx.span("study run (host keys, priors, chunks)"):
                    res = study.run(p["n_trials"],
                                    chunk_size=p["chunk_size"],
                                    telemetry=self.timers, progress=progress)
            except _WindowClosed:
                t_end = time.perf_counter()
                break
            self.studies.append((seed, study.metric_names, res.metrics))
        self.elapsed = (t_end or time.perf_counter()) - t0
        self.attempted = self.trials

    def end_to_end(self):
        return {"trials_per_s": self.trials / self.elapsed}

    def record(self):
        n = self.config["tobs_s"] / self.config["sublen_s"]
        nph = int(self.config["sample_rate_mhz"] * self.config["period_s"]
                  * 1e6)
        return {"timers": self.timers.snapshot(), "chunks": self.chunks,
                "trials": self.trials, "elapsed_s": self.elapsed,
                # each chunk draws two fields of chunk_size x nchan x nsamp
                "k1_launches_per_chunk": [(self.params["chunk_size"],
                                           self.config["nchan"],
                                           int(round(n)) * nph)] * 2}

    def free(self):
        for seed, names, rows in self.studies:
            self.sample.offer(
                lambda i, _, seed=seed, names=names, rows=rows: (
                    seed, i, dict(zip(names, rows[i].tolist()))),
                rows.shape[0])
        del self.sim, self.studies

    def check(self):
        return compare(self.config, self.params, self.sample.items,
                       self.ctx.device)

    def control(self, dtype):
        """The checked numbers with the reference computed in ``dtype`` put
        in the program's place, on the trials this run kept."""
        got = [(seed, i, reference_row(self.config, self.params, seed, i,
                                       self.ctx.device, dtype))
               for seed, i, _ in self.sample.items]
        return compare(self.config, self.params, got, self.ctx.device)


def reference_row(config, params, seed, trial, device, dtype=torch.float32):
    """The reference's metric row of one trial: its prior draws, then
    ``toa_err`` (the band's inverse-variance mean of the channels' FFTFIT
    shifts less the known dispersion delay), ``toa_rms``, ``toa_sigma``
    and ``fit_amp``."""
    geom = O.single_pulsar(config, profile_data(config))
    order = [k for k in ("dm", "noise_scale") if k in params["priors"]]
    tk, p = T.trial_params(params["priors"], order, seed, trial,
                           None if dtype == torch.float32 else dtype)
    dm = p.get("dm", np.float32(geom.dm))
    scale = p.get("noise_scale", np.float32(1.0))
    g = O.Geometry(**dict(geom.__dict__, dm=float(dm),
                          norm=float(np.float32(scale)
                                     * np.float32(geom.norm))))
    x = O.observation(g, tk, device, dtype)
    folded = F.fold_subints(x, g.nsub, g.nph).double().cpu().numpy()
    shift, sigma, b = T.fftfit(folded, geom.portrait)
    delays = F.delays_ms(np.float32(dm), geom.freqs, "cpu").double().numpy()
    expect = np.mod(delays / (config["period_s"] * 1e3) + 0.5, 1.0) - 0.5
    resid = np.mod(shift - expect + 0.5, 1.0) - 0.5
    comb, comb_sigma = T.combine(resid, sigma)
    row = {k: float(v) for k, v in p.items()}
    row.update(toa_err=float(comb), toa_rms=float(np.sqrt(np.mean(
        resid * resid))), toa_sigma=float(comb_sigma),
        fit_amp=float(np.mean(b)))
    return row


def compare(config, params, got, device):
    """The checked numbers of trials ``got`` = ``[(seed, trial, {metric:
    value})]`` against the reference: the largest relative error of the
    prior draws, of ``toa_rms``, ``toa_sigma`` and ``fit_amp``, and the
    largest ``toa_err`` error in units of the trial's ``toa_sigma``."""
    if not got:
        return [("checked_trials_missing", 1.0, 0.0)]
    worst = {"params_max_rel": 0.0, "toa_err_sigmas": 0.0,
             "toa_rms_rel": 0.0, "toa_sigma_rel": 0.0, "fit_amp_rel": 0.0}
    for seed, trial, row in got:
        ref = reference_row(config, params, seed, trial, device)
        for k in params["priors"]:
            worst["params_max_rel"] = max(
                worst["params_max_rel"], abs(row[k] - ref[k]) / abs(ref[k]))
        worst["toa_err_sigmas"] = max(
            worst["toa_err_sigmas"],
            abs(row["toa_err"] - ref["toa_err"]) / ref["toa_sigma"])
        for k in ("toa_rms", "toa_sigma", "fit_amp"):
            worst[k + "_rel"] = max(worst[k + "_rel"],
                                    abs(row[k] - ref[k]) / abs(ref[k]))
    return [(n, v, LIMITS[n]) for n, v in worst.items()]


# Limits, each between the largest reading of sound runs and the smallest
# reading of the control (PERF.md, section 2)
LIMITS = {"params_max_rel": 3e-5, "toa_err_sigmas": 0.5,
          "toa_rms_rel": 0.05, "toa_sigma_rel": 1.5e-3, "fit_amp_rel": 3e-5}
