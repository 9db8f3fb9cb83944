"""Fold-mode ensembles under the scenario engine, streamed to the host with
their RFI truth masks: ``FoldEnsemble(..., scenario=...).iter_chunks(...,
quantized=True, byte_order="big", rfi_mask=True, scenario_params=...)``,
the stream a labelled training set is exported from.

Traffic (the cell's parameters): as the stream driver's, ensembles of
``n_obs`` observations back to back, each under the next seed drawn from
the run's seed, every chunk and its mask released as it arrives.  The
configuration's ``scenario`` names the effects, ``scenario_params`` the
knobs every observation shares, and ``scenario_priors`` the knobs drawn
once per observation, with numpy, from the ensemble's seed
(:func:`knobs`).  A sample of the observations that reached the host,
drawn from the run's seed, is held to the plain reference
(``reference/scenario.py``) after the window: codes, DAT_SCL, DAT_OFFS
and the mask.
"""

from __future__ import annotations

import contextlib
import io
import time

import numpy as np
import torch

from .. import sampling
from ..objects import fold_signal, profile_data, telescope
from ..reference import keys as K
from ..reference import observations as O
from ..reference import scenario as S
from . import stream


def scenario_ensemble(config, device):
    """A ``FoldEnsemble`` of the configuration's pulsar under its scenario
    stack on ``device``, built as the stream's ensemble is."""
    from psrsigsim_torch.models.pulsar import DataProfile, Pulsar
    from psrsigsim_torch.parallel import FoldEnsemble

    sig = fold_signal(config, dm=config["dm"])
    with contextlib.redirect_stdout(io.StringIO()):
        psr = Pulsar(config["period_s"], config["smean_jy"],
                     DataProfile(profile_data(config), phases=None,
                                 Nchan=config["nchan"]),
                     name=config["pulsar"], seed=0)
    return FoldEnsemble(sig, psr, telescope(config), "BenchSys",
                        device=device, scenario=config["scenario"])


def knobs(config, seed, n_obs):
    """The ensemble's scenario knobs: the shared values, and one value per
    observation of each prior, drawn with numpy from the ensemble's seed
    in the configuration's order (``{name: float or (n_obs,) array}``)."""
    rng = np.random.default_rng(seed)
    out = dict(config["scenario_params"])
    for name, prior in config["scenario_priors"].items():
        if prior["dist"] != "uniform":
            raise ValueError(f"{name}: only uniform priors are drawn here")
        out[name] = rng.uniform(prior["lo"], prior["hi"], n_obs)
    return out


class Cell(stream.Cell):

    def setup(self):
        from psrsigsim_torch.runtime.telemetry import StageTimers

        p = self.params
        self.ens = scenario_ensemble(self.config, self.ctx.device)
        rng = np.random.default_rng(self.ctx.seed)
        self.seeds = rng.integers(0, 2**31 - 1, size=p["max_ensembles"] + 1)
        self.sample = sampling.Reservoir(p["check_obs"], rng,
                                         p.get("check_every", 1))
        self.timers = StageTimers()
        self.knobs = {}
        # warm-up: the window's chunk shape, options and scenario, under a
        # seed of its own
        for _, chunk in self._stream(p["warmup_chunks"] * p["chunk_size"],
                                     int(self.seeds[-1]), None):
            pass
        # the sample's buffers (codes, DAT_SCL, DAT_OFFS, mask), one
        # observation each, written (so paged in) now
        self.bufs = tuple(np.ones((p["check_obs"],) + a.shape[1:], a.dtype)
                          for a in chunk)

    def _stream(self, n_obs, seed, timers):
        p = self.params
        sp = knobs(self.config, seed, n_obs)
        self.knobs[seed] = sp
        return self.ens.iter_chunks(
            n_obs, chunk_size=p["chunk_size"], seed=seed, quantized=True,
            byte_order="big", prefetch=p["prefetch"],
            fetch_ahead=p["fetch_ahead"], timers=timers, rfi_mask=True,
            scenario_params=sp)

    def window(self, seconds):
        p = self.params
        t0 = time.perf_counter()
        deadline = t0 + seconds
        self.obs = self.chunks = 0
        t_end = None
        for e in range(p["max_ensembles"]):
            seed = int(self.seeds[e])
            gen = self._stream(p["n_obs"], seed, self.timers)
            try:
                while t_end is None:
                    with self.ctx.span("iter_chunks (dispatch, wait)"):
                        item = next(gen, None)
                    if item is None:
                        break
                    start, block = item
                    n = block[0].shape[0]
                    self.obs += n
                    self.chunks += 1
                    with self.ctx.span("consumer (keep sample)"):
                        self.sample.offer(
                            lambda i, slot: self._keep(
                                seed, start + i, slot,
                                *(a[i] for a in block)), n)
                    if time.perf_counter() >= deadline:
                        t_end = time.perf_counter()
            finally:
                gen.close()
            if t_end is not None:
                break
        self.elapsed = (t_end or time.perf_counter()) - t0
        self.attempted = self.obs

    def reference(self, geom, seed, idx, dtype=torch.float32):
        """The reference's codes, DAT_SCL, DAT_OFFS and mask of observation
        ``idx`` of the ensemble under ``seed``."""
        sp = self.knobs.get(seed)
        if sp is None:
            sp = self.knobs[seed] = knobs(self.config, seed,
                                          self.params["n_obs"])
        kn = {n: (v[idx] if np.ndim(v) else v) for n, v in sp.items()}
        c = self.config
        return S.observation(geom, K.stage_key(K.key(seed), "user", idx),
                             c["scenario"], kn, fcent_mhz=c["fcent_mhz"],
                             bw_mhz=c["bw_mhz"], sublen_s=c["sublen_s"],
                             device=self.ctx.device, dtype=dtype)

    def check(self):
        geom = O.single_pulsar(self.config, profile_data(self.config))
        data, scl, offs, mask = self.bufs
        got = [(s, i, data[k].view(">i2").astype(np.int16), scl[k], offs[k],
                mask[k]) for s, i, k in self.sample.items]
        return self.compare(geom, got)

    def control(self, dtype):
        """The checked numbers with the reference computed in ``dtype`` put
        in the program's place, on the observations this run kept."""
        geom = O.single_pulsar(self.config, profile_data(self.config))
        got = [(s, i) + tuple(t.cpu().numpy() for t in self.reference(
                   geom, s, i, dtype)) for s, i, _ in self.sample.items]
        return self.compare(geom, got)

    def compare(self, geom, got):
        """The checked numbers of observations ``got`` = ``[(seed, index,
        codes (nsub, nchan, nph), scl, offs, mask (nchan, nsub))]``: the
        stream's four (``stream.compare``) and the count of mask bits that
        differ from the reference's."""
        if not got:
            return [("checked_obs_missing", 1.0, 0.0)]
        worst = {"code_max_diff": 0.0, "code_diff_pct": 0.0,
                 "scl_max_rel": 0.0, "offs_max_steps": 0.0,
                 "rfi_mask_diff": 0.0}
        diff_n = total = 0
        for seed, idx, codes, scl, offs, mask in got:
            rc, rs, ro, rm = (t.cpu() for t in self.reference(geom, seed,
                                                              idx))
            d = (torch.from_numpy(np.ascontiguousarray(codes))
                 .to(torch.int32) - rc.to(torch.int32)).abs()
            worst["code_max_diff"] = max(worst["code_max_diff"],
                                         float(d.max()))
            diff_n += int((d > 0).sum())
            total += d.numel()
            s = torch.from_numpy(np.asarray(scl, np.float32))
            o = torch.from_numpy(np.asarray(offs, np.float32))
            worst["scl_max_rel"] = max(worst["scl_max_rel"],
                                       float(((s - rs).abs() / rs).max()))
            worst["offs_max_steps"] = max(worst["offs_max_steps"],
                                          float(((o - ro).abs() / rs).max()))
            worst["rfi_mask_diff"] += float(
                (torch.from_numpy(np.asarray(mask, bool)) != rm).sum())
        worst["code_diff_pct"] = 100.0 * diff_n / total
        return [(n, v, LIMITS[n]) for n, v in worst.items()]


# Limits, each between the largest reading of sound runs and the smallest
# reading of the control, above their geometric middle (PERF.md, section
# 2); the mask is the exact truth of the injection, so no bit may differ
LIMITS = {"code_max_diff": 1000.0, "code_diff_pct": 20.0,
          "scl_max_rel": 5e-3, "offs_max_steps": 500.0, "rfi_mask_diff": 0.0}
