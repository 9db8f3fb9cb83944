"""Fold-mode ensembles streamed to the host: ``FoldEnsemble.iter_chunks``
with quantized, big-endian chunks (the PSRFITS exporter's input stream).

Traffic (the cell's parameters): ensembles of ``n_obs`` observations
streamed back to back, each under the next seed drawn from the run's
seed, in chunks of ``chunk_size`` with ``prefetch`` and ``fetch_ahead``;
every host chunk is released as it arrives and nothing is written.  A
sample of the observations that reached the host, drawn from the seed, is
kept and held to the reference after the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..harness import CellBase
from ..objects import fold_ensemble, profile_data
from ..reference import fold as F
from ..reference import keys as K
from ..reference import observations as O
from .. import sampling


class Cell(CellBase):

    def setup(self):
        from psrsigsim_torch.runtime.telemetry import StageTimers

        p = self.params
        self.ens = fold_ensemble(self.config, self.ctx.device)
        rng = np.random.default_rng(self.ctx.seed)
        self.seeds = rng.integers(0, 2**31 - 1, size=p["max_ensembles"] + 1)
        self.sample = sampling.Reservoir(p["check_obs"], rng,
                                         p.get("check_every", 1))
        self.timers = StageTimers()
        # warm-up: the window's chunk shape and options, under a seed of
        # its own
        for _, chunk in self._stream(p["warmup_chunks"] * p["chunk_size"],
                                     int(self.seeds[-1]), None):
            pass
        # the sample's buffers, one observation each, written (so paged
        # in) now: a kept observation is copied into one in the window
        self.bufs = tuple(np.ones((p["check_obs"],) + a.shape[1:], a.dtype)
                          for a in chunk)

    def _stream(self, n_obs, seed, timers):
        p = self.params
        return self.ens.iter_chunks(
            n_obs, chunk_size=p["chunk_size"], seed=seed, quantized=True,
            byte_order="big", prefetch=p["prefetch"],
            fetch_ahead=p["fetch_ahead"], timers=timers)

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
                    start, (data, scl, offs) = item
                    n = data.shape[0]
                    self.obs += n
                    self.chunks += 1
                    with self.ctx.span("consumer (keep sample)"):
                        self.sample.offer(
                            lambda i, slot: self._keep(seed, start + i,
                                                       slot, data[i],
                                                       scl[i], offs[i]), n)
                    if time.perf_counter() >= deadline:
                        t_end = time.perf_counter()
            finally:
                gen.close()
            if t_end is not None:
                break
        self.elapsed = (t_end or time.perf_counter()) - t0
        self.attempted = self.obs

    def _keep(self, seed, index, slot, *arrays):
        for buf, a in zip(self.bufs, arrays):
            np.copyto(buf[slot], a)
        return seed, index, slot

    def end_to_end(self):
        return {"obs_per_s": self.obs / self.elapsed}

    def record(self):
        return {"timers": self.timers.snapshot(), "chunks": self.chunks,
                "obs": self.obs, "elapsed_s": self.elapsed,
                "chunk_obs": self.params["chunk_size"],
                "geometry": (self.config["nchan"],
                             int(round(self.config["tobs_s"]
                                       / self.config["sublen_s"])),
                             int(self.config["sample_rate_mhz"]
                                 * self.config["period_s"] * 1e6))}

    def free(self):
        del self.ens

    def check(self):
        geom = O.single_pulsar(self.config, profile_data(self.config))
        data, scl, offs = self.bufs
        got = [(s, i, data[k].view(">i2").astype(np.int16), scl[k], offs[k])
               for s, i, k in self.sample.items]
        return compare(geom, got, self.ctx.device)

    def control(self, dtype):
        """The checked numbers with the reference computed in ``dtype`` put
        in the program's place, on the observations this run kept."""
        geom = O.single_pulsar(self.config, profile_data(self.config))
        got = [(s, i) + tuple(t.cpu().numpy() for t in reference_codes(
                   geom, s, i, self.ctx.device, dtype))
               for s, i, _ in self.sample.items]
        return compare(geom, got, self.ctx.device)


def reference_codes(geom, seed, idx, device, dtype=torch.float32):
    """The reference's codes, DAT_SCL and DAT_OFFS of observation ``idx``
    of the ensemble under ``seed``."""
    k = K.stage_key(K.key(seed), "user", idx)
    x = O.observation(geom, k, device, dtype)
    return F.quantize(x, geom.nsub, geom.nph)


def compare(geom, got, device):
    """The checked numbers of observations ``got`` = ``[(seed, index,
    codes (nsub, nchan, nph), scl, offs)]`` against the reference: the largest code difference, the share of codes that
    differ, and the largest DAT_SCL and DAT_OFFS differences in units of
    the reference's DAT_SCL (one code step)."""
    worst = {"code_max_diff": 0.0, "code_diff_pct": 0.0,
             "scl_max_rel": 0.0, "offs_max_steps": 0.0}
    if not got:
        return [("checked_obs_missing", 1.0, 0.0)]
    diff_n = total = 0
    for seed, idx, codes, scl, offs in got:
        rc, rs, ro = (t.cpu() for t in reference_codes(geom, seed, idx,
                                                        device))
        d = (torch.from_numpy(np.ascontiguousarray(codes)).to(torch.int32)
             - rc.to(torch.int32)).abs()
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
    worst["code_diff_pct"] = 100.0 * diff_n / total
    return [(n, v, LIMITS[n]) for n, v in worst.items()]


# Limits, each between the largest reading of sound runs and the smallest
# reading of the control (PERF.md, section 2)
LIMITS = {"code_max_diff": 100.0, "code_diff_pct": 10.0,
          "scl_max_rel": 3e-4, "offs_max_steps": 10.0}
