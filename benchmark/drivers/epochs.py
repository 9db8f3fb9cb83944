"""The multi-pulsar ensemble: ``MultiPulsarFoldEnsemble.run(epochs, seed,
epoch_start)`` over a population of pulsars, outputs left on the card.

Traffic (the cell's parameters): calls of ``epochs_per_call`` epochs of
every pulsar, ``epoch_chunk`` epochs a pass, ``epoch_start`` advancing by
one call's epochs from an epoch drawn from the run's seed and wrapping at
the configuration's ``n_epochs``; each call's outputs are dropped when the
next call returns.  A sample of the pulsar-epochs the window produced,
drawn from the seed, is kept on the card and held to the reference after
the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import sampling
from ..harness import CellBase
from ..objects import msp_population, multipulsar_ensemble
from ..reference import keys as K
from ..reference import observations as O


class Cell(CellBase):

    def setup(self):
        p = self.params
        self.ens = multipulsar_ensemble(self.config, p["epoch_chunk"],
                                        self.ctx.device)
        rng = np.random.default_rng(self.ctx.seed)
        self.run_seed = int(rng.integers(0, 2**31 - 1))
        warm_seed = int(rng.integers(0, 2**31 - 1))
        self.calls_per_cycle = self.config["n_epochs"] // p["epochs_per_call"]
        self.call0 = int(rng.integers(self.calls_per_cycle))
        self.sample = sampling.Reservoir(p["check_obs"], rng,
                                         p.get("check_every", 1))
        for i in range(p["warmup_calls"]):
            self.ens.run(p["epochs_per_call"], warm_seed,
                         epoch_start=i * p["epochs_per_call"])
        self._sync()

    def _sync(self):
        if torch.device(self.ctx.device).type == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds):
        E = self.params["epochs_per_call"]
        t0 = time.perf_counter()
        deadline = t0 + seconds
        self.calls = 0
        while time.perf_counter() < deadline:
            e0 = ((self.call0 + self.calls) % self.calls_per_cycle) * E
            with self.ctx.span("run (host keys, staging, launches)"):
                out = self.ens.run(E, self.run_seed, epoch_start=e0)
            with self.ctx.span("consumer (keep sample)"):
                self.sample.offer(
                    lambda i, _: (i // E, e0 + i % E,
                               out[i // E][i % E].clone()), len(out) * E)
            del out
            self.calls += 1
        with self.ctx.span("synchronize"):
            self._sync()
        self.elapsed = time.perf_counter() - t0
        self.attempted = self.calls * len(self.ens.workloads) * E

    def end_to_end(self):
        return {"pulsar_epochs_per_s": self.attempted / self.elapsed}

    def record(self):
        E = self.params["epochs_per_call"]
        chunk = self.params["epoch_chunk"]
        # the sampler's launches of one call: two fields per bucket and
        # epoch chunk, (pulsars of the bucket x chunk epochs) rows each
        buckets = {}
        for g in O.population(self.config, msp_population(self.config)):
            key = (g.nchan, g.nsamp)
            buckets[key] = buckets.get(key, 0) + 1
        launches = []
        for (nchan, nsamp), members in buckets.items():
            for e in range(0, E, chunk):
                launches += [(members * min(chunk, E - e), nchan, nsamp)] * 2
        return {"calls": self.calls, "elapsed_s": self.elapsed,
                "k1_launches_per_call": launches}

    def free(self):
        del self.ens

    def check(self):
        geoms = O.population(self.config, msp_population(self.config))
        got = [(p, e, block) for p, e, block in self.sample.items]
        return compare(geoms, self.run_seed, got, self.ctx.device)

    def control(self, dtype):
        """The checked numbers with the reference computed in ``dtype`` put
        in the program's place, on the pulsar-epochs this run kept."""
        geoms = O.population(self.config, msp_population(self.config))
        root = K.key(self.run_seed)
        got = [(p, e, O.observation(
                    geoms[p], K.fold_in(K.stage_key(root, "user", p), e),
                    self.ctx.device, dtype))
               for p, e, _ in self.sample.items]
        return compare(geoms, self.run_seed, got, self.ctx.device)


def compare(geoms, seed, got, device):
    """The checked numbers of pulsar-epochs ``got`` = ``[(pulsar, epoch,
    block)]`` against the reference: the largest
    sample error over the block's largest value, and the mean absolute
    error over the mean absolute value."""
    if not got:
        return [("checked_obs_missing", 1.0, 0.0)]
    root = K.key(seed)
    worst = {"max_err_rel": 0.0, "mean_err_rel": 0.0}
    for p, e, block in got:
        k = K.fold_in(K.stage_key(root, "user", p), e)
        ref = O.observation(geoms[p], k, device)
        x = block.to(ref.device)
        err = (x - ref).abs()
        worst["max_err_rel"] = max(worst["max_err_rel"],
                                   float(err.max() / ref.abs().max()))
        worst["mean_err_rel"] = max(worst["mean_err_rel"],
                                    float(err.mean() / ref.abs().mean()))
    return [(n, v, LIMITS[n]) for n, v in worst.items()]


# Limits, each between the largest reading of sound runs and the smallest
# reading of the control (PERF.md, section 2)
LIMITS = {"max_err_rel": 6e-5, "mean_err_rel": 1e-5}
