"""Fold-mode ensembles in short subintegrations, streamed to the host: the
stream's traffic (``FoldEnsemble.iter_chunks`` with quantized, big-endian
chunks) on a configuration whose subints fold fewer than 50 pulses, so
that both chi-square fields take the exact branch, ``2 * gamma(key,
Nfold / 2)`` over the blocked keys, and the unfused fold, quantize and
pack.  Nothing but the configuration's Nfold picks that route: set-up
refuses a run where an environment switch could pick it, or where the
fused route would run.

After the window the kept observations are held to the plain gamma
reference (``reference/gamma.py``) with the stream's four numbers.  A
sample whose draw the reference finds within rounding of an accept or
reject threshold is compared with whichever of its outcomes lies nearer
the program's (``gamma.closest``); the count of such samples taken the
other way is logged.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..objects import profile_data
from ..reference import fold as F
from ..reference import gamma as G
from ..reference import keys as K
from ..reference import observations as O
from . import stream

# environment switches that could send a chunk down the exact branch or
# the unfused body without the configuration's df
SWITCHES = ("PSS_EXACT_CHI2", "PSS_SAMPLER")


class Cell(stream.Cell):

    def setup(self):
        from psrsigsim_torch.simulate.pipeline import fused_route

        cuda = torch.device(self.ctx.device).type == "cuda"
        # on the host the benchmark's tests pick the card's sampler
        # (``PSS_SAMPLER=hw``), which this route never reads
        for name in SWITCHES if cuda else SWITCHES[:1]:
            if os.environ.get(name) is not None:
                raise RuntimeError(f"{name} is set: the exact cell runs "
                                   f"on the configuration's df alone")
        if self.config["sublen_s"] / self.config["period_s"] >= 50:
            raise ValueError("the exact cell needs Nfold below 50")
        super().setup()
        if fused_route(self.ens.cfg, self.ctx.device):
            raise RuntimeError("Nfold below 50 must take the unfused route")

    def record(self):
        return dict(super().record(), nfold=self.config["sublen_s"]
                    / self.config["period_s"])

    def reference(self, geom, seed, idx, dtype=torch.float32):
        """The reference's :class:`~benchmark.reference.gamma.Observation`
        of observation ``idx`` of the ensemble under ``seed``."""
        return G.observation(geom, K.stage_key(K.key(seed), "user", idx),
                             self.ctx.device, dtype)

    def check(self):
        geom = O.single_pulsar(self.config, profile_data(self.config))
        data, scl, offs = self.bufs
        got = [(s, i, data[k].view(">i2").astype(np.int16), scl[k], offs[k])
               for s, i, k in self.sample.items]
        return self.compare(geom, got)

    def control(self, dtype):
        """The checked numbers with the reference computed in ``dtype`` put
        in the program's place, on the observations this run kept."""
        geom = O.single_pulsar(self.config, profile_data(self.config))
        got = [(s, i) + tuple(t.cpu().numpy() for t in F.quantize(
                   self.reference(geom, s, i, dtype).x, geom.nsub, geom.nph))
               for s, i, _ in self.sample.items]
        return self.compare(geom, got)

    def compare(self, geom, got):
        """The stream's four numbers (``stream.compare``) of observations
        ``got`` = ``[(seed, index, codes (nsub, nchan, nph), scl, offs)]``
        against the reference, each marginal sample taken at its outcome
        nearest the program's dequantized value."""
        if not got:
            return [("checked_obs_missing", 1.0, 0.0)]
        worst = {"code_max_diff": 0.0, "code_diff_pct": 0.0,
                 "scl_max_rel": 0.0, "offs_max_steps": 0.0}
        diff_n = total = flips = marginal = 0
        for seed, idx, codes, scl, offs in got:
            obs = self.reference(geom, seed, idx)
            c = torch.from_numpy(np.ascontiguousarray(codes)).to(torch.int32)
            s = torch.from_numpy(np.asarray(scl, np.float32))
            o = torch.from_numpy(np.asarray(offs, np.float32))
            x_prog = (c.to(torch.float64) * s.double()[..., None]
                      + o.double()[..., None])
            x_prog = x_prog.transpose(0, 1).reshape(geom.nchan, geom.nsamp)
            step = s.T[..., None].expand(geom.nchan, geom.nsub, geom.nph)
            x, n = G.closest(obs, x_prog, step)
            flips += n
            marginal += int(obs.alt_at.numel())
            rc, rs, ro = F.quantize(x, geom.nsub, geom.nph)
            d = (c - rc.to(torch.int32)).abs()
            worst["code_max_diff"] = max(worst["code_max_diff"],
                                         float(d.max()))
            diff_n += int((d > 0).sum())
            total += d.numel()
            worst["scl_max_rel"] = max(worst["scl_max_rel"],
                                       float(((s - rs).abs() / rs).max()))
            worst["offs_max_steps"] = max(worst["offs_max_steps"],
                                          float(((o - ro).abs() / rs).max()))
        worst["code_diff_pct"] = 100.0 * diff_n / total
        print(f"exact: {flips} of {marginal} marginal samples took another "
              f"draw in {len(got)} observations", file=sys.stderr)
        return [(n, v, LIMITS[n]) for n, v in worst.items()]


# Limits, each between the largest reading of sound runs and the smallest
# reading of the two controls (the reference in bfloat16; the program with
# the exact branch left out, drawing Wilson-Hilferty at the same df),
# above their geometric middle (PERF.md, section 2)
LIMITS = {"code_max_diff": 1000.0, "code_diff_pct": 20.0,
          "scl_max_rel": 5e-3, "offs_max_steps": 100.0}
