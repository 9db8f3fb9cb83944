"""The chunked record sampler: (seed, record index) -> labeled record
(counterpart: psrsigsim_tpu/datasets/sampler.py, on one device).

One training record is composed from pieces the port already has:

* prior draws — :func:`psrsigsim_torch.mc.priors.sample_priors` on the
  dedicated ``"dataset"`` RNG stage, keyed per record as the study keys
  per trial (on the host, bit for bit the JAX package's draws);
* the SEARCH-mode observation — :func:`simulate.single_pipeline`, its two
  χ² fields from the flat whole-tile stream (the sampler kernel's flat
  layout on the card), with the scenario stack's SEARCH hooks;
* the labels — the scenario factors of
  :func:`~psrsigsim_torch.scenarios.registry.scenario_rows`, drawn once
  per chunk on the chunk's device: the injection, the RFI truth mask and
  the per-pulse energies read that one draw (the JAX package recomputes them
  in the same program from the same keys, which gives the same values),
  plus the sampled prior values themselves.

Where the JAX package vmaps one record over a chunk and shards it over a
mesh, the port runs the tile body once per ``(obs, chan)`` position of
its mesh (its records × its channels, on its device; no mesh is one
position on one device), assembled on the mesh's first device.
Record ``i``'s key is ``stage_key(key(seed), "user", i)`` — the
ensemble's observation-key derivation — and every step is per record, so
a record's bytes depend only on ``(seed, i)``: identical for any chunk
size or mesh, which the factory's kill/resume byte identity needs.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from ..mc.priors import parse_prior, sample_priors
from ..ops.stats import flat_chi2_ok, sampler_backend
from ..parallel.mesh import (CHAN_AXIS, MeshSlabs, check_chan_groups,
                             mesh_devices)
from ..scenarios.registry import scenario_rows
from ..simulate.pipeline import noise_level, single_pipeline
from ..utils.rng import key as make_key
from ..utils.rng import stage_key
from .spec import (PRIORS_FIELD, build_search_geometry, canonical_json,
                   knob_order, scenario_stack)

__all__ = ["RecordSampler"]

_F32 = torch.float32


class RecordSampler:
    """Record chunks for one canonical dataset spec.

    Parameters
    ----------
    canonical : dict
        A canonical spec from :func:`datasets.spec.canonicalize`.
    mesh : an ``(obs, chan)`` :class:`~psrsigsim_torch.parallel.Mesh`,
        optional: records split over ``obs`` (a chunk pads to the obs
        shards), channels over ``chan``; results land on the mesh's first
        device (a different ``device`` raises).  The bytes of every record
        are the mesh-free ones.
    device : str or torch.device, optional
        Where the records are simulated: the CUDA card by default (raises
        without one); ``"cpu"`` runs them on the host.
    """

    def __init__(self, canonical, mesh=None, device=None):
        self.mesh, self.device = mesh_devices(mesh, device)
        self.canonical = dict(canonical)
        self.stack = scenario_stack(canonical)
        self.cfg, profiles_np, self.noise_norm = build_search_geometry(
            canonical)
        self._profiles_np = np.ascontiguousarray(profiles_np, np.float32)
        self.seed = int(canonical["seed"])
        self.n_records = int(canonical["n_records"])

        #: canonical knob order (base knobs then enabled stack params)
        self.knobs = knob_order(canonical)
        #: the prior-varied subset, in knob order — the record's
        #: ``params`` label columns and the prior key-fold slot order
        self.priors = {k: parse_prior(s)
                       for k, s in canonical[PRIORS_FIELD].items()}
        self.param_names = tuple(k for k in self.knobs if k in self.priors)
        #: fixed per-corpus value of every knob (spec fields; a prior
        #: supersedes per record)
        self.fixed = {k: float(canonical[k]) for k in self.knobs}

        self._has_rfi = (self.stack is not None
                         and "rfi" in self.stack.names())
        self._has_sp = (self.stack is not None
                        and "single_pulse" in self.stack.names())

        dev = self.device
        self._profiles = torch.as_tensor(self._profiles_np, device=dev)
        self._freqs_np = np.asarray(self.cfg.meta.dat_freq_mhz(), np.float32)
        self._freqs = torch.as_tensor(self._freqs_np, device=dev)
        # global channel ids stay on the host (the sampler reads the first)
        self._chan_ids = torch.arange(self.cfg.meta.nchan)
        self._check_mesh()
        self._slabs = MeshSlabs(self.mesh, self._profiles, self._freqs)

        # the JAX package's program digest (its registry key), kept for
        # describe(): the canonical spec minus the corpus-shape fields,
        # plus the geometry the builder derived
        digest_src = {k: v for k, v in self.canonical.items()
                      if k not in ("seed", "n_records", "shards")}
        digest_src["_geometry"] = [int(self.cfg.nsub), int(self.cfg.nph),
                                   int(self.cfg.nsamp),
                                   float(self.noise_norm)]
        self._program_digest = hashlib.sha256(
            json.dumps(digest_src, sort_keys=True).encode()).hexdigest()

    def _check_mesh(self):
        """``Nchan`` divides over the chan axis; the 8-channel-group rule
        applies only where the tile's fields leave the flat stream (whose
        spans any channel split draws alike) for the kernel's rows."""
        cfg = self.cfg
        span_end = cfg.meta.nchan * cfg.nsamp
        rows = not (flat_chi2_ok(1.0, span_end=span_end)
                    and flat_chi2_ok(cfg.noise_df, span_end=span_end))
        check_chan_groups(cfg.meta.nchan, self.mesh.shape[CHAN_AXIS],
                          sampler_backend(self.device) if rows else None)

    def _tile(self, keys, dms, norms, rows):
        """The chunk's tiles ``(W, Nchan, nsamp)`` on the device: one
        ``single_pipeline`` batch per mesh position."""
        self._check_mesh()
        return self._slabs.run(
            lambda k, dn, r, p, f, c: single_pipeline(
                k, *dn, p, self.cfg, freqs=f, chan_ids=c, rows=r),
            keys, (dms, norms), rows, (0, 1), self.device)

    # -- record schema ------------------------------------------------------

    def field_layout(self):
        """Ordered per-record field descriptions ``(name, dtype, shape)``
        — the single schema source of the writer's byte layout, the shard
        index files and the reader.  Label fields of a disabled effect are
        absent, not zero-filled."""
        cfg = self.cfg
        fields = [("params", "<f4", (len(self.param_names),)),
                  ("scenario_params", "<f4",
                   (len(self.stack.param_names())
                    if self.stack is not None else 0,))]
        if self._has_sp:
            fields.append(("energies", "<f4", (cfg.nsub,)))
        if self._has_rfi:
            fields.append(("rfi_mask", "|u1", (cfg.meta.nchan, cfg.nsub)))
        fields.append(("tile", "<f4", (cfg.meta.nchan, cfg.nsamp)))
        return fields

    # -- the records ----------------------------------------------------------

    def _records(self, keys, idx):
        """The chunk's labeled records for host keys ``(W, 2)`` and global
        indices ``idx``: one tensor per field of :meth:`field_layout`, each
        ``(W, ...)`` on the device."""
        cfg, dev = self.cfg, self.device
        W = keys.shape[0]
        p = sample_priors(self.priors, self.param_names, keys,
                          torch.as_tensor(idx), stage="dataset")
        vals = {k: p[k] if k in p else torch.full(
            (W,), float(np.float32(self.fixed[k])), dtype=_F32)
            for k in self.knobs}
        # base * scale in float32, as the Monte-Carlo trial multiplies
        nn = vals["noise_scale"] * float(np.float32(self.noise_norm))
        nn_dev = nn.to(dev)
        rows = sc = None
        if self.stack is not None:
            sc = {n: vals[n] for n in self.stack.param_names()}
            # one host draw: the injection and both truth labels read it
            rows = scenario_rows(keys, self.stack, sc, cfg,
                                 noise_level(cfg, nn_dev),
                                 freqs=self._freqs_np,
                                 chan_ids=self._chan_ids)
        tile = self._tile(keys, vals["dm"].to(dev), nn_dev, rows)

        def columns(names, table):
            if not names:
                return torch.zeros((W, 0), dtype=_F32, device=dev)
            return torch.stack([table[n] for n in names], dim=1).to(dev)

        out = {"tile": tile, "params": columns(self.param_names, p),
               "scenario_params": columns(
                   self.stack.param_names() if sc else (), sc)}
        if self._has_sp:
            out["energies"] = rows.energy
        if self._has_rfi:
            # uint8 on the device, so the fetched bytes are the record's
            out["rfi_mask"] = rows.mask.to(torch.uint8)
        return tuple(out[name] for name, _, _ in self.field_layout())

    def chunk_width(self, chunk_size):
        """Records per chunk: ``chunk_size``, at most the corpus, rounded up
        to the mesh's obs shards (the ensemble's padding rule)."""
        chunk_size = min(int(chunk_size), self.n_records)
        if chunk_size <= 0:
            raise ValueError("chunk_size must be positive")
        return self.mesh.padded(chunk_size)

    def dispatch(self, start, width, audit=False):
        """Launch one chunk: device tensors for records ``start ..
        start+width`` (indices wrap modulo ``n_records``; the caller trims
        the wrapped tail).  The host's work (keys, priors, the scenario
        draws' launches) is done on return, the device's may still run.
        ``audit=True`` is a second launch of the same deterministic work,
        the integrity layer's duplicate execution
        (psrsigsim_torch/DIVERGENCES.md P10)."""
        idx = (int(start) + np.arange(int(width))) % self.n_records
        keys = stage_key(make_key(self.seed, "cpu"), "user",
                         torch.as_tensor(idx, dtype=torch.int64))
        return self._records(keys, idx)

    # -- host-side conveniences ---------------------------------------------

    def record_host(self, index):
        """One record as a host dict (label checks and tutorials): the
        factory's path at its narrowest width (1, or the obs shards)."""
        out = self.dispatch(int(index), self.chunk_width(1))
        return {name: a[0].cpu().numpy()
                for (name, _, _), a in zip(self.field_layout(), out)}

    def describe(self):
        """JSON-able sampler summary (manifests, shard indexes)."""
        return {
            "knobs": list(self.knobs),
            "param_names": list(self.param_names),
            "scenarios": (self.stack.describe()
                          if self.stack is not None else []),
            "fields": [{"name": n, "dtype": d, "shape": list(s)}
                       for n, d, s in self.field_layout()],
            "program_digest": self._program_digest,
            "canonical": canonical_json(self.canonical),
        }
