"""SEARCH-mode dataset factory: labeled ML training corpora (counterpart:
psrsigsim_tpu/datasets/).

Scenario-randomized SEARCH observations stream from device buffers into
sharded, label-carrying training records — raw SEARCH tile + RFI
contamination mask + injection/scenario parameters + per-pulse energies
— with no PSRFITS round-trip.  Every effect registered with the scenario
engine (:mod:`psrsigsim_torch.scenarios`) becomes a labeled class in the
corpus: its ground truth is the same draw as the injection.

- :mod:`~psrsigsim_torch.datasets.spec` — strict canonical dataset specs
  with a fingerprint hash (the corpus identity, the JAX package's).
- :mod:`~psrsigsim_torch.datasets.sampler` — the chunked record sampler:
  per-record priors on the ``"dataset"`` RNG stage + the flat-tile SEARCH
  pipeline + the scenario's truth labels, one chunk a batch on one
  device.
- :mod:`~psrsigsim_torch.datasets.writer` — dependency-free
  length-prefixed record shards with per-shard JSON indexes,
  deterministic ``(seed, shard, epoch)`` read-time shuffling, and a
  self-describing reader (host only, no torch).
- :mod:`~psrsigsim_torch.datasets.factory` — the crash-safe run loop:
  journal/cursor commits (SIGKILL-resumable, byte-identical even across
  changed chunk sizes), stage telemetry, manifest fingerprint guard.

``DatasetFactory(spec, device="cuda").run(out_dir, chunk_size=...)``
writes a corpus on the card; ``mesh=`` (a single-process ``(obs, chan)``
mesh) writes the same bytes.
"""

# the tensor modules load on first use: the record writer and reader
# (:mod:`.writer`) are host only and must not pay for importing torch
_LAZY = {"DatasetFactory": "factory", "DatasetManifestError": "factory",
         "RecordSampler": "sampler", "DatasetSpecError": "spec",
         "RECORD_FORMAT_VERSION": "spec", "canonicalize": "spec",
         "fingerprint_hash": "spec", "DatasetReader": "writer",
         "shuffled_order": "writer"}


def __getattr__(name):
    import importlib

    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)


__all__ = [
    "DatasetFactory",
    "DatasetManifestError",
    "DatasetReader",
    "DatasetSpecError",
    "RECORD_FORMAT_VERSION",
    "RecordSampler",
    "canonicalize",
    "fingerprint_hash",
    "shuffled_order",
]
