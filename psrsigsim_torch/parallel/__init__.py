"""Ensembles, meshes and sequence sharding (counterpart:
psrsigsim_tpu/parallel/): the fold ensemble and the multi-pulsar ensemble
on one device or over an ``(obs, chan)`` mesh, and the time-sharded SEARCH
and baseband pipelines — single-process meshes (pods come later)."""

from .ensemble import (FoldEnsemble, MultiPulsarFoldEnsemble,
                       build_width_bucket_fn)
from .mesh import (
    CHAN_AXIS,
    OBS_AXIS,
    Mesh,
    batch_sharding,
    distributed_init,
    make_mesh,
    replicated_sharding,
    shard_batch,
)
from .seqshard import (
    SEQ_AXIS,
    SEQ_RNG_BLOCK,
    blocked_chan_chi2,
    blocked_chan_normal,
    dispersion_halo_samples,
    make_obs_seq_mesh,
    make_seq_mesh,
    seq_sharded_baseband,
    seq_sharded_dedisperse,
    seq_sharded_search,
    seq_sharded_search_ensemble,
)

__all__ = [
    "FoldEnsemble",
    "MultiPulsarFoldEnsemble",
    "build_width_bucket_fn",
    "Mesh",
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "distributed_init",
    "OBS_AXIS",
    "CHAN_AXIS",
    "SEQ_AXIS",
    "SEQ_RNG_BLOCK",
    "make_seq_mesh",
    "seq_sharded_search",
    "seq_sharded_baseband",
    "seq_sharded_dedisperse",
    "seq_sharded_search_ensemble",
    "make_obs_seq_mesh",
    "dispersion_halo_samples",
    "blocked_chan_chi2",
    "blocked_chan_normal",
]
