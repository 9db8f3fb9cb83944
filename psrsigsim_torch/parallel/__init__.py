"""Ensembles (counterpart: psrsigsim_tpu/parallel/; the one-device fold
ensemble and the multi-pulsar ensemble — meshes and multi-device runs come
later)."""

from .ensemble import (FoldEnsemble, MultiPulsarFoldEnsemble,
                       build_width_bucket_fn)

__all__ = ["FoldEnsemble", "MultiPulsarFoldEnsemble", "build_width_bucket_fn"]
