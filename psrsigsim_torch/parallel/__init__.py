"""Ensembles (counterpart: psrsigsim_tpu/parallel/; this slice ports the
one-device fold ensemble — meshes and multi-device runs come later)."""

from .ensemble import FoldEnsemble

__all__ = ["FoldEnsemble"]
