"""Pulsar emission models (counterpart: psrsigsim_tpu/models/pulsar/; this
slice ports the portraits ``build_fold_config`` stages)."""

from .portraits import DataPortrait, GaussPortrait, PulsePortrait
from .profiles import DataProfile, GaussProfile
from .pulsar import Pulsar

__all__ = [
    "Pulsar",
    "PulsePortrait",
    "GaussPortrait",
    "DataPortrait",
    "GaussProfile",
    "DataProfile",
]
