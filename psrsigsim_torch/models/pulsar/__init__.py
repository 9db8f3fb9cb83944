"""Pulsar emission models (counterpart: psrsigsim_tpu/models/pulsar/)."""

from .portraits import DataPortrait, GaussPortrait, PulsePortrait, UserPortrait
from .profiles import DataProfile, GaussProfile, PulseProfile, UserProfile
from .pulsar import Pulsar

__all__ = [
    "Pulsar",
    "PulsePortrait",
    "GaussPortrait",
    "UserPortrait",
    "DataPortrait",
    "PulseProfile",
    "GaussProfile",
    "UserProfile",
    "DataProfile",
]
