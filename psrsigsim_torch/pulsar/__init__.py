"""Reference-parity import alias: ``psrsigsim_torch.pulsar`` mirrors
``psrsigsim.pulsar`` (the implementation lives in models/pulsar)."""

from ..models.pulsar import (
    DataPortrait,
    DataProfile,
    GaussPortrait,
    GaussProfile,
    Pulsar,
    PulsePortrait,
    PulseProfile,
    UserPortrait,
    UserProfile,
)

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
