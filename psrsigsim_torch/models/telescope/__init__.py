"""Telescope models (counterpart: psrsigsim_tpu/models/telescope/)."""

from .backend import Backend
from .receiver import Receiver
from .telescope import GBT, Telescope

__all__ = ["Telescope", "GBT", "Receiver", "Backend"]
