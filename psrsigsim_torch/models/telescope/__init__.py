"""Telescope observation models (counterpart: psrsigsim_tpu/models/telescope/)."""

from .backend import Backend
from .receiver import Receiver, response_from_data
from .telescope import Arecibo, GBT, Telescope

__all__ = ["Telescope", "Receiver", "response_from_data", "Backend", "GBT", "Arecibo"]
