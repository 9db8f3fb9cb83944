"""Signal configuration (counterpart: psrsigsim_tpu/signal/)."""

from .signals import BaseSignal, FilterBankSignal
from .state import FLOAT32, INT8, SignalMeta

__all__ = ["BaseSignal", "FilterBankSignal", "SignalMeta", "FLOAT32", "INT8"]
