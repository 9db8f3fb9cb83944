"""Signal data model: the signal state and the reference-parity signal
classes (counterpart: psrsigsim_tpu/signal/)."""

from .signals import (
    BasebandSignal,
    BaseSignal,
    FilterBankSignal,
    RFSignal,
    Signal,
)
from .state import FLOAT32, INT8, SignalMeta, SignalState, empty_state

__all__ = [
    "Signal",
    "BaseSignal",
    "RFSignal",
    "BasebandSignal",
    "FilterBankSignal",
    "SignalMeta",
    "SignalState",
    "FLOAT32",
    "INT8",
    "empty_state",
]
