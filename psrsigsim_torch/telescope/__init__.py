"""Reference-parity import alias: ``psrsigsim_torch.telescope`` mirrors
``psrsigsim.telescope``."""

from ..models.telescope import (
    Arecibo,
    Backend,
    GBT,
    Receiver,
    Telescope,
    response_from_data,
)

__all__ = ["Telescope", "Receiver", "response_from_data", "Backend", "GBT", "Arecibo"]
