"""Reference-parity import alias: ``psrsigsim_torch.ism`` mirrors
``psrsigsim.ism``."""

from ..models.ism import ISM

__all__ = ["ISM"]
