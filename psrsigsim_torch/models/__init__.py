"""Physical models: pulsar, ISM and telescope (counterpart:
psrsigsim_tpu/models/)."""

from . import ism, pulsar, telescope

__all__ = ["pulsar", "ism", "telescope"]
