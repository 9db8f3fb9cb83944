"""Carrying staged state across from the JAX package.

The JAX package stages a fold geometry as a frozen ``FoldPipelineConfig``,
a float32 portrait and a noise scale.  :func:`config_from_reference` takes
them in plain form — ``dataclasses.asdict(cfg)``, the numpy portrait and
the float — and builds the port's config and device tensor, so both
packages can be fed the same staged state (and the same keys, as
``(2,)`` uint32 key-data arrays; see :func:`psrsigsim_torch.utils.as_key`).
Nothing here imports the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .signal.state import SignalMeta
from .simulate.pipeline import FoldPipelineConfig
from .utils.device import resolve_device

__all__ = ["config_from_reference"]


def config_from_reference(fields, profiles, noise_norm, device=None):
    """``(cfg, profiles, noise_norm)`` for the port from the reference's
    ``dataclasses.asdict(cfg)``, ``profiles_np`` and ``noise_norm``.

    Every field must be one the port's :class:`FoldPipelineConfig` knows;
    an unknown one raises instead of being dropped.
    """
    fields = dict(fields)
    meta = fields.pop("meta")
    if isinstance(meta, dict):
        meta = SignalMeta(**meta)
    known = {f.name for f in dataclasses.fields(FoldPipelineConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"unknown FoldPipelineConfig field(s) {unknown}")
    cfg = FoldPipelineConfig(meta=meta, **fields)
    prof = torch.as_tensor(np.ascontiguousarray(profiles, np.float32),
                           device=resolve_device(device))
    return cfg, prof, float(noise_norm)
