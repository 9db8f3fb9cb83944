"""Batched downsampling / rebinning (counterpart:
psrsigsim_tpu/ops/resample.py).

The reference resamples one channel at a time (telescope/telescope.py:109,
119 looping utils.down_sample:62-68 and utils.rebin:71-91).  Both collapse
to whole-tensor reshapes and gathers here, batched over every leading axis.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["block_downsample", "rebin"]


def block_downsample(data, fact):
    """Downsample the last axis by integer factor ``fact`` via block means
    (batched twin of utils.down_sample)."""
    *lead, n = data.shape
    return data.reshape(*lead, n // fact, fact).mean(dim=-1)


def rebin(data, newlen):
    """General rebin of the last axis to ``newlen`` bins by variable-width
    window means.

    Matches the reference's NaN-padded rebinner (utils/utils.py:71-91):
    window ``ii`` spans samples ``ceil(edge_ii) .. ceil(edge_ii + stride)``.
    The window geometry is computed on the host; the gather and the masked
    mean run on ``data``'s device.
    """
    *lead, size = data.shape
    edges = np.linspace(0, size, newlen, endpoint=False)
    stride = edges[1] - edges[0] if newlen > 1 else float(size)
    width = int(math.ceil(stride))
    starts = np.ceil(edges).astype(np.int64)  # (newlen,)
    stops = np.minimum(np.ceil(edges + stride).astype(np.int64), size)

    idx = starts[:, None] + np.arange(width)[None, :]  # (newlen, width)
    valid = idx < stops[:, None]
    idx = np.clip(idx, 0, size - 1)

    dev = data.device
    gathered = data[..., torch.as_tensor(idx, device=dev)]  # (..., newlen, width)
    mask = torch.as_tensor(valid, device=dev)
    total = torch.where(mask, gathered, torch.zeros((), dtype=data.dtype,
                                                    device=dev)).sum(dim=-1)
    count = mask.sum(dim=-1)
    return total / count
