"""Explicit PRNG key plumbing: jax's threefry2x32 keys, bit for bit.

The JAX package threads ``jax.random`` keys through every pipeline so an
ensemble is reproducible and sharding-invariant (counterpart:
psrsigsim_tpu/utils/rng.py).  The port keeps the same keys and the same
streams, so a seed draws the same realization in both packages:

* a key is the pair of 32-bit key-data words ``jax.random.key_data`` shows,
  held as an int64 tensor of shape ``(..., 2)`` whose values lie in
  ``[0, 2**32)``;
* :func:`key`, :func:`fold_in` and :func:`random_bits` follow jax's
  threefry implementation (``key`` = ``threefry_seed``, ``fold_in`` =
  ``threefry_2x32(key, threefry_seed(data))``, and the partitionable
  ``random_bits``: counts are the flat index split into (hi, lo) words and
  the bits are the XOR of the two output words);
* every 32-bit operation is done in int64 and masked back to 32 bits, so
  the code runs unchanged on the CPU and on the card.

No global generator is used anywhere in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = ["STAGES", "key", "as_key", "fold_in", "stage_key", "threefry2x32",
           "random_bits"]

MASK32 = 0xFFFFFFFF

# Stable stage identifiers, the same numbers as the JAX package's, so each
# pipeline stage draws the same independent stream in both packages.
STAGES = {
    "pulse": 0,
    "noise": 1,
    "null_select": 2,
    "null_noise": 3,
    "scint": 4,
    "user": 5,
    "prior": 6,
    "serve": 7,
    "rfi": 8,
    "transient": 9,
    "dataset": 10,
}

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on uint32 words held in int64 tensors
    (broadcasting).  Returns the two output words."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key(seed, device=None):
    """The key of an integer seed: ``jax.random.key(seed)``'s key data.

    The JAX package runs with 64-bit types off, so a seed is an int32 and
    its high word is 0.
    """
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise OverflowError(f"seed {seed} does not fit in int32")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64,
                        device=resolve_device(device))


def as_key(k, device=None):
    """A key from key-data words (a ``(..., 2)`` uint32 numpy array, as
    ``jax.random.key_data`` returns them, or a tensor already in the port's
    form)."""
    if isinstance(k, torch.Tensor):
        if k.shape[-1] != 2:
            raise ValueError(f"key data must end in 2 words, got {tuple(k.shape)}")
        return k.to(torch.int64) & MASK32
    arr = np.asarray(k)
    if arr.shape[-1:] != (2,):
        raise ValueError(f"key data must end in 2 words, got {arr.shape}")
    return torch.as_tensor(arr.astype(np.uint32).astype(np.int64),
                           device=resolve_device(device))


def fold_in(k, data):
    """``jax.random.fold_in``: a new key from ``k`` (``(..., 2)``) and an
    integer (or an integer tensor broadcastable against ``k[..., 0]``)."""
    if not isinstance(data, torch.Tensor):
        data = torch.full((), int(data), dtype=torch.int64, device=k.device)
    data = data.to(torch.int64) & MASK32
    o0, o1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def stage_key(root, stage, index=0):
    """The key for (stage, index) derived from ``root``: ``fold_in`` by the
    stage number, then by the index (the JAX package's ``stage_key``)."""
    sid = STAGES[stage] if isinstance(stage, str) else int(stage)
    return fold_in(fold_in(root, sid), index)


def random_bits(k, n):
    """``n`` 32-bit random words per key (``jax.random.bits`` in
    partitionable mode, flattened): ``(..., n)`` int64 for a ``(..., 2)``
    key."""
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    o0, o1 = threefry2x32(k[..., 0, None], k[..., 1, None],
                          idx >> 32, idx & MASK32)
    return o0 ^ o1
