"""jax's threefry2x32 keys on the host, in plain PyTorch int64 arithmetic.

A frozen copy of the key arithmetic the program derives its streams from:
a key is the pair of 32-bit key-data words ``jax.random.key_data`` shows,
held in an int64 tensor ``(..., 2)`` with values in ``[0, 2**32)``.
``key`` is ``threefry_seed`` of an int32 seed, ``fold_in`` is
``threefry_2x32(key, (0, data))``, ``stage_key`` folds in the stage number
and then the index.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

STAGES = {"pulse": 0, "noise": 1, "null_select": 2, "null_noise": 3,
          "scint": 4, "user": 5, "prior": 6, "serve": 7, "rfi": 8,
          "transient": 9, "dataset": 10}

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on uint32 words in int64 tensors."""
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


def key(seed):
    """``jax.random.key(seed)``'s key data for an int32 seed."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise OverflowError(f"seed {seed} does not fit in int32")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64)


def fold_in(k, data):
    """``jax.random.fold_in`` for keys ``(..., 2)`` and integer data."""
    if not isinstance(data, torch.Tensor):
        data = torch.full((), int(data), dtype=torch.int64)
    data = data.to(torch.int64) & MASK32
    o0, o1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def stage_key(root, stage, index=0):
    """``fold_in(fold_in(root, stage number), index)``."""
    return fold_in(fold_in(root, STAGES[stage]), index)


def random_bits(k, n, start=0):
    """``n`` 32-bit words per key of jax's partitionable ``random.bits``."""
    idx = torch.arange(start, start + n, dtype=torch.int64)
    o0, o1 = threefry2x32(k[..., 0, None], k[..., 1, None], idx >> 32,
                          idx & MASK32)
    return o0 ^ o1


def seed_words(k):
    """Key data as the signed int32 words the sampler is seeded with."""
    kd = k.to(torch.int64) & MASK32
    return torch.where(kd >= 2**31, kd - 2**32, kd).to(torch.int32)
