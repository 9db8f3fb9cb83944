"""The program's random-field stream in plain PyTorch: Philox4x32-10 per
(observation, 8-channel group, 4096-sample block), Box-Muller, then the
chi-square map.

A frozen copy of the stream's definition (the sampler's documented layout):
the group and block are mixed into two 32-bit seed words with murmur3's
finaliser, counter ``e >> 2`` gives the four words of samples ``4(e >> 2)
.. 4(e >> 2) + 3`` of the 8 x 4096 tile in lane order cos A, sin A, cos B,
sin B, and tile sample ``e`` is channel ``e // 4096`` of the group at
block sample ``e % 4096``.  ``dtype`` is the precision of the transform
(float32 for the reference, a lower one for the control); the integer
words are exact in either.
"""

from __future__ import annotations

import torch

RNG_BLOCK = 4096
CHAN_GROUP = 8
_TILE = CHAN_GROUP * RNG_BLOCK

_MASK32 = 0xFFFFFFFF
_M1, _M2, _GOLD = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_INV24 = 2.0 ** -24
_TWO_PI32 = float(torch.tensor(6.283185307179586, dtype=torch.float32))


def _mul_lo32(a, b):
    return (((((a >> 16) * b) & 0xFFFF) << 16) + (a & 0xFFFF) * b) & _MASK32


def _mulhilo32(m, x):
    big = (m >> 16) * x
    small = (m & 0xFFFF) * x
    hi = (big + (small >> 16)) >> 16
    lo = (((big & 0xFFFF) << 16) + small) & _MASK32
    return hi, lo


def _mix32(h):
    h = h ^ (h >> 16)
    h = _mul_lo32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul_lo32(h, _M2)
    return h ^ (h >> 16)


def philox_bits(h0, h1, counter):
    """Philox4x32-10 keyed by ``(h0, h1)`` on the counter ``(c, 0, 0, 0)``."""
    k0, k1 = h0, h1
    x0, x1 = counter, torch.zeros_like(counter)
    x2, x3 = torch.zeros_like(counter), torch.zeros_like(counter)
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo32(_PHILOX_M0, x0)
        hi1, lo1 = _mulhilo32(_PHILOX_M1, x2)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
    return x0, x1, x2, x3


def _box_muller(bits1, bits2, dtype):
    u1 = (((bits1 & 0x00FFFFFF).to(torch.float32) + 1.0) * _INV24).to(dtype)
    u2 = ((bits2 & 0x00FFFFFF).to(torch.float32) * _INV24).to(dtype)
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = _TWO_PI32 * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def wilson_hilferty(z, df):
    """``max(k (1 - c + z sqrt(c))^3, 0)`` with ``c = 2 / (9 k)``."""
    c = 2.0 / (9.0 * df)
    t = (1.0 - c) + z * torch.sqrt(c)
    return torch.clamp_min(df * (t * (t * t)), 0.0)


def _transform(words, mode, df, dtype):
    ca, sa = _box_muller(words[0], words[1], dtype)
    cb, sb = _box_muller(words[2], words[3], dtype)
    z = torch.stack([ca, sa, cb, sb], dim=-1)
    if mode == "normal":
        return z
    if mode == "chi2_1":
        return z * z
    k = torch.as_tensor(df, dtype=torch.float32, device=z.device).to(dtype)
    wh = wilson_hilferty(z, k)
    if mode == "chi2_wh":
        return wh
    if mode == "chi2_sel":
        return torch.where(k == 1.0, z * z, wh)
    raise ValueError(f"unknown mode {mode!r}")


def field(seed_pair, mode, df, nchan, length, chan0=0, device="cpu",
          dtype=torch.float32):
    """One observation's ``(nchan, length)`` field from global channel
    ``chan0`` (a multiple of 8) and global sample 0, as float32.

    ``seed_pair``: the stage key's two int32 seed words; ``df`` the
    chi-square degrees of freedom (read by ``chi2_wh`` and ``chi2_sel``)."""
    ngrp = -(-nchan // CHAN_GROUP)
    nblk = -(-length // RNG_BLOCK)
    s = [int(w) & _MASK32 for w in seed_pair]
    counter = torch.arange(_TILE // 4, dtype=torch.int64, device=device)
    cg = (chan0 // CHAN_GROUP
          + torch.arange(ngrp, dtype=torch.int64, device=device)) & _MASK32
    gb = torch.arange(nblk, dtype=torch.int64, device=device) & _MASK32
    h0 = _mix32(s[0] ^ ((_mul_lo32(cg, _GOLD) + 0x5851) & _MASK32))
    h1 = _mix32(s[1] ^ _mul_lo32(gb, _M1)[None, :]
                ^ ((_mul_lo32(cg, _M2) + 0x7F4A) & _MASK32)[:, None])
    words = philox_bits(h0[:, None, None], h1[:, :, None], counter)
    val = _transform(words, mode, df, dtype).to(torch.float32)
    val = val.reshape(ngrp, nblk, CHAN_GROUP, RNG_BLOCK)
    val = val.permute(0, 2, 1, 3).reshape(ngrp * CHAN_GROUP, nblk * RNG_BLOCK)
    return val[:nchan, :length].contiguous()
