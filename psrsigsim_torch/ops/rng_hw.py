"""The random-field sampler kernel (counterpart of
psrsigsim_tpu/ops/rng_pallas.py).

The fold pipelines are random-draw bound: every observation draws two full
``(Nchan, Nsamp)`` χ² fields against one tiny profile FFT.  On a TPU the
JAX package draws them with a Pallas kernel on the hardware PRNG; here
they come from a hand-written CUDA kernel, ``csrc/rng_field.cu``, on the
stream of ``csrc/philox_field.cuh``:

    Philox4x32-10, four words -> two pairs of 24-bit uniforms ->
    Box-Muller, both branches -> four normals -> (χ²)

seeded per (batch element, GLOBAL 8-channel group, GLOBAL 4096-sample RNG
block) from the key data with the TPU kernel's murmur3 mixing; sample ``e``
of the 8×4096 tile is lane ``e & 3`` (cos A, sin A, cos B, sin B) of the
call on counter ``e >> 2``, so any split of channels or time draws the same
samples.  The stream is not the TPU's (its hardware bits cannot be
reproduced elsewhere): psrsigsim_torch/DIVERGENCES.md P1.  The fused kernel
of :mod:`.fold_quantize` draws the same samples.

* :func:`rng_field` — the wrapper.  A CUDA tensor launches the kernel (the
  launch is counted in ``rng_field.launches``); a CPU tensor runs
  :func:`rng_field_plain`, the same Philox, transform and layout in torch
  ops.  There is no fallback from one to the other.
* :func:`rng_flat_field` — the same kernel storing the SEARCH-mode flat
  stream: whole 8 × 4096 tiles in (block, channel, sample) order, a span
  of it per batch element (the reference's ``flat_normal_field`` draws the
  rows and transposes them); its plain version is
  :func:`rng_flat_field_plain`, :func:`rng_field_plain` and the same
  reorder.  Counted in ``rng_flat_field.launches``.
* :func:`hw_chan_field` — the key-data → seed-words glue the pipelines
  call (reference: ``hw_chan_field``).

The kernel is built by :mod:`._build` at first use.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .stats import wilson_hilferty

__all__ = ["RNG_BLOCK", "CHAN_GROUP", "FLAT_TILE", "MODES", "rng_field",
           "rng_field_plain", "rng_flat_field", "rng_flat_field_plain",
           "box_muller_selftest", "hw_chan_field", "seed_words"]

RNG_BLOCK = 4096  # must equal ops.stats.SEQ_RNG_BLOCK
CHAN_GROUP = 8    # channels per independent stream
_TILE = CHAN_GROUP * RNG_BLOCK
FLAT_TILE = _TILE  # samples per tile of the flat stream
LANES = 4         # samples per Philox call

MODES = {"normal": 0, "chi2_1": 1, "chi2_wh": 2, "chi2_sel": 3}

_MASK32 = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLD = 0x9E3779B9
_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85
_INV24 = 2.0 ** -24
_TWO_PI = float(torch.tensor(6.283185307179586, dtype=torch.float32))


# -- plain version --------------------------------------------------------------


def _mul_lo32(a, b):
    """Low 32 bits of ``a*b`` for uint32 values in int64 tensors, without
    overflowing int64 (``a`` is split into 16-bit halves)."""
    return (((((a >> 16) * b) & 0xFFFF) << 16) + (a & 0xFFFF) * b) & _MASK32


def _mulhilo32(m, x):
    """``(hi, lo)`` words of ``m*x`` for a uint32 constant ``m`` and uint32
    values ``x`` in an int64 tensor."""
    big = (m >> 16) * x
    small = (m & 0xFFFF) * x
    hi = (big + (small >> 16)) >> 16
    lo = (((big & 0xFFFF) << 16) + small) & _MASK32
    return hi, lo


def _mix32(h):
    """murmur3 finalizer on uint32 values (the TPU kernel's ``_mix32``)."""
    h = h ^ (h >> 16)
    h = _mul_lo32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul_lo32(h, _M2)
    return h ^ (h >> 16)


def philox_bits(h0, h1, counter):
    """The four output words of Philox4x32-10 keyed by ``(h0, h1)`` on the
    counter ``(counter, 0, 0, 0)`` (int64 tensors of uint32 values,
    broadcasting)."""
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


def _box_muller(bits1, bits2):
    """One Box-Muller pair from two words: 24-bit uniforms ``u1`` in (0, 1]
    and ``u2`` in [0, 1), then ``(r·cos, r·sin)`` of ``2π·u2`` with
    ``r = sqrt(-2·log u1)``."""
    u1 = ((bits1 & 0x00FFFFFF).to(torch.float32) + 1.0) * _INV24
    u2 = (bits2 & 0x00FFFFFF).to(torch.float32) * _INV24
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = _TWO_PI * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def transform(w0, w1, w2, w3, mode, df):
    """Four words → four values ``(..., 4)`` in lane order cos A, sin A,
    cos B, sin B: Box-Muller on words (0, 1) and (2, 3), then the mode's χ²
    map, the TPU kernel's arithmetic (rng_pallas.py:143-161) on every lane.
    ``df`` is a float32 scalar tensor."""
    cos_a, sin_a = _box_muller(w0, w1)
    cos_b, sin_b = _box_muller(w2, w3)
    z = torch.stack([cos_a, sin_a, cos_b, sin_b], dim=-1)
    if mode == "normal":
        return z
    if mode == "chi2_1":
        return z * z
    wh = wilson_hilferty(z, df)
    if mode == "chi2_wh":
        return wh
    return torch.where(df == 1.0, z * z, wh)


def rng_field_plain(seeds, dfs, pos, mode, nchan, length, bits=philox_bits):
    """The kernel's function in torch ops, on any device: ``(B, nchan,
    length)`` float32.  One batch element at a time keeps the int64
    intermediates small.  ``bits(h0, h1, counter)`` supplies the four
    random words (the tests feed zeros through it)."""
    _check_args(seeds, dfs, pos, mode, nchan, length)
    dev = seeds.device
    B = seeds.shape[0]
    ngrp = -(-nchan // CHAN_GROUP)
    nblk = -(-length // RNG_BLOCK)
    out = torch.empty((B, nchan, length), dtype=torch.float32, device=dev)
    counter = torch.arange(_TILE // LANES, dtype=torch.int64, device=dev)
    grp = torch.arange(ngrp, dtype=torch.int64, device=dev)
    blk = torch.arange(nblk, dtype=torch.int64, device=dev)
    s64 = seeds.to(torch.int64) & _MASK32
    p64 = pos.to(torch.int64)
    for b in range(B):
        cg = (p64[b, 0] + grp) & _MASK32                       # (G,)
        gb = (p64[b, 1] + blk) & _MASK32                       # (N,)
        h0 = _mix32(s64[b, 0] ^ ((_mul_lo32(cg, _GOLD) + 0x5851) & _MASK32))
        h1 = _mix32(s64[b, 1] ^ _mul_lo32(gb, _M1)[None, :]
                    ^ ((_mul_lo32(cg, _M2) + 0x7F4A) & _MASK32)[:, None])
        words = bits(h0[:, None, None], h1[:, :, None], counter)
        val = transform(*words, mode, dfs[b])                  # (G, N, 8192, 4)
        val = val.reshape(ngrp, nblk, CHAN_GROUP, RNG_BLOCK)
        val = val.permute(0, 2, 1, 3).reshape(ngrp * CHAN_GROUP,
                                              nblk * RNG_BLOCK)
        out[b] = val[:nchan, :length]
    return out


# -- kernel launch ----------------------------------------------------------------


def _lib():
    lib = _build.library("rng_field")
    fn = lib.rng_field_layout_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


_LAYOUTS = {"rows": 0, "flat": 1}


def _launch(seeds, dfs, pos, out, nchan, length, mode, layout, skip):
    """One launch of the kernel on the current stream (checks done)."""
    dev = seeds.device
    B = seeds.shape[0]
    if B > 65535 or -(-nchan // CHAN_GROUP) > 65535:
        raise ValueError(f"batch {B} or channel groups exceed the grid limit")
    if not (seeds.is_contiguous() and dfs.is_contiguous()
            and pos.is_contiguous()):
        raise ValueError("seeds, dfs and pos must be contiguous")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().rng_field_layout_launch(
        seeds.data_ptr(), dfs.data_ptr(), pos.data_ptr(), out.data_ptr(), B,
        nchan, length, MODES[mode], _LAYOUTS[layout], skip, stream)
    if err != 0:
        raise RuntimeError(f"rng_field kernel launch failed: cudaError {err}")


def _check_args(seeds, dfs, pos, mode, nchan, length):
    if mode not in MODES:
        raise ValueError(f"unknown sampler mode {mode!r}; use one of {list(MODES)}")
    if nchan <= 0 or length <= 0:
        raise ValueError(f"nchan={nchan} and length={length} must be positive")
    if seeds.dim() != 2 or seeds.shape[1] != 2 or seeds.dtype != torch.int32:
        raise ValueError(f"seeds must be (B, 2) int32, got "
                         f"{tuple(seeds.shape)} {seeds.dtype}")
    B = seeds.shape[0]
    if tuple(dfs.shape) != (B,) or dfs.dtype != torch.float32:
        raise ValueError(f"dfs must be ({B},) float32, got "
                         f"{tuple(dfs.shape)} {dfs.dtype}")
    if tuple(pos.shape) != (B, 2) or pos.dtype != torch.int32:
        raise ValueError(f"pos must be ({B}, 2) int32, got "
                         f"{tuple(pos.shape)} {pos.dtype}")
    if not (seeds.device == dfs.device == pos.device):
        raise ValueError("seeds, dfs and pos must be on one device")


def rng_field(seeds, dfs, pos, mode, nchan, length):
    """``(B, nchan, length)`` float32 random fields.

    ``seeds`` ``(B, 2)`` int32 key-data words, ``dfs`` ``(B,)`` float32 χ²
    degrees of freedom (read by the ``chi2_wh``/``chi2_sel`` modes),
    ``pos`` ``(B, 2)`` int32 (first global channel group, first global RNG
    block).  CUDA tensors launch the kernel on the current stream; CPU
    tensors run :func:`rng_field_plain`.
    """
    _check_args(seeds, dfs, pos, mode, nchan, length)
    dev = seeds.device
    if dev.type == "cpu":
        return rng_field_plain(seeds, dfs, pos, mode, nchan, length)
    if dev.type != "cuda":
        raise ValueError(f"rng_field runs on cuda or cpu tensors, not {dev}")
    out = torch.empty((seeds.shape[0], nchan, length), dtype=torch.float32,
                      device=dev)
    _launch(seeds, dfs, pos, out, nchan, length, mode, "rows", 0)
    _build.count_launch(rng_field)
    return out


rng_field.launches = 0


def _check_flat(skip, length):
    if not 0 <= skip < FLAT_TILE:
        raise ValueError(f"skip={skip} must lie in [0, {FLAT_TILE})")
    if (skip + length + FLAT_TILE - 1) // FLAT_TILE * FLAT_TILE >= 2**31:
        raise ValueError(f"a flat span of {skip + length} samples overflows "
                         "the kernel's int32 offsets")


def rng_flat_field_plain(seeds, dfs, pos, mode, skip, length):
    """:func:`rng_flat_field` in torch ops: the channel group's rows from
    :func:`rng_field_plain` over the whole tiles, reordered to (block,
    channel, sample) and sliced."""
    _check_flat(skip, length)
    nt = -(-(skip + length) // FLAT_TILE)
    rows = rng_field_plain(seeds, dfs, pos, mode, CHAN_GROUP,
                           nt * RNG_BLOCK)
    flat = rows.reshape(-1, CHAN_GROUP, nt, RNG_BLOCK).transpose(1, 2)
    return flat.reshape(rows.shape[0], -1)[:, skip:skip + length].contiguous()


def rng_flat_field(seeds, dfs, pos, mode, skip, length):
    """``(B, length)`` float32: flat indices ``[skip, skip + length)`` of
    the flat stream of channel group ``pos[:, 0]`` from RNG block
    ``pos[:, 1]`` on — whole 8 × 4096 tiles in (block, channel, sample)
    order, sample ``s`` of channel ``c`` in block ``pos[:, 1] + t`` at flat
    index ``(t·8 + c)·4096 + s`` (reference: ``flat_normal_field``).

    Arguments as :func:`rng_field`; ``skip`` in ``[0, 8·4096)``.  CUDA
    tensors launch the kernel in its flat layout (one store pass, no
    transpose); CPU tensors run :func:`rng_flat_field_plain`.
    """
    _check_args(seeds, dfs, pos, mode, CHAN_GROUP, length)
    _check_flat(skip, length)
    dev = seeds.device
    if dev.type == "cpu":
        return rng_flat_field_plain(seeds, dfs, pos, mode, skip, length)
    if dev.type != "cuda":
        raise ValueError(f"rng_flat_field runs on cuda or cpu tensors, "
                         f"not {dev}")
    out = torch.empty((seeds.shape[0], length), dtype=torch.float32,
                      device=dev)
    _launch(seeds, dfs, pos, out, CHAN_GROUP, length, mode, "flat", skip)
    _build.count_launch(rng_flat_field)
    return out


rng_flat_field.launches = 0


def box_muller_selftest(device="cuda"):
    """Run ``csrc/rng_field.cu``'s self-test on a CUDA device: the shared
    header's Box-Muller radius, sine and cosine against the CUDA math
    library's ``sqrtf(-2 logf(u1))`` and ``sincosf(2π u2)`` on every one of
    the 2^24 words.  Returns the mismatch counts ``{"radius": n, "sin": n,
    "cos": n}``; all three must be 0."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the self-test runs on a CUDA device, not {dev}")
    lib = _lib()
    fn = lib.box_muller_selftest
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    miss = torch.zeros(3, dtype=torch.int64, device=dev)
    err = fn(miss.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"box_muller_selftest launch failed: cudaError {err}")
    return dict(zip(("radius", "sin", "cos"), miss.tolist()))


def hw_chan_field(key, chan0, df, t0, *, mode, nchan, length):
    """A ``(..., nchan, length)`` field for keys ``(..., 2)`` (reference:
    ``hw_chan_field``).

    ``chan0``: GLOBAL index of the first channel, a multiple of
    :data:`CHAN_GROUP` (the caller's promise).  ``df``: χ² degrees of
    freedom, a scalar or one per key (ignored by ``normal``/``chi2_1``).
    ``t0``: GLOBAL first sample, a multiple of :data:`RNG_BLOCK`.
    """
    lead = key.shape[:-1]
    seeds = seed_words(key.reshape(-1, 2))
    B = seeds.shape[0]
    # scalars become fills, never host->device copies: a pageable copy
    # waits for the stream and would stall the host between launches
    if isinstance(df, torch.Tensor):
        dfs = df.to(device=key.device, dtype=torch.float32)
        dfs = dfs.expand(lead).reshape(B).contiguous()
    else:
        dfs = torch.full((B,), float(df), dtype=torch.float32, device=key.device)
    pos = torch.empty((B, 2), dtype=torch.int32, device=key.device)
    pos[:, 0] = int(chan0) // CHAN_GROUP
    pos[:, 1] = int(t0) // RNG_BLOCK
    out = rng_field(seeds.contiguous(), dfs, pos, mode, nchan, length)
    return out.reshape(lead + (nchan, length))


def seed_words(key):
    """Key data ``(..., 2)`` (uint32 values in an int64 tensor) as the
    int32 seed words the kernels read, bit for bit."""
    kd = key.to(torch.int64) & _MASK32
    return torch.where(kd >= 2**31, kd - 2**32, kd).to(torch.int32)
