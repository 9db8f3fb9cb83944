"""The packed-digest kernel (``csrc/packed_digest.cu``): the integrity
lattice's per-observation device digest of a packed chunk.

For each observation of the packed ``(B, nsub, C, nbin+4)`` int16 buffer
the ensemble produces, the sum mod 2^32 of three positional folds
``sum_i ((w_i ^ m_i)·0x9E3779B1 + m_i)``, ``m_i = (i + salt)·0x9E3779B1 +
0x85EBCA77``: the codes sign-extended to uint32 (salt 0), the DAT_SCL
words (the tail halves ``nbin, nbin+1`` joined little-endian, salt
``1<<20``) and the DAT_OFFS words (halves ``nbin+2, nbin+3``, salt
``2<<20``) — the JAX package's
``runtime/integrity.py::device_packed_digest_rows``, bit for bit, and
equal to the host twin
:func:`psrsigsim_torch.runtime.integrity.triple_digest_rows` of the split
triple.  The digest covers the values as they sit in the buffer (swapped
codes under ``byte_order="big"``).

* :func:`packed_digest` — the wrapper.  CUDA tensors launch the kernel
  (counted in ``packed_digest.launches``); CPU tensors run
  :func:`packed_digest_plain`.  There is no fallback from one to the
  other.
* :func:`packed_digest_plain` — the same function in torch ops on any
  device, one observation at a time, in int64 with 32-bit masks (torch
  has no uint32 arithmetic on CUDA tensors).

Digests are returned as int32 tensors holding the uint32 bits.
"""

from __future__ import annotations

import ctypes

import torch

# the fold's constants and salts are the host twin's (one definition)
from ..runtime.integrity import (_GOLD, _MASK, _OFF, _SALT_DATA, _SALT_OFFS,
                                 _SALT_SCL)
from . import _build

__all__ = ["packed_digest", "packed_digest_plain", "rows_digest"]


def _check(packed, count):
    if packed.dtype != torch.int16 or packed.dim() != 4 or packed.shape[-1] < 4:
        raise ValueError(f"packed must be (B, nsub, C, nbin+4) int16, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    B = packed.shape[0]
    count = B if count is None else int(count)
    if not 0 <= count <= B:
        raise ValueError(f"count={count} outside [0, {B}]")
    return count


def _mul32(x, c):
    """``(x · c) mod 2^32`` for int64 ``x`` in ``[0, 2^32)`` and a constant
    ``c < 2^32``, in 16-bit halves so no product leaves int64."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _MASK


def _positions(n, salt, device):
    """The fold's position multipliers ``m_i`` of ``n`` words."""
    i = (torch.arange(n, dtype=torch.int64, device=device) + salt) & _MASK
    return (_mul32(i, _GOLD) + _OFF) & _MASK


def _fold(words, m):
    """``sum_i ((w_i ^ m_i)·GOLD + m_i) mod 2^32`` of int64 words in
    ``[0, 2^32)``: a 0-dim int64 tensor."""
    return ((_mul32(words ^ m, _GOLD) + m) & _MASK).sum() & _MASK


def packed_digest_plain(packed, count=None):
    """The kernel's function in torch ops, on any device: ``(count,)``
    int32 digests (uint32 bits) of observations ``0..count-1``."""
    count = _check(packed, count)
    nbin = packed.shape[-1] - 4
    rows = packed.shape[1] * packed.shape[2]
    dev = packed.device
    m_data = _positions(rows * nbin, _SALT_DATA, dev)
    m_scl = _positions(rows, _SALT_SCL, dev)
    m_offs = _positions(rows, _SALT_OFFS, dev)
    out = torch.empty(count, dtype=torch.int64, device=dev)
    for b in range(count):
        p = packed[b].reshape(rows, nbin + 4).to(torch.int64)
        data = p[:, :nbin].reshape(-1) & _MASK          # sign-extended
        half = p[:, nbin:] & 0xFFFF
        scl = half[:, 0] | (half[:, 1] << 16)
        offs = half[:, 2] | (half[:, 3] << 16)
        out[b] = (_fold(data, m_data) + _fold(scl, m_scl)
                  + _fold(offs, m_offs)) & _MASK
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


def rows_digest(x, salt=0):
    """Per-row digest of a tensor (leading axis = rows) in torch ops on its
    own device: ``(rows,)`` int64 holding the uint32 digests, equal to the
    host twin :func:`psrsigsim_torch.runtime.integrity.digest_rows` (and
    to the JAX package's ``device_digest_rows``).  float32 words are their
    bits, 8-byte elements word pairs (little-endian), integers sign-extend.
    The Monte-Carlo study digests its ``(chunk, M)`` metric rows with it —
    a few hundred words, no kernel of its own (the JAX package's is an
    XLA fusion too)."""
    rows = x.shape[0]
    if x.dtype == torch.float32 or x.element_size() == 8:
        w = x.contiguous().view(torch.int32)
    else:
        w = x
    # a field with no columns (a corpus without priors) digests to 0
    w = w.reshape(rows, -1 if w.numel() else 0).to(torch.int64) & _MASK
    m = _positions(w.shape[1], salt & _MASK, x.device)
    terms = (_mul32(w ^ m, _GOLD) + m) & _MASK
    return terms.sum(dim=1) & _MASK


def _lib():
    lib = _build.library("packed_digest")
    fn = lib.packed_digest_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def packed_digest(packed, count=None):
    """Per-observation digests of the first ``count`` observations of a
    packed chunk (default: all).

    Args:
        packed: ``(B, nsub, C, nbin+4)`` int16, contiguous.
        count: observations to digest (the chunk's real rows; the padded
            tail is left out).

    Returns:
        ``(count,)`` int32 holding the uint32 digests, on ``packed``'s
        device.  CUDA tensors launch the kernel on the current stream;
        CPU tensors run :func:`packed_digest_plain`.
    """
    count = _check(packed, count)
    dev = packed.device
    if dev.type == "cpu":
        return packed_digest_plain(packed, count)
    if dev.type != "cuda":
        raise ValueError(f"packed_digest runs on cuda or cpu tensors, not {dev}")
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    if count > 65535:
        raise ValueError(f"count {count} exceeds the grid limit")
    out = torch.zeros(count, dtype=torch.int32, device=dev)
    if count == 0:
        return out
    rows = packed.shape[1] * packed.shape[2]
    err = _lib().packed_digest_launch(
        packed.data_ptr(), out.data_ptr(), count, rows, packed.shape[-1] - 4,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"packed_digest kernel launch failed: cudaError {err}")
    _build.count_launch(packed_digest)
    return out


packed_digest.launches = 0
