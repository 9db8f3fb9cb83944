"""PSRFITS int16 quantization of simulated blocks (counterpart:
psrsigsim_tpu/ops/quantize.py).

- :func:`clip_cast` — reference-parity intensity export: clip from above at
  the draw ceiling, truncate-cast to the target integer dtype.
- :func:`subint_quantize` — per (subint, channel) affine quantization to
  int16 with real DAT_SCL/DAT_OFFS columns, ``physical = DATA * DAT_SCL +
  DAT_OFFS`` (the reference's writer resets them to 1/0,
  psrsigsim/io/psrfits.py:386-388).
- :func:`subint_dequantize` — the inverse.
- :func:`swap16` — byte-swap int16 codes for big-endian PSRFITS columns.
- :func:`pack_triple` — codes, DAT_SCL and DAT_OFFS in one int16 buffer.
- :func:`quantize_packed` — the finite guard, the quantizer, the optional
  byte swap and the packing of float blocks, the unfused path's tail.

Every function works on a leading batch of observations as well as on one.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["clip_cast", "subint_quantize", "subint_dequantize", "swap16",
           "pack_triple", "quantize_packed"]

# int16 span used for DAT_SCL scaling: map [lo, hi] onto [-32767, 32767]
# symmetrically, so -32768 never appears
_I16_HALF_SPAN = 32767.0
_INV_FULL_SPAN = float(np.float32(1.0 / (2.0 * _I16_HALF_SPAN)))


def clip_cast(block, clip_max, dtype=torch.int8):
    """Clip from above at ``clip_max`` and truncate-cast (C-style
    float -> int, reference telescope.py:141-144)."""
    return torch.clamp_max(block, float(clip_max)).to(dtype)


def subint_quantize(block, nsub, nbin):
    """Quantize ``(..., Nchan, nsub*nbin)`` float32 blocks to PSRFITS int16
    subints.

    Returns ``(data, scl, offs)``: ``data`` ``(..., nsub, Nchan, nbin)``
    int16 and ``scl``/``offs`` ``(..., nsub, Nchan)`` float32.  Each
    (subint, channel) row maps its [min, max] onto [-32767, 32767] around
    the midpoint; constant rows get scl=1, data=0.  The codes use the
    reference's explicit reciprocal multiply and round half to even, the
    same IEEE operations in the same order, so equal blocks give equal
    bytes.
    """
    lead = block.shape[:-2]
    nchan = block.shape[-2]
    d4 = block.reshape(lead + (nchan, nsub, nbin))
    lo, hi = torch.aminmax(d4, dim=-1)                      # (..., C, nsub)
    span = hi - lo
    live = span > 0
    one = torch.ones_like(span)
    # XLA turns the reference's division by the constant into a multiply by
    # its float32 reciprocal; the port writes that multiply out
    scl = torch.where(live, span * _INV_FULL_SPAN, one)
    offs = (hi + lo) * 0.5
    # a true division (torch evaluates `scalar / tensor` as a reciprocal
    # times the scalar, which rounds twice)
    inv_scl = torch.where(live, torch.full_like(span, 2.0 * _I16_HALF_SPAN) / span,
                          one)
    # in place after the first subtraction: one block-sized temporary
    q = (d4 - offs[..., None]).mul_(inv_scl[..., None]).round_()
    q = q.clamp_(-_I16_HALF_SPAN, _I16_HALF_SPAN).to(torch.int16)
    data = q.transpose(-3, -2).contiguous()                 # (..., nsub, C, nbin)
    return data, scl.transpose(-2, -1).contiguous(), offs.transpose(-2, -1).contiguous()


def subint_dequantize(data, scl, offs):
    """Inverse of :func:`subint_quantize`: int16 codes + per-row scale and
    offset back to float32 physical values."""
    return data.to(torch.float32) * scl[..., None] + offs[..., None]


def swap16(data):
    """Byte-swap int16 codes (an involution).  The swapped tensor holds
    big-endian bit patterns, so ``array.view('>i2')`` of its host copy
    reads the true values."""
    b = data.contiguous().view(torch.uint8)
    b = b.reshape(data.shape + (2,)).flip(-1)
    return b.reshape(b.shape[:-2] + (b.shape[-2] * 2,)).view(torch.int16)


def pack_triple(data, scl, offs):
    """``(..., nsub, C, nbin)`` int16 codes + ``(..., nsub, C)`` float32
    scl/offs -> ONE ``(..., nsub, C, nbin+4)`` int16 buffer (reference:
    psrsigsim_tpu/parallel/ensemble.py:312-314): each float32 rides along as
    its two native-order int16 halves (a bit-exact reinterpretation), so a
    chunk leaves the device in one transfer."""
    def halves(x):
        return x.contiguous().view(torch.int16).reshape(x.shape + (2,))

    return torch.cat([data, halves(scl), halves(offs)], dim=-1)


def quantize_packed(block, nsub, nbin, byte_order="little"):
    """``(..., C, nsub*nbin)`` float32 blocks -> ``(packed, finite)``:
    :func:`subint_quantize`, :func:`swap16` of the codes for
    ``byte_order="big"``, then :func:`pack_triple`; ``finite`` ``(..., C)``
    is True where every sample of the channel was finite BEFORE
    quantization."""
    finite = torch.isfinite(block).all(dim=-1)
    data, scl, offs = subint_quantize(block, nsub, nbin)
    if byte_order == "big":
        data = swap16(data)
    return pack_triple(data, scl, offs), finite
