"""The scenario-draws kernel (``csrc/scenario_draws.cu``, K10): the scenario
engine's factors drawn on the card from keys that lie there (counterpart:
the JAX package's ``ops/scenario.py``, an XLA fusion per effect, not a
Pallas kernel).

:mod:`.scenario` routes here for CUDA keys; its host code is the contract
these launches are held to, bit for bit (DIVERGENCES P13).  One entry
point per effect, one thread per output element:

* :func:`stage_keys` — the effects' stage keys of observation keys that
  crossed to the card;
* :func:`scint_gains` — a gain per (observation, channel, subint) cell,
  its scintle cell's key folded in the thread (no de-duplication);
* :func:`rfi_levels` — the RFI level and truth mask per cell, the level
  times the observation's noise level where one is given;
* :func:`pulse_energies` — an energy per (observation, subint) in any of
  the three single-pulse modes.

Keys are the port's ``(..., 2)`` key data on the card; parameters are one
per leading index of the keys or one for all (numbers or tensors; those
not on the card yet cross in one copy).  :func:`to_card` is that copy;
it also takes a batch's observation keys with its parameters.  Every
launch runs on the current stream and is counted in
``scenario_draws.launches`` and, inside an open telemetry span, as
``scenario.card_launches``.  A failed launch raises: there is no fallback
to the host.  The kernel is built by :mod:`._build` at first use.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from ..runtime.telemetry import count
from ..utils.device import to_device
from . import _build

__all__ = ["stage_keys", "scint_gains", "rfi_levels", "pulse_energies",
           "to_card", "ENERGY_MODES"]

#: the single-pulse energy-distribution modes, in the kernel's numbering
ENERGY_MODES = ("lognormal", "powerlaw", "frb")

_F32 = torch.float32

launches = 0
_THIS = sys.modules[__name__]


def _lib():
    lib = _build.library("scenario_draws")
    if lib.scenario_scint_launch.argtypes is None:
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        f, pp, lp = ctypes.c_float, ctypes.POINTER(vp), ctypes.POINTER(ll)
        lib.scenario_scint_launch.argtypes = [vp, ll, ll, i, i, vp, f, f, f,
                                              f, pp, lp, vp, vp]
        lib.scenario_rfi_launch.argtypes = [vp, ll, ll, i, i, vp, pp, lp, i,
                                            vp, vp, vp]
        lib.scenario_energy_launch.argtypes = [vp, ll, ll, i, i, pp, lp, vp,
                                               vp]
        lib.scenario_stage_launch.argtypes = [vp, ll, ll, i,
                                              ctypes.POINTER(ctypes.c_uint),
                                              vp, vp]
        for fn in (lib.scenario_scint_launch, lib.scenario_rfi_launch,
                   lib.scenario_energy_launch, lib.scenario_stage_launch):
            fn.restype = i
    return lib


def _keys(keys):
    """``(N, 2)`` int64 key data with unit stride along the words (a view
    of the caller's keys where it can be), the leading shape, and the
    device."""
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"the scenario-draws kernel takes keys on a CUDA "
                         f"device, not {dev}")
    if keys.shape[-1:] != (2,):
        raise ValueError(f"keys must end in 2 words, got {tuple(keys.shape)}")
    k = keys if keys.dim() == 2 else keys.reshape(-1, 2)
    if k.dtype != torch.int64:
        k = k.to(torch.int64)
    if k.stride(1) != 1:
        k = k.contiguous()
    return k, keys.shape[:-1], dev


def to_card(values, lead, dev, keys=None):
    """Host ``keys`` ``lead + (2,)`` (or None) and ``values`` (numbers,
    arrays or tensors, each one value for all or one per leading index of
    ``lead``) on ``dev``, packed into one host buffer and sent in one copy:
    ``(keys, columns)``, the keys as int64 key data and each column float32,
    ``(1,)`` for one value for all, else of shape ``lead``."""
    lead = tuple(lead)
    parts = []
    if keys is not None:
        parts.append(np.ascontiguousarray(keys.numpy(), np.int64)
                     .reshape(-1).view(np.uint8))
    shapes = []
    for v in values:
        if isinstance(v, torch.Tensor):
            v = (v if v.device.type == "cpu" else v.cpu()).numpy()
        a = np.asarray(v, np.float32)
        a = (a.reshape(1) if a.size == 1
             else np.ascontiguousarray(np.broadcast_to(a, lead)))
        shapes.append(a.shape)
        parts.append(a.reshape(-1).view(np.uint8))
    if not parts:
        return None, []
    d = to_device(torch.as_tensor(np.concatenate(parts), dtype=torch.uint8),
                  dev)
    at, out = 0, None
    if keys is not None:
        at = parts[0].size
        out = d[:at].view(torch.int64).view(tuple(keys.shape))
    cols = []
    for shape, part in zip(shapes, parts[len(parts) - len(shapes):]):
        cols.append(d[at:at + part.size].view(_F32).view(shape))
        at += part.size
    return out, cols


def _columns(values, lead, dev):
    """One float32 column per value on ``dev``: ``(tensor, step)`` with
    step 1 for one value per leading index (``(N,)`` contiguous) and 0 for
    one value for all.  Values already on ``dev`` are used where they lie;
    the others cross to it together, through :func:`to_card`."""
    n = int(np.prod(lead, dtype=np.int64))
    out = [None] * len(values)
    host = []
    for j, v in enumerate(values):
        if isinstance(v, torch.Tensor) and v.device == dev:
            t = v if v.dtype == _F32 else v.to(_F32)
            if t.numel() == 1:
                out[j] = (t, 0)
            elif t.shape == lead and t.is_contiguous():
                out[j] = (t, 1)
            else:
                out[j] = (t.expand(lead).reshape(n).contiguous(), 1)
        else:
            host.append(j)
    if host:
        _, cols = to_card([values[j] for j in host], lead, dev)
        for j, t in zip(host, cols):
            out[j] = (t, 0 if t.numel() == 1 else 1)
    return out


def _launch(fn, name, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"scenario_draws {name} launch failed: "
                           f"cudaError {err}")
    _build.count_launch(_THIS)
    count("scenario.card_launches")


def _cols_args(cols):
    ptrs = (ctypes.c_void_p * len(cols))(*(t.data_ptr() for t, _ in cols))
    steps = (ctypes.c_longlong * len(cols))(*(s for _, s in cols))
    return ptrs, steps


def stage_keys(keys, stages):
    """jax's ``stage_key(k, stage, 0)`` of observation keys ``(..., 2)`` on
    the card for each stage number in ``stages``: ``(..., len(stages), 2)``
    int64 key data on the keys' device."""
    k, lead, dev = _keys(keys)
    ids = [int(x) & 0xFFFFFFFF for x in stages]
    out = torch.empty(lead + (len(ids), 2), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        _launch(_lib().scenario_stage_launch, "stage keys", k.data_ptr(),
                k.stride(0), k.shape[0], len(ids),
                (ctypes.c_uint * max(len(ids), 1))(*ids), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    return out


def scint_gains(keys, pows, nsub, c_lo, inv_a, fcent, sublen, dnu, dt, mod):
    """Scintillation gains ``(..., C, nsub)`` float32 on the keys' device.

    Args:
        keys: the observations' scintillation stage keys ``(..., 2)``.
        pows: ``(2, C)`` float32 on the keys' device: each channel's
            ``x^-3.4`` and ``x^1.2``, ``x = f / fcent``, rounded once from
            the float64 power (``ops/scenario.py::_scint_grid``).
        nsub: subints, the time cells' grid.
        c_lo, inv_a, fcent, sublen: the band floor's ``x_lo^-3.4``,
            ``1/3.4``, the centre frequency and the subint length, each a
            float32 value.
        dnu, dt, mod: scintillation bandwidth, timescale and modulation
            index, one per leading index or one for all.
    """
    k, lead, dev = _keys(keys)
    nchan, nsub = int(pows.shape[-1]), int(nsub)
    out = torch.empty(lead + (nchan, nsub), dtype=_F32, device=dev)
    cols = _columns((dnu, dt, mod), lead, dev)
    ptrs, steps = _cols_args(cols)
    with torch.cuda.device(dev):
        _launch(_lib().scenario_scint_launch, "scintillation", k.data_ptr(),
                k.stride(0), k.shape[0], nchan, nsub, pows.data_ptr(),
                c_lo, inv_a, fcent, sublen, ptrs, steps, out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    return out


def rfi_levels(keys, chan_ids, nsub, imp_prob, imp_snr, nb_prob, nb_snr,
               noise_level=None):
    """RFI levels and truth mask, both ``(..., C, nsub)`` on the keys'
    device (float32 and bool), for the observations' RFI stage keys
    ``(..., 2)`` and the GLOBAL channel ids ``chan_ids`` ``(C,)`` int64 on
    that device; the levels in noise units, or times ``noise_level`` (one
    per leading index or one for all) where it is given."""
    k, lead, dev = _keys(keys)
    chan_ids = chan_ids.contiguous()
    nchan, nsub = int(chan_ids.shape[0]), int(nsub)
    levels = torch.empty(lead + (nchan, nsub), dtype=_F32, device=dev)
    mask = torch.empty(lead + (nchan, nsub), dtype=torch.bool, device=dev)
    vals = (imp_prob, imp_snr, nb_prob, nb_snr)
    if noise_level is not None:
        vals = vals + (noise_level,)
    cols = _columns(vals, lead, dev)
    ptrs, steps = _cols_args(cols)
    with torch.cuda.device(dev):
        _launch(_lib().scenario_rfi_launch, "rfi", k.data_ptr(), k.stride(0),
                k.shape[0], nchan, nsub, chan_ids.data_ptr(), ptrs, steps,
                len(cols), levels.data_ptr(), mask.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    return levels, mask


def pulse_energies(keys, nsub, mode, param):
    """Per-subint energies ``(..., nsub)`` float32 on the keys' device for
    the observations' transient stage keys ``(..., 2)``, in ``mode`` (one
    of :data:`ENERGY_MODES`) with its parameter (one per leading index or
    one for all)."""
    k, lead, dev = _keys(keys)
    nsub = int(nsub)
    if not 0 < nsub < 2**31:
        raise ValueError(f"pulse energies need 0 < nsub < 2**31, got {nsub}")
    out = torch.empty(lead + (nsub,), dtype=_F32, device=dev)
    cols = _columns((param,), lead, dev)
    ptrs, steps = _cols_args(cols)
    with torch.cuda.device(dev):
        _launch(_lib().scenario_energy_launch, mode, k.data_ptr(),
                k.stride(0), k.shape[0], nsub, ENERGY_MODES.index(mode), ptrs,
                steps, out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    return out
