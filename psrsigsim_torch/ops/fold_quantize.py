"""The fused fold → quantize → pack kernel (``csrc/fold_quantize.cu``).

For every (observation, subint, channel) row it draws the pulse and noise
χ² samples of :mod:`.rng_hw`'s stream at their GLOBAL (channel, time)
index, folds them with the shifted portrait and the noise scale,

    x = pulse · prof[b, c, bin] (· draw_norm when it is not 1)
        (· gain[b, c, sub]) (· energy[b, sub]) + noise · noise_norm[b]
        (+ level[b, c, sub])

with the scenario engine's optional per-row factors (scintillation gain,
single-pulse energy, RFI level; reference:
psrsigsim_tpu/simulate/pipeline.py:272-324), quantizes the row
to PSRFITS int16 as :func:`.quantize.subint_quantize` does, and writes the
packed ``(B, nsub, C, nph+4)`` buffer of the ensemble (codes, optionally
byte-swapped, then DAT_SCL and DAT_OFFS as native-order int16 halves;
reference: psrsigsim_tpu/parallel/ensemble.py:284-322).  The float block
never exists.

* :func:`fold_quantize` — the wrapper.  CUDA tensors launch the kernel
  (counted in ``fold_quantize.launches``); CPU tensors run
  :func:`fold_quantize_plain`.  There is no fallback from one to the
  other.
* :func:`fold_quantize_plain` — the same function as the unfused path
  computes it, on any device, one observation at a time: the sampler's
  plain fields, the fold, then :func:`.quantize.quantize_packed`;
  ``fields=`` feeds given pulse and noise fields in place of the draws.
* :func:`route` — which of the source's kernels a launch takes: the rows
  kernel of the main path's shape class, or the general kernel (rows
  staged in shared memory, or drawn twice when too long for it).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .quantize import quantize_packed
from .rng_hw import CHAN_GROUP, MODES, RNG_BLOCK, rng_field_plain

__all__ = ["fold_quantize", "fold_quantize_plain"]

_BYTE_ORDERS = ("little", "big")


def _check_factors(prof, nsub, gain, energy, level):
    """The optional scenario factors: ``gain`` and ``level`` ``(B, C,
    nsub)``, ``energy`` ``(B, nsub)``, float32 on the portrait's device."""
    B, C, _ = prof.shape
    for name, t, shape in (("gain", gain, (B, C, nsub)),
                           ("energy", energy, (B, nsub)),
                           ("level", level, (B, C, nsub))):
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != prof.device:
            raise ValueError(f"{name} must be on the portrait's device")


def _check_args(seeds, dfs, modes, prof, noise_norm, nsub, chan0, t0,
                byte_order):
    if len(modes) != 2 or any(m not in MODES for m in modes):
        raise ValueError(f"modes must be two of {list(MODES)}, got {modes!r}")
    if byte_order not in _BYTE_ORDERS:
        raise ValueError(f"byte_order must be one of {_BYTE_ORDERS}")
    if prof.dim() != 3 or prof.dtype != torch.float32:
        raise ValueError(f"prof must be (B, C, nph) float32, got "
                         f"{tuple(prof.shape)} {prof.dtype}")
    B = prof.shape[0]
    if tuple(seeds.shape) != (2, B, 2) or seeds.dtype != torch.int32:
        raise ValueError(f"seeds must be (2, {B}, 2) int32, got "
                         f"{tuple(seeds.shape)} {seeds.dtype}")
    if tuple(dfs.shape) != (2, B) or dfs.dtype != torch.float32:
        raise ValueError(f"dfs must be (2, {B}) float32, got "
                         f"{tuple(dfs.shape)} {dfs.dtype}")
    if tuple(noise_norm.shape) != (B,) or noise_norm.dtype != torch.float32:
        raise ValueError(f"noise_norm must be ({B},) float32, got "
                         f"{tuple(noise_norm.shape)} {noise_norm.dtype}")
    if not (seeds.device == dfs.device == prof.device == noise_norm.device):
        raise ValueError("seeds, dfs, prof and noise_norm must be on one device")
    if nsub <= 0 or min(prof.shape) <= 0:
        raise ValueError(f"nsub={nsub} and prof shape {tuple(prof.shape)} "
                         "must be positive")
    if chan0 < 0 or t0 < 0:
        raise ValueError(f"chan0={chan0} and t0={t0} must be non-negative")


def _span(seeds, dfs, mode, b, chan0, t0, nchan, nsamp):
    """Observation ``b``'s field over global samples ``[t0, t0+nsamp)``:
    whole RNG blocks drawn, the span sliced out."""
    b0 = t0 // RNG_BLOCK
    off = t0 - b0 * RNG_BLOCK
    pos = torch.tensor([[chan0 // CHAN_GROUP, b0]], dtype=torch.int32,
                       device=seeds.device)
    field = rng_field_plain(seeds[b:b + 1], dfs[b:b + 1], pos, mode, nchan,
                            off + nsamp)
    return field[0, :, off:]


def fold_quantize_plain(seeds, dfs, modes, prof, noise_norm, *, nsub,
                        draw_norm=1.0, chan0=0, t0=0, byte_order="little",
                        gain=None, energy=None, level=None, fields=None):
    """The kernel's function in torch ops, on any device: the unfused
    path, one observation at a time.

    Same arguments and result as :func:`fold_quantize`.  ``fields``, when
    given, is a pair of ``(B, C, nsub*nph)`` float32 pulse and noise fields
    used in place of the draws (``modes``, ``dfs`` and ``seeds`` are then
    only checked).
    """
    _check_args(seeds, dfs, modes, prof, noise_norm, nsub, chan0, t0,
                byte_order)
    _check_factors(prof, nsub, gain, energy, level)
    B, C, nph = prof.shape
    dev = prof.device
    packed = torch.empty((B, nsub, C, nph + 4), dtype=torch.int16, device=dev)
    finite = torch.empty((B, C), dtype=torch.bool, device=dev)
    for b in range(B):
        if fields is None:
            pulse = _span(seeds[0], dfs[0], modes[0], b, chan0, t0, C,
                          nsub * nph)
            noise = _span(seeds[1], dfs[1], modes[1], b, chan0, t0, C,
                          nsub * nph)
        else:
            pulse, noise = fields[0][b], fields[1][b]
        # the fold in the reference's order (simulate/pipeline.py::fold_pipeline)
        x = pulse.reshape(C, nsub, nph) * prof[b][:, None, :]
        if draw_norm != 1.0:
            x = x * draw_norm
        if gain is not None:
            x = x * gain[b][:, :, None]
        if energy is not None:
            x = x * energy[b][None, :, None]
        x = x + (noise * noise_norm[b]).reshape(C, nsub, nph)
        if level is not None:
            x = x + level[b][:, :, None]
        packed[b], finite[b] = quantize_packed(x.reshape(C, nsub * nph), nsub,
                                               nph, byte_order)
    return packed, finite


def _lib():
    lib = _build.library("fold_quantize")
    fn = lib.fold_quantize_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 2 + [ctypes.c_float, ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong, ctypes.c_int]
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        lib.fold_quantize_route.argtypes = [ctypes.c_int] * 4 + [ctypes.c_longlong]
        lib.fold_quantize_route.restype = ctypes.c_int
    return lib


_ROUTES = {2: "rows", 1: "staged", 0: "two-pass"}


def route(modes, nph, nsub, t0=0):
    """The kernel a launch takes on the current CUDA device: ``"rows"``
    (the main path's: both fields ``chi2_wh``, every row a whole number of
    4-sample quads inside one 4096-sample RNG block), ``"staged"`` (the
    general kernel, rows kept in shared memory) or ``"two-pass"`` (rows too
    long for shared memory, drawn twice)."""
    how = _lib().fold_quantize_route(MODES[modes[0]], MODES[modes[1]],
                                     int(nph), int(nsub), int(t0))
    if how < 0:
        raise RuntimeError("fold_quantize: cannot query the CUDA device")
    return _ROUTES[how]


def fold_quantize(seeds, dfs, modes, prof, noise_norm, *, nsub,
                  draw_norm=1.0, chan0=0, t0=0, byte_order="little",
                  gain=None, energy=None, level=None):
    """Fold, quantize and pack a batch: ``(packed, finite)``.

    Args:
        seeds: ``(2, B, 2)`` int32 key-data words of the pulse and the noise
            field (:func:`.rng_hw.seed_words` of the stage keys).
        dfs: ``(2, B)`` float32 χ² degrees of freedom of the two fields.
        modes: the two fields' sampler modes (``"chi2_wh"``, ...).
        prof: ``(B, C, nph)`` float32 shifted portraits.
        noise_norm: ``(B,)`` float32 radiometer noise scales.
        nsub: subints per observation (each row is ``nph`` samples).
        draw_norm: the pulse term's dynamic-range scale (skipped at 1).
        chan0: GLOBAL index of channel 0 (its group ``chan0 // 8`` keys the
            draws, as in :func:`.rng_hw.hw_chan_field`).
        t0: GLOBAL sample of subint 0's first bin (any value ≥ 0).
        byte_order: ``"big"`` byte-swaps the codes (not scl/offs).
        gain: optional ``(B, C, nsub)`` float32 scintillation gains, a
            factor of the pulse term after ``draw_norm``.
        energy: optional ``(B, nsub)`` float32 single-pulse energies, a
            factor of the pulse term after the gain.
        level: optional ``(B, C, nsub)`` float32 RFI levels, added after
            the noise term.  Each factor present selects a kernel
            instantiation that carries it (one multiply or add per sample,
            rounded as the unfused path rounds it); none present, the
            scenario-free instantiation runs.

    Returns:
        ``packed`` ``(B, nsub, C, nph+4)`` int16 and ``finite`` ``(B, C)``
        bool, True where every sample of the channel was finite before
        quantization.  CUDA tensors launch the kernel on the current
        stream; CPU tensors run :func:`fold_quantize_plain`.
    """
    _check_args(seeds, dfs, modes, prof, noise_norm, nsub, chan0, t0,
                byte_order)
    _check_factors(prof, nsub, gain, energy, level)
    dev = prof.device
    if dev.type == "cpu":
        return fold_quantize_plain(seeds, dfs, modes, prof, noise_norm,
                                   nsub=nsub, draw_norm=draw_norm,
                                   chan0=chan0, t0=t0, byte_order=byte_order,
                                   gain=gain, energy=energy, level=level)
    if dev.type != "cuda":
        raise ValueError(f"fold_quantize runs on cuda or cpu tensors, not {dev}")
    B, C, nph = prof.shape
    if B > 65535 or nsub > 65535:
        raise ValueError(f"batch {B} or nsub {nsub} exceeds the grid limit")
    factors = (gain, energy, level)
    if not all(t.is_contiguous() for t in (seeds, dfs, prof, noise_norm)
               + tuple(f for f in factors if f is not None)):
        raise ValueError("seeds, dfs, prof, noise_norm and the factors must "
                         "be contiguous")
    lib = _lib()
    packed = torch.empty((B, nsub, C, nph + 4), dtype=torch.int16, device=dev)
    flags = torch.empty((B, nsub, C), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fold_quantize_launch(
        seeds.data_ptr(), dfs.data_ptr(), MODES[modes[0]], MODES[modes[1]],
        prof.data_ptr(), noise_norm.data_ptr(), float(draw_norm),
        int(draw_norm != 1.0), packed.data_ptr(), flags.data_ptr(), B, C,
        nsub, nph, int(chan0) // CHAN_GROUP, int(t0),
        int(byte_order == "big"), stream,
        *(None if f is None else f.data_ptr() for f in factors))
    if err != 0:
        raise RuntimeError(f"fold_quantize kernel launch failed: cudaError {err}")
    _build.count_launch(fold_quantize)
    return packed, flags.all(dim=1)


fold_quantize.launches = 0
