"""The exact-gamma kernel (``csrc/gamma_field.cu``): ``jax.random.gamma``'s
draws, bit for bit, for the exact χ² branch (counterpart: the JAX
package's ``ops/stats.py::_exact_chi2``, ``2·jax.random.gamma(key,
df/2)``, which XLA compiles to a batched while loop, not a Pallas kernel).

Rows of (key, α, n): element ``j`` of row ``r`` is ``scale`` times the
gamma draw of key ``start + j`` of jax's split of the row key — one key
per (channel, 4096-sample block) for the pipelines' blocked fields, one key
with ``prod(shape)`` elements for a shape-level draw.  Marsaglia–Tsang with
XLA's CPU arithmetic, both rejection loops per element
(:func:`~psrsigsim_torch.ops.stats.gamma_plain` says how).

* :func:`gamma_field` — the wrapper.  A CUDA tensor launches the kernel
  (counted in ``gamma_field.launches``); a CPU tensor runs
  :func:`~psrsigsim_torch.ops.stats.gamma_plain`, the same function in
  torch ops.  There is no fallback from one to the other.  Inside an
  open span (:mod:`psrsigsim_torch.runtime.telemetry`) a call on either
  device counts its rows in ``gamma.rows`` and its draws in
  ``gamma.draws``.

α is checked (α > 0, and α ≥ 1 for ``cube``) on the host before anything
is drawn, and its per-row constants ``d``, ``c`` and ``1/α`` are computed
there, counted in ``gamma.host_alpha``.  α comes as a Python number (one
α for every row, what a static df gives) or a tensor; bound for the card,
only the parameter rows go, filled on the card from a number's four
constants or copied from pinned memory, so the launch reads nothing back.
A card tensor α (a per-observation df built on the card) is first read
back to the host, a sync, counted in ``gamma.host_checks``.

The constants come from :func:`~psrsigsim_torch.ops.stats.gamma_consts`
for the kernel and its plain version alike, the same bits on the host
and on the card.  The kernel is built by :mod:`._build` at first use.
"""

from __future__ import annotations

import ctypes

import torch

from ..runtime.telemetry import count
from ..utils.device import to_device
from . import _build
from .stats import check_alpha, gamma_consts, gamma_plain, xla_tables

__all__ = ["gamma_field", "gamma_plain"]

# elements per pass of the plain version on the host: a span's temporaries
# stay small (the element keys and loop state are int64 and float64)
_CPU_SPAN = 1 << 18


def _check(keys, alpha, n, start):
    if keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys must be (rows, 2), got {tuple(keys.shape)}")
    if isinstance(alpha, torch.Tensor):
        if alpha.shape != keys.shape[:1]:
            raise ValueError(f"alpha must be ({keys.shape[0]},), got "
                             f"{tuple(alpha.shape)}")
        if alpha.device.type != "cpu" and alpha.device != keys.device:
            raise ValueError("alpha must lie on the host or on the keys' "
                             "device")
    if int(n) < 0 or int(start) < 0:
        raise ValueError(f"n={n} and start={start} must be >= 0")


def _host_alpha(alpha, cube):
    """α as a float32 CPU tensor (one element for a number), checked there:
    α > 0 (NaN fails it), and α ≥ 1 for ``cube``.  A card tensor is read
    back first, a sync counted in ``gamma.host_checks``."""
    if not isinstance(alpha, torch.Tensor):
        alpha = torch.tensor([float(alpha)], dtype=torch.float32)
    elif alpha.device.type != "cpu":
        count("gamma.host_checks")
        alpha = alpha.cpu()
    alpha = alpha.to(torch.float32)
    check_alpha(alpha)
    if cube and not bool((alpha >= 1.0).all()):
        raise ValueError("cube=True needs alpha >= 1 (no boost)")
    count("gamma.host_alpha")
    return alpha


def _kernel_params(alpha, R, dev, traced):
    """The kernel's ``(R, 4)`` rows ``(α, d, c, 1/α)`` on ``dev`` for a
    checked host α (:func:`_host_alpha`), its constants computed on the
    host: one α's four constants filled in there, per-row ones copied
    through pinned memory.  Nothing is read back."""
    cols = (alpha,) + gamma_consts(alpha, traced)[1:]
    if alpha.numel() == 1:
        params = torch.empty((R, 4), dtype=torch.float32, device=dev)
        for j, col in enumerate(cols):
            params[:, j].fill_(float(col))
        return params
    return to_device(torch.stack(cols, dim=1).contiguous(), dev)


def _plain_spans(keys, alpha, n, start, scale, traced, cube):
    """:func:`gamma_plain` over spans of at most ``_CPU_SPAN`` elements
    (rows grouped, long rows cut): every element is the same as in one
    pass."""
    R = keys.shape[0]
    out = torch.empty((R, n), dtype=torch.float32, device=keys.device)
    rows = max(1, _CPU_SPAN // max(n, 1))
    span = min(n, _CPU_SPAN)
    for r in range(0, R, rows):
        for s in range(0, n, max(span, 1)):
            m = min(span, n - s)
            out[r:r + rows, s:s + m] = gamma_plain(
                keys[r:r + rows], alpha[r:r + rows], m, start + s, traced,
                scale, cube)
    return out


def _lib():
    lib = _build.library("gamma_field")
    fn = lib.gamma_field_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def gamma_field(keys, alpha, n, start=0, scale=1.0, traced=False,
                cube=False):
    """``scale · jax.random.gamma`` draws for rows of (key, α, n).

    Args:
        keys: ``(R, 2)`` key data (uint32 values in an int64 tensor).
        alpha: the shapes (> 0): a Python number, one float32 α for every
            row, or an ``(R,)`` float32 tensor on the host or on the keys'
            device.  It is checked and its constants computed on the host
            (``gamma.host_alpha``); a card tensor is read back for that
            first, a sync (``gamma.host_checks``).
        n: elements a row; element ``j`` draws key ``start + j`` of the
            row key's split.
        start: first element of each row's stream.
        scale: a float32 factor applied to every draw (2 for χ²).
        traced: the JAX package's arithmetic for a traced α (an eager call,
            a per-observation df) instead of a static one
            (:func:`~psrsigsim_torch.ops.stats.gamma_consts`).
        cube: return the accepted ``V = v³`` of each draw instead (rows
            with α ≥ 1; ``scale`` unused), the factor XLA keeps apart when
            it folds ``d`` into a constant.

    Returns:
        ``(R, n)`` float32 on the keys' device.  CUDA tensors launch the
        kernel on the current stream; CPU tensors run the plain version.
        α is checked before anything is drawn or counted: α ≤ 0 or NaN
        (and α < 1 with ``cube``) raise ``ValueError``.
    """
    n, start = int(n), int(start)
    _check(keys, alpha, n, start)
    dev = keys.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"gamma_field runs on cuda or cpu tensors, not {dev}")
    R = keys.shape[0]
    alpha = _host_alpha(alpha, cube)
    count("gamma.rows", R)
    count("gamma.draws", R * n)
    if dev.type == "cpu":
        return _plain_spans(keys, alpha.expand(R), n, start, scale, traced,
                            cube)
    out = torch.empty((R, n), dtype=torch.float32, device=dev)
    if R == 0 or n == 0:
        return out
    params = _kernel_params(alpha, R, dev, traced)
    kd = keys.to(torch.int64) & 0xFFFFFFFF
    words = torch.where(kd >= 2**31, kd - 2**32, kd).to(torch.int32)
    err = _lib().gamma_field_launch(
        words.data_ptr(), params.data_ptr(), xla_tables(dev)[0].data_ptr(),
        out.data_ptr(), R, n, start, float(scale),
        int(bool(traced)) | (2 if cube else 0),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gamma_field kernel launch failed: cudaError {err}")
    _build.count_launch(gamma_field)
    return out


gamma_field.launches = 0
