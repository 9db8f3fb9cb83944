"""Shared utilities: units at the config boundary, constants, jax-compatible
PRNG keys, device resolution and host-side numerics (counterpart:
psrsigsim_tpu/utils/)."""

from .constants import DM_K, DM_K_MS_MHZ2, KB_JY_M2_PER_K, KOLMOGOROV_BETA
from .progress import ConsoleProgress
from .quantity import Quantity, Unit, UnitConversionError, make_quant
from .utils import (
    acf2d,
    down_sample,
    find_nearest,
    make_par,
    rebin,
    savitzky_golay,
    shift_t,
    text_search,
    top_hat_width,
)

# device.py and rng.py import torch and load on first use: a host-only
# consumer of the numpy utilities above (the PSRFITS writer processes)
# must not pay for importing torch
_LAZY = {"resolve_device": "device", "STAGES": "rng", "key": "rng",
         "as_key": "rng", "fold_in": "rng", "stage_key": "rng",
         "random_bits": "rng", "split": "rng", "randint": "rng",
         "permutation": "rng",
         "KeySequence": "rng", "default_keys": "rng", "set_seed": "rng",
         "next_key": "rng"}


def __getattr__(name):
    import importlib

    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)


__all__ = [
    "ConsoleProgress",
    "make_quant",
    "Quantity",
    "Unit",
    "UnitConversionError",
    "DM_K",
    "DM_K_MS_MHZ2",
    "KOLMOGOROV_BETA",
    "KB_JY_M2_PER_K",
    "resolve_device",
    "STAGES",
    "key",
    "as_key",
    "fold_in",
    "stage_key",
    "random_bits",
    "split",
    "randint",
    "permutation",
    "KeySequence",
    "default_keys",
    "set_seed",
    "next_key",
    "shift_t",
    "down_sample",
    "rebin",
    "top_hat_width",
    "savitzky_golay",
    "find_nearest",
    "acf2d",
    "text_search",
    "make_par",
]
