"""Pulse portraits: frequency-resolved pulse profile sets (counterpart:
psrsigsim_tpu/models/pulsar/portraits.py).

Behavioral counterpart of psrsigsim/pulsar/portraits.py.  Portraits are
*config-time* objects: construction, normalization and evaluation run on
the host in numpy float64, matching the reference numerically (at an even
phase grid for fold mode, at every sample's phase for SEARCH mode);
``profiles_device`` puts the normalized ``(Nchan, Nphase)`` block on a
device as float32.

A portrait is an INTENSITY series even for amplitude-style signals.
"""

from __future__ import annotations

import numpy as np

from ...ops.interp import PchipCoeffs, pchip_eval_np, pchip_fit_np
from ...ops.window import offpulse_window

__all__ = ["PulsePortrait", "GaussPortrait", "DataPortrait", "UserPortrait"]


class PulsePortrait:
    """Base class: a set of profiles across the band
    (reference: portraits.py:9-91)."""

    _profiles = None

    def __call__(self, phases=None):
        if phases is None:
            if self._profiles is None:
                print("Warning: base profiles not generated, returning `None`")
            return self._profiles
        return self.calc_profiles(phases)

    def init_profiles(self, Nphase, Nchan=None):
        """Evaluate on an even grid and normalize by the global max
        (reference: portraits.py:32-45)."""
        ph = np.arange(Nphase) / Nphase
        self._profiles = self.calc_profiles(ph, Nchan=Nchan)
        self._Amax = self._profiles.max()
        self._profiles = self._profiles / self.Amax
        self._max_profile = self._pick_max_profile(self._profiles)

    @staticmethod
    def _pick_max_profile(profiles):
        """The first channel achieving the global maximum — the reference
        selects the row with ``pr.max() == 1.0`` (portraits.py:45)."""
        row = int(np.argmax(profiles.max(axis=1)))
        return profiles[row]

    def calc_profiles(self, phases, Nchan=None):
        raise NotImplementedError()

    def _calcOffpulseWindow(self, Nphase=None):
        """Off-pulse window of the peak profile (PyPulse-derived; reference:
        portraits.py:62-82).  Delegates to the exact host op."""
        return offpulse_window(self._max_profile, Nphase)

    @property
    def profiles(self):
        return self._profiles

    @property
    def Amax(self):
        return self._Amax

    def profiles_device(self, device=None):
        """Normalized profile block ``(Nchan, Nphase)`` as a float32 tensor
        on ``device`` (the card unless the caller names another)."""
        import torch

        from ...utils.device import resolve_device

        if self._profiles is None:
            raise ValueError("run init_profiles first")
        return torch.as_tensor(np.asarray(self._profiles, dtype=np.float32),
                               device=resolve_device(device))


class GaussPortrait(PulsePortrait):
    """Sum-of-Gaussians portrait (reference: portraits.py:94-198).

    Component params may be scalars (single Gaussian, tiled across channels),
    1-D arrays (multi-component profile, tiled), or 2-D arrays
    ``(Nchan, Ncomp)`` — which the reference collapses to a single summed
    profile tiled to all channels (kept; the JAX package's DIVERGENCES #8).
    """

    def __init__(self, peak=0.5, width=0.05, amp=1):
        self._peak = peak
        self._width = width
        self._amp = amp
        self._profiles = None

    def init_profiles(self, Nphase, Nchan=None):
        # the Gauss override does NOT renormalize again — calc_profiles
        # already divides by the cached Amax (reference: portraits.py:131-140)
        ph = np.arange(Nphase) / Nphase
        self._profiles = self.calc_profiles(ph, Nchan=Nchan)
        self._max_profile = self._pick_max_profile(self._profiles)

    def calc_profiles(self, phases, Nchan=None):
        ph = np.asarray(phases, dtype=np.float64)
        peak = self._peak
        if hasattr(peak, "ndim") and getattr(peak, "ndim", 0) >= 1:
            peak = np.asarray(peak)
            width = np.asarray(self._width)
            amp = np.asarray(self._amp)
            if peak.ndim == 1:
                if Nchan is None:
                    raise ValueError(
                        "Nchan must be provided if only 1-dim profile "
                        "information provided."
                    )
                profile = _gaussian_mult_1d(ph, peak, width, amp)
                profiles = np.tile(profile, (Nchan, 1))
            elif peak.ndim == 2:
                nchan = peak.shape[0]
                profiles = _gaussian_mult_2d(ph, peak, width, amp, nchan)
            else:
                raise ValueError("peak array must be 1-D or 2-D")
        else:
            if Nchan is None:
                raise ValueError(
                    "Nchan must be provided if only 1-dim profile "
                    "information provided."
                )
            profile = _gaussian_sing_1d(ph, peak, self._width, self._amp)
            profiles = np.tile(profile, (Nchan, 1))

        # Amax cached on first evaluation and reused (reference:
        # portraits.py:177) so repeated calls share one normalization
        self._Amax = self._Amax if hasattr(self, "_Amax") else np.amax(profiles)
        return profiles / self._Amax

    @property
    def peak(self):
        return self._peak

    @property
    def width(self):
        return self._width

    @property
    def amp(self):
        return self._amp


class DataPortrait(PulsePortrait):
    """Portrait interpolated from sampled profile data via PCHIP
    (reference: portraits.py:200-267)."""

    def __init__(self, profiles, phases=None):
        profiles = np.array(profiles, dtype=np.float64, copy=True)
        if np.any(profiles < 0.0):
            print(
                "Warning: Some phase bins of input profile are negative, "
                "replacing them with zeros..."
            )
            profiles[profiles < 0.0] = 0.0

        if phases is None:
            n = profiles.shape[1]
            if np.any(profiles[:, 0] != profiles[:, -1]):
                # enforce periodicity
                profiles = np.append(profiles, profiles[:, :1], axis=1)
                phases = np.arange(n + 1) / n
            else:
                phases = np.arange(n) / n
        else:
            phases = np.asarray(phases, dtype=np.float64)
            if phases[-1] != 1:
                phases = np.append(phases, 1)
                profiles = np.append(profiles, profiles[:, :1], axis=1)
            elif np.any(profiles[:, 0] != profiles[:, -1]):
                profiles[:, -1] = profiles[:, 0]

        self._phases_grid = phases
        self._profile_data = profiles
        self._coeffs = pchip_fit_np(phases, profiles)

    def calc_profiles(self, phases, Nchan=None):
        profiles = pchip_eval_np(self._coeffs, np.asarray(phases))
        # no Amax caching here — each call normalizes by its own max unless
        # init_profiles set one (reference: portraits.py:266)
        amax = self._Amax if hasattr(self, "_Amax") else np.max(profiles)
        return profiles / amax

    def coeffs_device(self, device=None):
        """The PCHIP coefficients as float32 tensors on ``device`` (default:
        the CUDA card), for :func:`psrsigsim_torch.ops.pchip_eval`."""
        import torch

        from ...utils.device import resolve_device

        dev = resolve_device(device)
        return PchipCoeffs(*(torch.as_tensor(np.asarray(a, np.float32),
                                             device=dev)
                             for a in self._coeffs))


class UserPortrait(PulsePortrait):
    """User-specified 2-D portrait from a callable (stub in the
    reference, portraits.py:270-275; completed in the JAX package like the
    1-D ``UserProfile`` the reference does implement, profiles.py:118-153).

    ``portrait_func(phases, Nchan) -> (Nchan, Nphase)`` evaluates the
    frequency-resolved intensity at the given phases (in [0, 1)); the
    base-class normalization (global max across all channels,
    reference portraits.py:32-45) applies on top.
    """

    def __init__(self, portrait_func):
        if not callable(portrait_func):
            raise TypeError("UserPortrait takes a callable "
                            "portrait_func(phases, Nchan)")
        self._generator = portrait_func

    def init_profiles(self, Nphase, Nchan=None):
        # like GaussPortrait's override: calc_profiles already divides by
        # the cached Amax, so no second normalization.  The normalizer is
        # pinned from a DENSE grid (>= 2048 bins) so a later sparse-grid
        # call can never cache a peak-missing Amax.
        self._ensure_amax(max(int(Nphase), 2048), Nchan)
        ph = np.arange(Nphase) / Nphase
        self._profiles = self.calc_profiles(ph, Nchan=Nchan)
        self._max_profile = self._pick_max_profile(self._profiles)

    def _ensure_amax(self, ndense, Nchan):
        if hasattr(self, "_Amax"):
            return
        ph = np.arange(ndense) / ndense
        n = 1 if Nchan is None else int(Nchan)
        out = np.asarray(self._generator(ph, n), dtype=np.float64)
        amax = float(np.amax(out))
        if not (np.isfinite(amax) and amax > 0):
            raise ValueError(
                f"portrait_func's maximum over a {ndense}-bin phase grid "
                f"is {amax}; the portrait must be positive somewhere to "
                "define the normalization")
        self._Amax = amax

    def calc_profiles(self, phases, Nchan=None):
        ph = np.asarray(phases, dtype=np.float64)
        if np.any(ph > 1) or np.any(ph < 0):
            raise ValueError("Phase values must all lie within [0,1].")
        n = 1 if Nchan is None else int(Nchan)
        out = np.asarray(self._generator(ph, n), dtype=np.float64)
        if out.shape != (n, len(ph)):
            raise ValueError(
                f"portrait_func returned shape {out.shape}, expected "
                f"({n}, {len(ph)})")
        # Amax cached once, from a dense evaluation (never this call's
        # possibly-sparse grid), and validated > 0, like GaussPortrait
        # (reference: portraits.py:177)
        self._ensure_amax(max(len(ph), 2048), Nchan)
        return out / self._Amax


def _gaussian_sing_1d(phases, peak, width, amp):
    if np.any(phases > 1) or np.any(phases < 0):
        raise ValueError("Phase values must all lie within [0,1].")
    return amp * np.exp(-0.5 * ((phases - peak) / width) ** 2)


def _gaussian_mult_1d(phases, peaks, widths, amps):
    if np.any(phases > 1) or np.any(phases < 0):
        raise ValueError("Phase values must all lie within [0,1].")
    comps = amps[:, None] * np.exp(
        -0.5 * ((phases[None, :] - peaks[:, None]) / widths[:, None]) ** 2
    )
    return comps.sum(axis=0)


def _gaussian_mult_2d(phases, peaks, widths, amps, nchan):
    # reference tiles the SAME summed profile to every channel
    # (portraits.py:293-296); kept for parity (the JAX package's DIVERGENCES #8)
    return np.array(
        [_gaussian_mult_1d(phases, peaks[:], widths[:], amps[:]) for _ in range(nchan)]
    )
