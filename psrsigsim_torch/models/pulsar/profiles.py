"""1-D pulse profile conveniences over the portrait classes
(behavioral counterpart of psrsigsim/pulsar/profiles.py; port of
psrsigsim_tpu/models/pulsar/profiles.py)."""

from __future__ import annotations

import numpy as np

from .portraits import DataPortrait, GaussPortrait, PulsePortrait

__all__ = ["PulseProfile", "GaussProfile", "UserProfile", "DataProfile"]


class PulseProfile(PulsePortrait):
    """Base class for 1-D pulse profiles (reference: profiles.py:10-65)."""

    _profile = None

    def __call__(self, phases=None):
        if phases is None:
            if self._profile is None:
                print("Warning: base profile not generated, returning `None`")
            return self._profile
        return self.calc_profile(phases)

    def init_profile(self, Nphase):
        ph = np.arange(Nphase) / Nphase
        self._profile = self.calc_profile(ph)
        self._Amax = self._profile.max()
        self._profile = self._profile / self.Amax

    def calc_profile(self, phases):
        raise NotImplementedError()

    @property
    def profile(self):
        return self._profile


class GaussProfile(GaussPortrait):
    """Sum-of-Gaussians profile; broadcast to ``Nchan`` identical channels at
    evaluation time (reference: profiles.py:68-115)."""

    def __init__(self, peak=0.5, width=0.05, amp=1):
        super().__init__(peak=peak, width=width, amp=amp)

    def set_Nchan(self, Nchan):
        raise NotImplementedError()


class UserProfile(PulseProfile):
    """Profile specified by a callable ``f(phases) -> intensity``
    (reference: profiles.py:118-153)."""

    def __init__(self, profile_func):
        self._generator = profile_func

    def calc_profile(self, phases):
        self._profile = np.asarray(self._generator(np.asarray(phases)))
        self._Amax = self._Amax if hasattr(self, "_Amax") else np.max(self._profile)
        return self._profile / self._Amax

    def calc_profiles(self, phases, Nchan=None):
        """Portrait-style evaluation: tile the 1-D profile across channels."""
        prof = self.calc_profile(phases)
        n = 1 if Nchan is None else Nchan
        return np.tile(prof, (n, 1))

    def init_profiles(self, Nphase, Nchan=None):
        ph = np.arange(Nphase) / Nphase
        self._profiles = self.calc_profiles(ph, Nchan=Nchan)
        self._Amax = self._profiles.max()
        self._profiles = self._profiles / self._Amax
        self._max_profile = self._pick_max_profile(self._profiles)


class DataProfile(DataPortrait):
    """Profile(s) from sampled data, tiled to ``Nchan`` channels when 1-D
    (reference: profiles.py:155-205)."""

    def __init__(self, profiles, phases=None, Nchan=None):
        profiles = np.array(profiles, dtype=np.float64, copy=True)
        if np.any(profiles < 0.0):
            print(
                "Warning: Some phase bins of input profile are negative, "
                "replacing them with zeros..."
            )
            profiles[profiles < 0.0] = 0.0

        self._phases = phases
        if profiles.ndim == 1:
            if Nchan is None:
                Nchan = 1
            profiles = np.tile(profiles, (Nchan, 1))

        super().__init__(profiles=profiles, phases=phases)

    def set_Nchan(self, Nchan):
        raise NotImplementedError()
