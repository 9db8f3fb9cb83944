"""1-D pulse profile conveniences over the portrait classes
(behavioral counterpart of psrsigsim/pulsar/profiles.py; port of
psrsigsim_tpu/models/pulsar/profiles.py)."""

from __future__ import annotations

import numpy as np

from .portraits import DataPortrait, GaussPortrait

__all__ = ["GaussProfile", "DataProfile"]


class GaussProfile(GaussPortrait):
    """Sum-of-Gaussians profile; broadcast to ``Nchan`` identical channels at
    evaluation time (reference: profiles.py:68-115)."""

    def __init__(self, peak=0.5, width=0.05, amp=1):
        super().__init__(peak=peak, width=width, amp=amp)

    def set_Nchan(self, Nchan):
        raise NotImplementedError()


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
