"""Packaged data assets (counterpart: psrsigsim_tpu/data/): the measured
J1713+0747 L-band template profile of the upstream project, the
NANOGrav 11-yr par file for the same pulsar and the PTA per-pulsar noise
table (reference: psrsigsim/PTA_pulsar_nb_data.txt).

Use :func:`data_path` to locate an asset on disk::

    from psrsigsim_torch.data import data_path
    prof = np.load(data_path("J1713+0747_profile.npy"))
"""

import os

_DIR = os.path.dirname(os.path.abspath(__file__))

__all__ = ["data_path", "list_data"]


def data_path(name):
    """Absolute path of a packaged data asset; raises if it doesn't exist."""
    p = os.path.join(_DIR, name)
    if not os.path.exists(p):
        raise FileNotFoundError(
            f"no packaged data asset {name!r}; available: {list_data()}")
    return p


def list_data():
    """Names of every packaged data asset."""
    return sorted(f for f in os.listdir(_DIR)
                  if not f.endswith(".py") and not f.startswith("__"))
