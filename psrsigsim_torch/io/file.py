"""Abstract file interface (behavioral counterpart of psrsigsim/io/file.py)."""

from __future__ import annotations

import numpy as np

__all__ = ["BaseFile", "host_array"]


def host_array(data):
    """``data`` as a numpy array on the host: a signal's data tensor (on
    the card or the CPU) is copied once; an array passes through."""
    if hasattr(data, "detach"):
        return data.detach().cpu().numpy()
    return np.asarray(data)


class BaseFile:
    """Base class for signal data-product files."""

    _path = None
    _signal = None
    _file = None

    def __init__(self, path=None):
        self._path = path

    def save(self, signal):
        raise NotImplementedError()

    def append(self):
        raise NotImplementedError()

    def load(self):
        raise NotImplementedError()

    def to_txt(self):
        raise NotImplementedError()

    def to_psrfits(self):
        raise NotImplementedError()

    @property
    def path(self):
        return self._path

    @path.setter
    def path(self, value):
        self._path = value
