"""Abstract file interface (behavioral counterpart of psrsigsim/io/file.py)."""

from __future__ import annotations

__all__ = ["BaseFile"]


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
