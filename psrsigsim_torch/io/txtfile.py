"""PSRCHIVE pdv-style text output (counterpart: psrsigsim_tpu/io/txtfile.py;
behavioral counterpart of psrsigsim/io/txtfile.py)."""

from __future__ import annotations

import numpy as np

from ..utils.quantity import make_quant
from . import native
from .file import BaseFile, host_array

__all__ = ["TxtFile"]


class TxtFile(BaseFile):
    """Save simulated signals as PSRCHIVE ``pdv``-style text files.

    Parameters
    ----------
    path : str
        name and path of the new text file
    """

    def __init__(self, path=None):
        super().__init__(path=path)
        self._tbin = None
        self._nbin = None
        self._nchan = None
        self._npol = None
        self._nrows = None
        self._tsubint = None
        self._chan_bw = None
        self._obsbw = None
        self._obsfreq = None

    def save_psrchive_pdv(self, signal, pulsar):
        """Dump the signal in PSRCHIVE pdv text format, chunked into files of
        ~100 (subint, channel) blocks (reference: io/txtfile.py:39-92).

        The JAX package's divergence #5 (the root DIVERGENCES.md): output
        files are numbered sequentially
        (``path_1.txt``, ``path_2.txt``, ...) — the reference derives the
        index from ``dump_val // 100``, which overwrites earlier chunks.
        """
        self._get_signal_params(signal, pulsar)
        if self.path is None:
            self._path = "PsrSigSim_Simulated_Pulsar.ar"

        # the signal's data tensor (on the card or the CPU) crosses to the
        # host once
        data = host_array(signal.data)
        rms = np.sqrt((1.0 / len(data)) * np.sum(data**2))
        header = (
            "# File: %s Src: %s Nsub: %s Nch: %s Npol: %s Nbin: %s RMS: %s \n"
            % (self.path, pulsar.name, str(self.nrows), str(self.nchan),
               str(self.npol), str(self.nbin), str(rms))
        )
        lines = [header]
        if self.npol != 1:
            print("Warning: Only saving total intensity, multiple "
                  "polarizations not yet implemented")

        dump_val = 0
        file_num = 0
        use_native = (native.available() and data.dtype == np.float32
                      and data.shape[1] >= self.nbin)
        for ii in range(self.nrows):
            mjd_mid = 56000.0 + (ii + 1) * (self.tsubint.to("day").value) / 2.0
            for ff in range(self.nchan):
                freq = signal.dat_freq[ff].value
                lines.append(
                    "# MJD(mid): %s Tsub: %s Freq: %s BW: %s \n"
                    % (mjd_mid, self.tsubint.value, freq,
                       self.obsbw.value / self.nchan)
                )
                row = data[ff]
                if use_native:
                    # C++ formatter, byte-identical to the loop below
                    lines.append(
                        native.format_pdv_block(
                            row[: self.nbin], ii, ff
                        ).decode("ascii")
                    )
                else:
                    for bb in range(self.nbin):
                        lines.append("%s %s %s %s \n" % (ii, ff, bb, row[bb]))
                dump_val += 1
            if dump_val >= 100:
                file_num += 1
                with open(self.path + "_%s.txt" % file_num, "w") as pdv_file:
                    pdv_file.writelines(lines)
                lines = [header]
                dump_val = 0
        file_num += 1
        with open(self.path + "_%s.txt" % file_num, "w") as pdv_file:
            pdv_file.writelines(lines)

    def _get_signal_params(self, signal, pulsar):
        """Pull save dimensions from the signal
        (reference: io/txtfile.py:94-109)."""
        self.nchan = signal.Nchan
        self.tbin = float((1.0 / signal.samprate).to("s").value)
        self.nbin = int((signal.samprate * pulsar.period).decompose())
        self.npol = signal.Npols
        self.nrows = signal.nsub
        self.obsfreq = signal.fcent
        self.obsbw = signal.bw
        self.chan_bw = signal.bw / signal.Nchan
        self.tsubint = signal.sublen
        self.nsubint = self.nrows

    # -- unit-tagged properties (reference: io/txtfile.py:112-182) ----------
    @property
    def tbin(self):
        return self._tbin

    @tbin.setter
    def tbin(self, value):
        self._tbin = make_quant(value, "s")

    @property
    def npol(self):
        return self._npol

    @npol.setter
    def npol(self, value):
        self._npol = value

    @property
    def nchan(self):
        return self._nchan

    @nchan.setter
    def nchan(self, value):
        self._nchan = value

    @property
    def nbin(self):
        return self._nbin

    @nbin.setter
    def nbin(self, value):
        self._nbin = value

    @property
    def nrows(self):
        return self._nrows

    @nrows.setter
    def nrows(self, value):
        self._nrows = value

    @property
    def obsfreq(self):
        return self._obsfreq

    @obsfreq.setter
    def obsfreq(self, value):
        self._obsfreq = make_quant(value, "MHz")

    @property
    def obsbw(self):
        return self._obsbw

    @obsbw.setter
    def obsbw(self, value):
        self._obsbw = make_quant(value, "MHz")

    @property
    def chan_bw(self):
        return self._chan_bw

    @chan_bw.setter
    def chan_bw(self, value):
        self._chan_bw = make_quant(value, "MHz")

    @property
    def tsubint(self):
        return self._tsubint

    @tsubint.setter
    def tsubint(self, value):
        self._tsubint = make_quant(value, "s")
