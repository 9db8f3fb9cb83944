"""Host-side shared numerics and glue.

Behavioral counterpart of the reference's ``psrsigsim/utils/utils.py``.  These
are the *host* (numpy) implementations used for small one-off computations,
config parsing, and parity testing; the batched on-device versions live in
``psrsigsim_torch.ops``.
"""

from __future__ import annotations

import numpy as np

from .quantity import make_quant

__all__ = [
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


def shift_t(y, shift, dt=1):
    """Shift a time series by ``shift`` (same physical units as ``dt``).

    Positive shift delays the signal.  Integer shifts with ``dt == 1`` use a
    circular roll; otherwise the Fourier shift theorem with a real FFT.
    Host-side parity twin of ``ops.shift.fourier_shift`` (reference:
    psrsigsim/utils/utils.py:17-59).
    """
    if isinstance(shift, (int, np.integer)) and dt == 1:
        return np.roll(y, shift)
    spec = np.fft.rfft(y)
    freqs = np.fft.rfftfreq(len(y), d=dt)
    return np.fft.irfft(spec * np.exp(-2j * np.pi * freqs * shift), n=len(y))


def down_sample(ar, fact):
    """Downsample 1-D array by an integer factor via block means
    (reference: utils/utils.py:62-68)."""
    return ar.reshape(-1, fact).mean(axis=1)


def rebin(ar, newlen):
    """General rebinner: downsample ``ar`` to ``newlen`` bins by averaging
    variable-width windows (reference: utils/utils.py:71-91)."""
    edges = np.linspace(0, ar.size, newlen, endpoint=False)
    stride = edges[1] - edges[0]
    width = int(np.ceil(stride))
    out = np.full((newlen, width), np.nan)
    for ii, lo in enumerate(edges):
        hi = min(int(np.ceil(lo + stride)), ar.size)
        lo = int(np.ceil(lo))
        out[ii, : hi - lo] = ar[lo:hi]
    return np.nanmean(out, axis=1)


def top_hat_width(subband_df, subband_f0, DM):
    """Width (ms) of the top-hat dispersion-smearing kernel for one subband,
    Lorimer & Kramer 2005 sec 4.1.1 (reference: utils/utils.py:94-105)."""
    D = 4.148808e3  # s MHz^2 pc^-1 cm^3
    return 2 * D * DM * subband_df / subband_f0**3 * 1.0e3


def savitzky_golay(y, window_size, order, deriv=0, rate=1):
    """Savitzky-Golay smoothing filter (reference: utils/utils.py:108-180)."""
    from math import factorial

    window_size = abs(int(window_size))
    order = abs(int(order))
    if window_size % 2 != 1 or window_size < 1:
        raise TypeError("window_size size must be a positive odd number")
    if window_size < order + 2:
        raise TypeError("window_size is too small for the polynomials order")
    half = (window_size - 1) // 2
    design = np.array(
        [[k**i for i in range(order + 1)] for k in range(-half, half + 1)]
    )
    coeffs = np.linalg.pinv(design)[deriv] * rate**deriv * factorial(deriv)
    head = y[0] - np.abs(y[1 : half + 1][::-1] - y[0])
    tail = y[-1] + np.abs(y[-half - 1 : -1][::-1] - y[-1])
    padded = np.concatenate((head, y, tail))
    return np.convolve(coeffs[::-1], padded, mode="valid")


def find_nearest(array, value):
    """Index of the element nearest to ``value``
    (reference: utils/utils.py:183-191)."""
    idx = np.abs(array - value).argmin()
    if idx == 0 or array[1] < value:
        idx = 1
    return idx


def acf2d(array, speed="fast", mode="full", xlags=None, ylags=None):
    """2-D autocorrelation (reference: utils/utils.py:194-254)."""
    from scipy.signal import correlate, fftconvolve

    if speed in ("fast", "slow"):
        ones = np.ones(np.shape(array))
        norm = fftconvolve(ones, ones, mode=mode)
        if speed == "fast":
            return fftconvolve(array, np.flipud(np.fliplr(array)), mode=mode) / norm
        return correlate(array, array, mode=mode) / norm
    if speed == "exact":
        ny, nx = array.shape
        if xlags is None:
            xlags = np.arange(-nx + 1, nx)
        if ylags is None:
            ylags = np.arange(-ny + 1, ny)
        out = np.zeros((len(ylags), len(xlags)))
        for i, xl in enumerate(xlags):
            for j, yl in enumerate(ylags):
                a = array
                b = array
                if yl > 0:
                    a, b = a[:-yl], b[yl:]
                elif yl < 0:
                    a, b = a[-yl:], b[:yl]
                if xl > 0:
                    a, b = a[:, xl:], b[:, :-xl]
                elif xl < 0:
                    a, b = a[:, :xl], b[:, -xl:]
                prod = (a * b).ravel()
                out[j, i] = np.mean(prod[np.isfinite(prod)])
        return out
    raise ValueError(f"unknown speed {speed!r}")


def text_search(search_list, header_values, filepath, header_line=0,
                file_type="txt"):
    """Pull values from a whitespace-delimited text table by search keys
    (reference: utils/utils.py:257-307)."""
    with open(filepath) as f:
        lines = f.readlines()

    if any(isinstance(h, str) for h in header_values):
        header = lines[header_line].split()
        columns = [header.index(h) for h in header_values]
    else:
        columns = list(np.asarray(header_values))

    hits = []
    for line in lines:
        if all(term in line for term in search_list):
            fields = line.split()
            hits.append(tuple(float(fields[c]) for c in columns))

    if len(hits) == 0:
        raise ValueError(
            f"Combination {search_list} not found in same line of text file."
        )
    if len(hits) > 1:
        raise ValueError(
            f"Combination {search_list} returned multiple results in txt file."
        )
    return hits[0]


# Fixed fields written into generated par files; the reference hardcodes the
# same defaults (utils/utils.py:350-395).
_PAR_DEFAULTS = [
    ("LAMBDA", "10.0"),
    ("BETA", "10.0"),
    ("PMLAMBDA", "0.0"),
    ("PMBETA", "0.0"),
    ("PX", "0.0"),
    ("POSEPOCH", "56000.0"),
]
_PAR_TAIL = [
    ("PEPOCH", "56000.0"),
    ("START", "50000.0"),
    ("FINISH", "60000.0"),
]
_PAR_FOOTER = [
    ("EPHEM", "DE436"),
    ("SOLARN0", "0.00"),
    ("ECL", "IERS2010"),
    ("CLK", "TT(BIPM2015)"),
    ("UNITS", "TDB"),
    ("TIMEEPH", "FB90"),
    ("T2CMETHOD", "TEMPO"),
    ("CORRECT_TROPOSPHERE", "N"),
    ("PLANET_SHAPIRO", "N"),
    ("DILATEFREQ", "N"),
    ("TZRMJD", "56000.0"),
    ("TZRFRQ", "1500.0"),
    ("TZRSITE", "@"),
    ("MODE", "1"),
]


def make_par(signal, pulsar, outpar="simpar.par"):
    """Write a minimal .par file for a simulated pulsar
    (reference: utils/utils.py:350-395)."""
    lines = [f"PSR            {pulsar.name}\n"]
    for key, val in _PAR_DEFAULTS:
        lines.append(f"{key}            {val}\n")
    lines.append(f"F0           {1.0 / pulsar.period.value}\n")
    for key, val in _PAR_TAIL:
        lines.append(f"{key}            {val}\n")
    dm = signal.dm
    lines.append(f"DM                {dm.value if dm is not None else 0.0}\n")
    for key, val in _PAR_FOOTER:
        lines.append(f"{key}                 {val}\n")
    with open(outpar, "w") as f:
        f.writelines(lines)
