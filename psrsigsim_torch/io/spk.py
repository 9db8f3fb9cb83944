"""JPL SPK (SPICE kernel) reader: DAF container + Type 2/3 Chebyshev
segments.

The reference gets JPL-development-ephemeris barycentering for free from
PINT (reference: psrsigsim/io/psrfits.py:144-177 loading DE436).  This
environment ships no ephemeris files, so the built-in solar-system model
is analytic (io/ephem.py) with a documented few-millisecond ABSOLUTE
Roemer uncertainty.  This module closes that gap for any user who has a
real kernel: point ``PSS_EPHEM`` (or :func:`psrsigsim_torch.io.ephem.
set_ephemeris`) at a ``de440s.bsp``-style file and ``observatory_ssb``
evaluates Earth/Sun barycentric positions from the kernel's Chebyshev
polynomials — the same data path PINT/TEMPO use — instead of the
analytic series.

Implemented from the public NAIF DAF/SPK specification (SPICE "Double
precision Array File" required reading): the DAF file record, the
doubly-linked summary record list, and data types 2 (position-only
Chebyshev) and 3 (position+velocity Chebyshev; the velocity block is
ignored).  Both byte orders are handled.  A minimal Type 2 WRITER is
included so the reader can be tested against kernels with exactly known
polynomial content (tests/test_spk.py) without shipping JPL data.
"""

from __future__ import annotations

import os
import struct

import numpy as np

__all__ = ["SPKKernel", "write_spk_type2", "SSB", "SUN", "EMB", "EARTH",
           "MOON"]

_RECLEN = 1024  # DAF record length, bytes (128 doubles)

# NAIF integer codes this module cares about
SSB = 0
SUN = 10
EMB = 3      # Earth-Moon barycenter
EARTH = 399
MOON = 301


class _Segment:
    __slots__ = ("target", "center", "frame", "dtype", "start", "end",
                 "et0", "et1", "init", "intlen", "rsize", "n", "ncoef")

    def __init__(self, target, center, frame, dtype, start, end, et0, et1):
        self.target = target
        self.center = center
        self.frame = frame
        self.dtype = dtype
        self.start = start  # 1-based word address of first element
        self.end = end
        self.et0 = et0
        self.et1 = et1
        # directory fields (init/intlen/rsize/n/ncoef) are cached by
        # SPKKernel._finish_segment once the data area is readable


class SPKKernel:
    """A parsed SPK file; evaluates barycentric chains of Chebyshev
    segments.

    Parameters
    ----------
    path : str
        ``.bsp`` file (DAF/SPK, types 2/3).
    """

    def __init__(self, path):
        self.path = path
        with open(path, "rb") as f:
            self._raw = f.read()
        if len(self._raw) < _RECLEN:
            raise ValueError(f"{path}: not a DAF file (too short)")
        locidw = self._raw[0:8].decode("ascii", "replace")
        if not locidw.startswith("DAF/SPK"):
            raise ValueError(f"{path}: LOCIDW {locidw!r} is not DAF/SPK")
        locfmt = self._raw[88:96].decode("ascii", "replace")
        if locfmt.startswith("LTL"):
            self._endian = "<"
        elif locfmt.startswith("BIG"):
            self._endian = ">"
        else:
            raise ValueError(f"{path}: unknown binary format {locfmt!r}")
        e = self._endian
        nd, ni = struct.unpack(e + "2i", self._raw[8:16])
        if nd != 2 or ni != 6:
            raise ValueError(f"{path}: ND/NI = {nd}/{ni}, expected 2/6 "
                             "for SPK")
        (fward,) = struct.unpack(e + "i", self._raw[76:80])
        self.segments = []
        self._skipped_frames = {}  # body -> {non-J2000 frame ids seen}
        self._parse_summaries(fward)
        self._by_target = {}
        for seg in self.segments:
            self._by_target.setdefault(seg.target, []).append(seg)

    # -- DAF structure ----------------------------------------------------

    def _record(self, recno):
        """1-based 1024-byte record."""
        off = (recno - 1) * _RECLEN
        return self._raw[off : off + _RECLEN]

    def _words(self, start, count):
        """``count`` doubles at 1-based word address ``start``."""
        off = (start - 1) * 8
        return np.frombuffer(self._raw, dtype=self._endian + "f8",
                             count=count, offset=off)

    def _parse_summaries(self, recno):
        e = self._endian
        while recno > 0:
            rec = self._record(recno)
            nxt, _prev, nsum = struct.unpack(e + "3d", rec[0:24])
            ss = 2 + (6 + 1) // 2  # summary size in doubles (ND=2, NI=6)
            for i in range(int(nsum)):
                off = 24 + i * ss * 8
                et0, et1 = struct.unpack(e + "2d", rec[off : off + 16])
                ints = struct.unpack(e + "6i", rec[off + 16 : off + 40])
                target, center, frame, dtype, start, end = ints
                if dtype not in (2, 3):
                    continue  # skip unsupported segment types
                if frame != 1:
                    # 1 = J2000/ICRF, the only frame this module's
                    # consumers (equatorial barycentering) can accept;
                    # silently rotating e.g. ECLIPJ2000 vectors would
                    # corrupt Roemer delays by the obliquity.  Merged or
                    # augmented kernels routinely carry e.g. lunar-frame
                    # segments for bodies this module never queries, so a
                    # non-J2000 segment is SKIPPED here (like unsupported
                    # data types) and only rejected if a query actually
                    # needs it (_eval_body names the skipped frame then).
                    self._skipped_frames.setdefault(target, set()).add(frame)
                    continue
                self.segments.append(self._finish_segment(
                    _Segment(target, center, frame, dtype, start, end,
                             et0, et1)))
            recno = int(nxt)

    def _finish_segment(self, seg):
        """Cache the segment directory (last 4 doubles of the data area)."""
        init, intlen, rsize, n = self._words(seg.end - 3, 4)
        seg.init, seg.intlen = float(init), float(intlen)
        seg.rsize, seg.n = int(rsize), int(n)
        ncomp = 3 if seg.dtype == 2 else 6
        seg.ncoef = (seg.rsize - 2) // ncomp
        return seg

    # -- evaluation -------------------------------------------------------

    def _eval_segment(self, seg, et):
        """Position (km) of seg.target relative to seg.center at ET
        seconds past J2000 (TDB, array), grouped by Chebyshev record."""
        idx = ((et - seg.init) // seg.intlen).astype(int)
        # et values are pre-checked to lie in [et0, et1]; only the exact
        # right endpoint may round to record n
        idx = np.clip(idx, 0, seg.n - 1)
        out = np.empty((et.size, 3))
        for i in np.unique(idx):
            rec = self._words(seg.start + int(i) * seg.rsize, seg.rsize)
            mid, radius = rec[0], rec[1]
            coeffs = rec[2 : 2 + 3 * seg.ncoef].reshape(3, seg.ncoef)
            m = idx == i
            tau = (et[m] - mid) / radius
            out[m] = np.polynomial.chebyshev.chebval(tau, coeffs.T).T
        return out

    def _eval_body(self, body, et):
        """Per-epoch segment selection: every epoch must be covered by
        SOME segment for ``body`` (epochs may span segment boundaries)."""
        pos = np.empty((et.size, 3))
        centers = np.empty(et.size, dtype=int)
        remaining = np.ones(et.size, dtype=bool)
        for seg in self._by_target.get(body, ()):  # file order
            m = remaining & (et >= seg.et0) & (et <= seg.et1)
            if not np.any(m):
                continue
            pos[m] = self._eval_segment(seg, et[m])
            centers[m] = seg.center
            remaining &= ~m
        if np.any(remaining):
            bad = et[remaining][0]
            skipped = sorted(self._skipped_frames.get(body, ()))
            hint = (f" (the kernel has segments for this body only in "
                    f"non-J2000 frame(s) {skipped}, which were skipped "
                    "at load)" if skipped else "")
            raise ValueError(
                f"{self.path}: no J2000 type-2/3 segment for body {body} "
                f"covering ET {bad:.0f} s past J2000{hint}")
        return pos, centers

    def position(self, target, et, center=SSB):
        """Position (km) of ``target`` relative to ``center`` at ``et``
        (TDB seconds past J2000; scalar or array), composing segment
        chains through intermediate centers (e.g. 399 -> 3 -> 0)."""
        et_arr = np.atleast_1d(np.asarray(et, np.float64))

        def chain_to_ssb(body):
            pos = np.zeros((et_arr.size, 3))
            seen = set()
            while body != SSB:
                if body in seen:
                    raise ValueError(f"segment chain loop at body {body}")
                seen.add(body)
                step, centers = self._eval_body(body, et_arr)
                pos = pos + step
                uniq = np.unique(centers)
                if uniq.size != 1:
                    # epochs crossing segments with DIFFERENT centers
                    # would need per-epoch chains; no real kernel mixes
                    # centers for one body across a contiguous span
                    raise ValueError(
                        f"{self.path}: body {body} segments disagree on "
                        f"center ({uniq.tolist()}) across the epoch span")
                body = int(uniq[0])
            return pos

        out = chain_to_ssb(target)
        if center != SSB:
            out = out - chain_to_ssb(center)
        return out if np.ndim(et) else out[0]


# ---------------------------------------------------------------------------
# Minimal Type 2 writer (testing/tooling; not a NAIF replacement)
# ---------------------------------------------------------------------------


def write_spk_type2(path, segments, *, endian="<"):
    """Write a minimal single-summary-record DAF/SPK file.

    ``segments``: list of dicts with keys ``target``, ``center``,
    ``frame``, ``init`` (ET s), ``intlen`` (s), and ``coeffs`` of shape
    ``(n_records, 3, ncoef)`` — Chebyshev coefficients per component per
    interval.  Used by the test suite to build kernels with exactly
    known content; layout follows the public DAF spec, so the files are
    also readable by SPICE-compatible tools.
    """
    if len(segments) > 25:
        raise ValueError("single-summary-record writer: <= 25 segments")

    data_words = []  # doubles, in file order after the name record
    seg_meta = []
    # records 1 (file record), 2 (summary), 3 (name); data starts rec 4
    next_word = 3 * _RECLEN // 8 + 1
    for s in segments:
        coeffs = np.asarray(s["coeffs"], np.float64)
        nrec, ncomp, ncoef = coeffs.shape
        if ncomp != 3:
            raise ValueError("type 2 coefficients must have 3 components")
        rsize = 2 + 3 * ncoef
        init, intlen = float(s["init"]), float(s["intlen"])
        words = []
        for i in range(nrec):
            mid = init + (i + 0.5) * intlen
            radius = intlen / 2.0
            words.extend([mid, radius])
            words.extend(coeffs[i].reshape(-1))
        words.extend([init, intlen, float(rsize), float(nrec)])
        start = next_word
        end = start + len(words) - 1
        seg_meta.append((s, init, init + nrec * intlen, start, end))
        data_words.extend(words)
        next_word = end + 1

    e = endian
    nrec_total = 3 + (len(data_words) * 8 + _RECLEN - 1) // _RECLEN
    out = bytearray(nrec_total * _RECLEN)
    out[0:8] = b"DAF/SPK "
    struct.pack_into(e + "2i", out, 8, 2, 6)
    out[16:76] = b"psrsigsim_torch test kernel".ljust(60)
    struct.pack_into(e + "3i", out, 76, 2, 2, next_word)  # FWARD BWARD FREE
    out[88:96] = b"LTL-IEEE" if e == "<" else b"BIG-IEEE"

    # summary record (record 2)
    off = _RECLEN
    struct.pack_into(e + "3d", out, off, 0.0, 0.0, float(len(segments)))
    ss_off = off + 24
    for s, et0, et1, start, end in seg_meta:
        struct.pack_into(e + "2d", out, ss_off, et0, et1)
        struct.pack_into(e + "6i", out, ss_off + 16, int(s["target"]),
                         int(s["center"]), int(s.get("frame", 1)), 2,
                         start, end)
        ss_off += 5 * 8
    # name record (record 3): blank names
    out[2 * _RECLEN : 3 * _RECLEN] = b" " * _RECLEN

    arr = np.asarray(data_words, dtype=e + "f8").tobytes()
    out[3 * _RECLEN : 3 * _RECLEN + len(arr)] = arr
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(bytes(out))
    os.replace(tmp, path)
