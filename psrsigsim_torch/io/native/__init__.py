"""Native (C++) fast paths for host-side IO encode.

The reference reaches native code for FITS through cfitsio
(reference: requirements.txt:2, io/psrfits.py:7); this package is the
build's equivalent: a small C++ library compiled on demand with g++ and
loaded via ctypes (no pybind11 required).  ``encode.cpp`` is the JAX
package's source, unchanged; the library is built at first use into the
checkout's ``build/`` (beside this file when the package is installed
without a checkout), as ``psrsigsim_torch/ops/_build.py`` builds the
CUDA kernels.  Everything here is optional — callers fall back to the
pure-Python implementations when the toolchain is unavailable, and tests
assert byte parity between the two paths.  The bulk exporter's quantized
path never encodes floats; it only primes the cast-parity probe.

Public surface:
    available()               -> bool (library compiled + loaded)
    encode_available()        -> bool (available and int16-cast parity with
                                 numpy verified on this host, incl. NaN and
                                 out-of-range values)
    encode_subints(data, nsub, nbin, npol=1) -> (nsub, npol, nchan, nbin) '>i2'
    format_pdv_block(row, isub, ichan)       -> bytes (pdv text lines)
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = ["available", "encode_available", "encode_gate_check",
           "encode_preferred", "encode_speed_probe", "encode_subints",
           "format_pdv_block", "median3", "probe_state",
           "seed_probe_state"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "encode.cpp")

# reentrant: encode_available() probes encode_subints() -> _load() while
# holding the lock
_lock = threading.RLock()
_lib = None
_tried = False


def _src_tag():
    """Content hash of encode.cpp: the library filename embeds it, so a
    changed source (package upgrade) can never silently load a stale
    binary — no mtime heuristics (wheel-archived mtimes lie)."""
    import hashlib

    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:12]


def _build_dir():
    """The checkout's ``build/`` (ignored by git); an installed package,
    with no checkout around it, builds beside its own sources instead."""
    pkg = os.path.dirname(os.path.dirname(_HERE))
    root = os.path.dirname(pkg)
    if os.path.exists(os.path.join(root, "pyproject.toml")):
        return os.path.join(root, "build")
    return os.path.join(pkg, "build")


def _so_candidates(tag):
    """Where the library is built and loaded: one place, inside the
    checkout (or the installed package).  Writability is discovered by
    ATTEMPTING the build, not os.access — root on a read-only filesystem
    passes access(2) and then fails at write time."""
    yield os.path.join(_build_dir(), f"io_native-{tag}.so")


def _build(so_path):
    # compile to a temp name and rename: the publish is atomic, so a
    # concurrent process never dlopens a partially written library and a
    # rebuild never truncates an .so another process has mmapped
    os.makedirs(os.path.dirname(so_path), exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    """Compile (if stale) and load the shared library; None on failure."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("PSS_NO_NATIVE"):
            return None
        try:
            tag = _src_tag()
        except OSError:
            return None
        for so in _so_candidates(tag):
            try:
                if not os.path.exists(so):
                    _build(so)
                lib = ctypes.CDLL(so)
                if lib.pss_abi_version() != 1:
                    continue
                lib.pss_encode_subints_i2be.argtypes = [
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                ]
                lib.pss_encode_subints_i2be.restype = None
                lib.pss_format_pdv_block.argtypes = [
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                ]
                lib.pss_format_pdv_block.restype = ctypes.c_int64
                _lib = lib
                break
            except Exception:
                continue
        return _lib


def available():
    """True when the native library compiled and loaded on this host."""
    return _load() is not None


_cast_ok = None


def encode_available():
    """True when the native int16 encode is byte-identical to numpy's
    float32 -> '>i2' cast on this host.  Out-of-range and NaN conversion is
    ISA-dependent (x86 cvttss2si vs ARM saturating fcvtzs), so parity is
    probed at load time rather than assumed.  The probe runs under the
    loader lock so concurrent first calls compute it once (benign race
    otherwise, but consistent with ``_load``'s locking)."""
    global _cast_ok
    if not available():
        return False
    with _lock:
        if _cast_ok is None:
            probe = np.array(
                [[3e9, -3e9, np.nan, 2.2e9, -2.2e9, 65000.0, -65000.0,
                  1.9, -1.9, 200.7, -200.7, 0.0]],
                dtype=np.float32,
            )
            with np.errstate(invalid="ignore"):
                expect = probe.astype(">i2")
            got = encode_subints(probe, 1, probe.shape[1])[0, 0]
            _cast_ok = bool(np.array_equal(got, expect))
    return _cast_ok


_speed_ok = {}  # pow2 size bucket -> bool (native measured faster)


def median3(fn):
    """Warm once, then median of 3 timed runs — the measurement rule
    shared by the load-time encode speed gate and the bench report (so
    the two can never disagree on policy)."""
    import time as _time

    ts = []
    fn()  # warm caches/branch predictors
    for _ in range(3):
        t0 = _time.perf_counter()
        fn()
        ts.append(_time.perf_counter() - t0)
    ts.sort()
    return ts[1]


def encode_preferred(n_samples=None):
    """True when the native subint encode should actually be USED for a
    payload of ``n_samples`` float32 values: it is available,
    byte-identical (:func:`encode_available`), and MEASURED faster than
    the numpy cast on this host AT THAT SIZE.

    A compile-success-only gate once left the native path running 0.68x
    the numpy path on one host (the JAX package's BENCH_r03.json
    io_encode) — so every export took the slow path on purpose.  The
    winner is also SIZE-dependent on some hosts (numpy's cast wins small cache-resident blocks, the native
    single pass wins large ones), so the probe runs once per pow2 size
    bucket at the caller's payload size (clamped to [1 MB, 128 MB]; a
    few ms per side, median of 3).  ``PSS_NO_NATIVE=1`` still disables
    native outright.
    """
    if not encode_available():
        return False
    n = 1 << 21 if n_samples is None else int(n_samples)
    n = min(max(n, 1 << 18), 1 << 25)
    bucket = (n - 1).bit_length()  # exact pow2 payloads probe at size n
    with _lock:
        if bucket not in _speed_ok:
            rng = np.random.default_rng(7)
            nbin = 2048
            nsub = max(1, min(8, (1 << bucket) // (256 * nbin)))
            nchan = max(1, (1 << bucket) // (nsub * nbin))
            data = rng.normal(0, 50, (nchan, nsub * nbin)).astype(np.float32)

            def _numpy():
                # mirror the ACTUAL pure-Python fallback in PSRFITS.save
                # (io/psrfits.py) line for line — full-payload '>i2' cast
                # into a float64 scratch relayout.  An earlier idealized
                # baseline (preallocated '>i2' + direct
                # per-subint casts) out-running the code exports really
                # fall back to: the probe said "numpy wins" while the
                # measured real fallback lost 4.2x, so the compiled
                # encoder sat unused.  The gate's job is to pick the
                # faster of the two paths THAT EXIST, not to race an
                # implementation nobody runs.
                sim_sig = data.astype(">i2")
                out = np.zeros((nsub, 1, nchan, nbin))
                for ii in range(nsub):
                    out[ii, 0, :, :] = sim_sig[:, ii * nbin:(ii + 1) * nbin]
                return out

            with np.errstate(invalid="ignore"):
                t_nat = median3(lambda: encode_subints(data, nsub, nbin))
                t_np = median3(_numpy)
            # require a real margin: a photo-finish should keep the
            # simpler numpy path
            _speed_ok[bucket] = bool(t_nat < 0.9 * t_np)
    return _speed_ok[bucket]


def encode_gate_check(measured_speedup, selected, threshold=2.0):
    """Bench regression gate: a clearly-winning native encode MUST be
    selected.

    The JAX package's BENCH_r05.json measured the compiled encoder 4.17x
    faster than the real Python fallback while :func:`encode_preferred` still said "numpy
    wins" (its probe raced an idealized baseline nobody runs) — so every
    export silently took the slow path.  The probe was fixed since;
    this gate pins the fix: whenever the bench's
    independently measured speedup exceeds ``threshold`` (default 2x —
    far beyond the probe's own 0.9 photo-finish margin, so a borderline
    host can never flap it) and the probe still left native unselected,
    raise instead of publishing the contradiction as a flag in JSON.

    Returns True when consistent (``bench.py time_io_encode`` records it
    as ``encode_gate_ok``); raises RuntimeError on the regression.
    """
    if float(measured_speedup) > float(threshold) and not selected:
        raise RuntimeError(
            f"native-encode selection regressed: measured speedup "
            f"{float(measured_speedup):.2f}x exceeds {float(threshold):.1f}x "
            "but encode_preferred() did not select the native path — the "
            "speed probe's baseline has drifted from the real fallback "
            "again (see io/native encode_preferred)")
    return True


def encode_speed_probe():
    """The cached size-bucket decisions of :func:`encode_preferred`
    (empty when not probed yet) — surfaced for the bench report."""
    return dict(_speed_ok)


def probe_state():
    """Picklable snapshot of this process's probe verdicts (cast parity +
    per-size speed decisions).  The bulk exporter ships it to spawn
    writer workers inside the pickled writer state, so the pool inherits
    the parent's MEASURED decisions instead of each worker re-paying the
    probe (a few ms per size bucket plus a possible .so build) — or,
    before this existed, never enabling the compiled encoder at all."""
    with _lock:
        return {"cast_ok": _cast_ok, "speed_ok": dict(_speed_ok)}


def seed_probe_state(state):
    """Adopt another process's :func:`probe_state` (spawn-worker init).

    Local measurements win: only UNSET verdicts are seeded, so a worker
    that already probed (or a host whose behavior differs) keeps its own
    answers.  ``None``/empty state is a no-op."""
    global _cast_ok
    if not state:
        return
    with _lock:
        if _cast_ok is None and state.get("cast_ok") is not None:
            _cast_ok = bool(state["cast_ok"])
        for bucket, ok in (state.get("speed_ok") or {}).items():
            _speed_ok.setdefault(int(bucket), bool(ok))


def encode_subints(data, nsub, nbin, npol=1):
    """float32 (Nchan, nsamp) -> big-endian int16 (nsub, npol, Nchan, nbin).

    Matches ``data[:, :nsub*nbin].astype('>i2')`` re-laid per subint
    (the hot encode of PSRFITS.save; reference: io/psrfits.py:352-361).
    Only npol=1 payloads are generated (AA+BB total intensity).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    if npol != 1:
        raise NotImplementedError("native encode supports npol=1")
    arr = np.ascontiguousarray(np.asarray(data), dtype=np.float32)
    nchan, nsamp = arr.shape
    if nsub * nbin > nsamp:
        raise ValueError(f"need {nsub * nbin} samples/chan, have {nsamp}")
    out = np.empty((nsub, npol, nchan, nbin), dtype=">i2")
    lib.pss_encode_subints_i2be(
        arr.ctypes.data, nchan, nsub, nbin, nsamp, out.ctypes.data
    )
    return out


def format_pdv_block(row, isub, ichan):
    """pdv text lines ``"isub ichan ibin value \\n"`` for one channel row,
    byte-identical to the Python fallback in io/txtfile.py."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    arr = np.ascontiguousarray(np.asarray(row), dtype=np.float32)
    nbin = arr.shape[0]
    cap = 96 * max(nbin, 1)
    buf = ctypes.create_string_buffer(cap)
    n = lib.pss_format_pdv_block(arr.ctypes.data, nbin, isub, ichan, buf, cap)
    if n < 0:
        raise RuntimeError("pdv format buffer overflow")
    return buf.raw[:n]
