"""End-to-end integrity of the export: the silent-corruption defense
(counterpart: psrsigsim_tpu/runtime/integrity.py, its export half).

Every sha256 the supervised export journals is computed on the HOST,
*after* the bytes left the device — so a bit flipped by device compute
(SDC: silent data corruption), in host memory between fetch and encode,
or by disk bit-rot after commit is journaled as "good" and served
forever.  This module closes those windows with three layers:

1. **Checksum lattice** — a cheap exact uint32 digest (positional
   multiply-xor-sum fold over the quantized int16 codes and the bitcast
   DAT_SCL/DAT_OFFS words) computed ON THE CARD over each chunk's packed
   buffer before it crosses the host link (the packed-digest kernel,
   :mod:`psrsigsim_torch.ops.digest`), then recomputed on the host from
   the fetched bytes where the exporter consumes them.  The device and
   host folds are the same modular uint32 arithmetic, so any disagreement
   is corruption in the fetch->consume window.
2. **Duplicate-execution audit** — a deterministic, fingerprint-seeded
   ``audit_frac`` of chunks (default 2%, ``PSS_INTEGRITY_AUDIT_FRAC``) is
   re-run at full chunk width and compared digest for digest.  The JAX
   package re-runs a freshly compiled instance of its program; the port
   launches its deterministic kernel a second time on the same inputs
   (psrsigsim_torch/DIVERGENCES.md P7).  A disagreement is the SDC case
   the lattice cannot see (the digest of wrong bytes matches the wrong
   bytes): :meth:`IntegrityChecker.heal_verified` then requires two
   independent re-executions to agree with each other AND with the host
   re-digest of the bytes being adopted; agreed bytes replace the chunk
   (byte-identical to a clean run — healing never re-draws), the event is
   journaled, and the sticky ``sdc_suspect`` flag is set.  A disagreement
   that SURVIVES re-execution is permanent (:class:`IntegrityError`,
   never retried).
3. **Self-healing scrub** — re-hash of committed export files against
   their journaled sha256 (:func:`scrub_export_dir`): corrupt files are
   quarantined aside so the next resume re-runs them.

Injection points (armed only by an explicit
:class:`~psrsigsim_torch.runtime.faults.FaultPlan`): ``device.sdc``
perturbs one chunk's device output (only the audit can catch it),
``host.corrupt`` flips a fetched buffer before encoding (the lattice
catches it), ``disk.bitrot`` flips a committed file's bytes (the scrub
catches it).

Everything here is OFF by default: with ``integrity=None`` and
``PSS_INTEGRITY`` unset, the digest kernel never runs and the export takes
exactly its unarmed path.  The module is host-only: it imports numpy, and
torch only inside :func:`device_packed_digest_rows` (the export's spawn
writers import this package and must never import torch).

The Monte-Carlo study's row digest (:func:`device_digest_rows`) and its
scrub (:func:`scrub_mc_dir`) are here too, and the dataset factory's
per-record digest of a chunk's field buffers
(:func:`device_fields_digest_rows`, its host twin
:func:`fields_digest_rows_host`) and corpus scrub
(:func:`scrub_dataset_dir`); the serving digests and scrubs of the JAX
package wait for that subsystem.
"""

from __future__ import annotations

import hashlib
import os
import threading

import numpy as np

from .journal import file_sha, load_chunk_journal, load_manifest
from .retry import RetryPolicy, call_with_retry

__all__ = [
    "IntegrityChecker", "IntegrityError", "resolve_integrity",
    "refuse_on_pod",
    "digest_rows", "digest_array", "device_digest_rows",
    "device_packed_digest_rows", "fields_digest_rows_host",
    "device_fields_digest_rows",
    "triple_digest_rows", "audit_selected", "DEFAULT_AUDIT_FRAC",
    "maybe_sdc", "maybe_host_corrupt", "maybe_bitrot",
    "DirScrubber", "scrub_export_dir", "scrub_mc_dir", "scrub_dataset_dir",
]

#: default duplicate-execution audit fraction once integrity is enabled
#: (``PSS_INTEGRITY_AUDIT_FRAC`` overrides; 0 disables auditing while
#: keeping the checksum lattice)
DEFAULT_AUDIT_FRAC = 0.02

# digest constants (Knuth/Murmur-style odd multipliers); the fold is
#   sum_i ((w_i ^ m_i) * GOLD + m_i)  mod 2^32,  m_i = (i+salt)*GOLD + OFF
# — positional (catches swapped words), exact (pure modular integer
# arithmetic, so host numpy and the card agree bit for bit), and one
# multiply-add per word
_GOLD = 0x9E3779B1
_OFF = 0x85EBCA77
_MASK = 0xFFFFFFFF

# component salts of a (data, scl, offs) quantized triple digest — the
# three streams fold with disjoint positional multipliers so a value
# migrating between components cannot cancel
_SALT_DATA, _SALT_SCL, _SALT_OFFS = 0, 1 << 20, 2 << 20


class IntegrityError(RuntimeError):
    """A corruption that survived its one verified re-execution.

    PERMANENT by classification: re-running cannot help (two independent
    executions already disagree with each other and with the original),
    so retry loops must fail fast instead of burning their backoff
    budget — :func:`~psrsigsim_torch.runtime.retry.call_with_retry`
    re-raises it immediately when the policy classifies it permanent.
    :attr:`evidence` carries the audit trail (producer, chunk start,
    the disagreeing digests) for the operator."""

    def __init__(self, message, evidence=None):
        self.evidence = dict(evidence or {})
        if self.evidence:
            message = f"{message} [evidence: {self.evidence}]"
        super().__init__(message)


# ---------------------------------------------------------------------------
# the digest fold — the host twin of the packed-digest kernel
# ---------------------------------------------------------------------------


def _host_words_u32(arr):
    """Elementwise uint32 words of a host array: float32 bitcast, 64-bit
    dtypes reinterpreted as word pairs, integers value-converted with
    C wrap semantics (int16 sign-extends) — each exactly what the device
    twin computes."""
    a = np.asarray(arr)
    if a.dtype == np.float32:
        return np.ascontiguousarray(a).view(np.uint32)
    if a.dtype.itemsize == 8:
        return np.ascontiguousarray(a).view(np.uint32)
    if a.dtype.kind in "iub":
        return a.astype(np.uint32)
    raise TypeError(f"undigestable dtype {a.dtype}")


_POSITIONS = {}  # (n, salt) -> the uint32 position multipliers m_i


def _positions(n, salt):
    """``m_i = (i + salt)·GOLD + OFF mod 2^32`` for ``i < n`` (cached: every
    observation of a chunk shares them)."""
    k = (int(n), int(salt) & _MASK)
    m = _POSITIONS.get(k)
    if m is None:
        m = (((np.arange(n, dtype=np.uint64) + np.uint64(k[1]))
              * np.uint64(_GOLD) + np.uint64(_OFF))
             & np.uint64(_MASK)).astype(np.uint32)
        if len(_POSITIONS) >= 8:
            _POSITIONS.clear()
        _POSITIONS[k] = m
    return m


def _fold_row(w, m, t, out, r):
    """``out[r]`` = the modular fold of one row's uint32 words ``w`` with
    position multipliers ``m`` (``t`` is scratch).  numpy's uint32 multiply
    and add wrap mod 2^32 exactly as the card's do."""
    np.bitwise_xor(w, m, out=t)
    np.multiply(t, np.uint32(_GOLD), out=t)
    np.add(t, m, out=t)
    out[r] = int(t.sum(dtype=np.uint64)) & _MASK


def digest_rows(arr, salt=0):
    """Per-row host digest of ``arr`` (leading axis = rows): ``(B,)``
    uint32, bit-identical to the JAX package's ``digest_rows`` and, for a
    packed chunk's split triple, to the card's
    :func:`device_packed_digest_rows`.  Words are formed one row at a
    time, so the host's peak memory is one row's words whatever the
    chunk's (the JAX package's twin turns the whole (rows, n) matrix into
    uint64 temporaries, gigabytes at a full-width chunk)."""
    a = np.asarray(arr)
    if a.ndim == 0:
        raise ValueError("digest_rows needs at least one axis")
    rows = a.shape[0]
    out = np.empty(rows, np.uint32)
    if rows == 0:
        return out
    n = _host_words_u32(a[:1]).size
    m = _positions(n, salt)
    t = np.empty(n, np.uint32)
    for r in range(rows):
        _fold_row(_host_words_u32(a[r]).reshape(-1), m, t, out, r)
    return out


def digest_array(arr, salt=0):
    """Whole-array host digest (one uint32 as a python int)."""
    a = np.asarray(arr)
    return int(digest_rows(a.reshape(1, -1), salt)[0])


def triple_digest_rows(data, scl, offs):
    """Per-observation host digest of a quantized ``(data, scl, offs)``
    triple: the three component folds (disjoint salts) summed mod 2^32.
    ``data`` must be NATIVE int16 (digest before any ``.view('>i2')`` —
    a byte-order view changes values, and the card digested the native
    values of the packed buffer)."""
    d = digest_rows(data, _SALT_DATA)
    s = digest_rows(np.ascontiguousarray(scl, np.float32), _SALT_SCL)
    o = digest_rows(np.ascontiguousarray(offs, np.float32), _SALT_OFFS)
    return ((d.astype(np.uint64) + s + o) & np.uint64(_MASK)).astype(
        np.uint32)


def device_digest_rows(x, salt=0):
    """Per-row digest of a tensor, computed where it lies (on the card, one
    handful of int64 torch ops over the already-resident rows, before any
    byte crosses the host link): ``(rows,)`` int64 holding the uint32
    digests, bit-equal to the host :func:`digest_rows` of the same values.
    Fetch it alongside the chunk."""
    from ..ops.digest import rows_digest

    return rows_digest(x, salt)


def device_packed_digest_rows(packed, nbin, count=None):
    """Per-observation digest of a packed chunk ``(B, nsub, C, nbin+4)``
    int16 on the card, by the packed-digest kernel
    (:func:`psrsigsim_torch.ops.digest.packed_digest`; its plain version
    for a CPU tensor): the data slice and the bitcast scl/offs tail words
    fold with the SAME salts as the host :func:`triple_digest_rows` of the
    split triple.  Returns ``(count,)`` int32 holding the uint32 digests,
    on the buffer's device (fetch it with the chunk)."""
    from ..ops.digest import packed_digest

    if packed.shape[-1] != nbin + 4:
        raise ValueError(f"packed rows hold {packed.shape[-1]} halves, not "
                         f"nbin+4 = {nbin + 4}")
    return packed_digest(packed, count)


# ---------------------------------------------------------------------------
# audit sampling
# ---------------------------------------------------------------------------


def fields_digest_rows_host(arrays):
    """Combined per-record host digest of a chunk's per-field arrays (the
    dataset chunk layout, each ``(rows, ...)``): field ``f`` folds with
    salt ``(f + 1) << 16``, the folds summed mod 2^32 — ``(rows,)``
    uint32, the JAX package's ``fields_digest_rows_host``."""
    total = np.zeros(np.asarray(arrays[0]).shape[0], np.uint64)
    for f, a in enumerate(arrays):
        total = (total + digest_rows(a, salt=(f + 1) << 16)) \
            & np.uint64(_MASK)
    return total.astype(np.uint32)


def device_fields_digest_rows(arrays):
    """:func:`fields_digest_rows_host` of tensors, computed where they lie
    (int64 torch ops, as :func:`device_digest_rows`; the JAX package's is
    an XLA fusion too): ``(rows,)`` int64 holding the uint32 digests."""
    from ..ops.digest import rows_digest

    total = None
    for f, a in enumerate(arrays):
        d = rows_digest(a, (f + 1) << 16)
        total = d if total is None else (total + d) & _MASK
    return total


def audit_selected(fingerprint, ident, frac):
    """Deterministic fingerprint-seeded chunk sampling: chunk ``ident``
    of the run fingerprinted ``fingerprint`` is audited iff the leading
    64 bits of ``sha256(fingerprint|ident)`` fall below ``frac`` — the
    same chunks audit on every resume of the same run (so a kill/resume
    cannot dodge its audits), different runs audit different chunks."""
    frac = float(frac)
    if frac <= 0.0:
        return False
    if frac >= 1.0:
        return True
    h = hashlib.sha256(f"{fingerprint}|{ident}".encode()).digest()
    return int.from_bytes(h[:8], "big") < int(frac * 2.0 ** 64)


# ---------------------------------------------------------------------------
# fault helpers (device.sdc / host.corrupt / disk.bitrot)
# ---------------------------------------------------------------------------


def _ident_matches(cfg, ident):
    after = cfg.get("after_start")
    return after is None or (ident is not None and int(after) == int(ident))


def maybe_sdc(plan, dev, token="", ident=None):
    """``device.sdc`` injection: perturb ONE element of the device buffer
    in place (+1 on the int16 code / +1.0 on a float word at the origin)
    and return it — the device "computed" wrong bytes, so every digest of
    this buffer attests the wrong bytes and only duplicate execution can
    notice.  Config: ``{"after_start": int}`` (chunk start) plus the usual
    ``match``/``times``."""
    if plan is None:
        return dev
    cfg = plan.config("device.sdc")
    if cfg is None or not _ident_matches(cfg, ident):
        return dev
    if not plan.fire("device.sdc", token=token):
        return dev
    bump = 1.0 if dev.dtype.is_floating_point else 1
    dev[(0,) * dev.dim()] += bump
    return dev


def maybe_host_corrupt(plan, arr, token="", ident=None):
    """``host.corrupt`` injection: flip one element of a FETCHED host
    buffer (the fetch->encode window the checksum lattice closes).
    Returns the buffer to use downstream — the same object when unarmed,
    a corrupted copy when the point fired."""
    if plan is None:
        return arr
    cfg = plan.config("host.corrupt")
    if cfg is None or not _ident_matches(cfg, ident):
        return arr
    if not plan.fire("host.corrupt", token=token):
        return arr
    a = np.array(arr)   # writable copy standing in for the flipped page
    origin = (0,) * a.ndim
    if a.dtype.kind == "f":
        # flip the mantissa LSB of the first word: unlike adding a
        # constant, a bit flip changes the pattern for EVERY value
        u = a.view(np.uint32 if a.dtype.itemsize == 4 else np.uint64)
        u[(0,) * u.ndim] ^= 1
    else:
        a[origin] = a[origin] ^ 1
    return a


def maybe_bitrot(plan, path, token=None, offset=None):
    """``disk.bitrot`` injection: XOR one byte of a COMMITTED file
    (after its sha256 was journaled), the decay the scrub layer exists
    to find.  Token defaults to the basename so ``match`` can target
    one file; ``offset`` defaults to the middle of the file.  Returns
    True when it fired."""
    if plan is None:
        return False
    cfg = plan.config("disk.bitrot")
    if cfg is None:
        return False
    if not plan.fire("disk.bitrot",
                     token=os.path.basename(path) if token is None
                     else token):
        return False
    size = os.path.getsize(path)
    if size == 0:
        return False
    pos = size // 2 if offset is None else min(int(offset), size - 1)
    with open(path, "rb+") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))
        f.flush()
        os.fsync(f.fileno())
    return True


# ---------------------------------------------------------------------------
# the checker: per-run integrity state
# ---------------------------------------------------------------------------


def _env_enabled():
    return os.environ.get("PSS_INTEGRITY", "").lower() in ("1", "on",
                                                           "true", "yes")


def _env_audit_frac():
    try:
        return float(os.environ.get("PSS_INTEGRITY_AUDIT_FRAC",
                                    DEFAULT_AUDIT_FRAC))
    except ValueError:
        return DEFAULT_AUDIT_FRAC


class IntegrityChecker:
    """One run's integrity configuration + counters.

    The export holds one checker per run and reports through it; its
    :meth:`stats` land in the manifest.  Thread-safe.

    Parameters
    ----------
    audit_frac : float
        Duplicate-execution audit fraction (0 disables the audit but
        keeps the checksum lattice).  Default:
        ``PSS_INTEGRITY_AUDIT_FRAC`` (2%).
    fingerprint : str
        Seed of the deterministic audit sampling — the run's own
        fingerprint digest, so resumes audit the same chunks.
    faults : FaultPlan, optional
        Arms ``device.sdc`` / ``host.corrupt`` / ``disk.bitrot``.
    """

    def __init__(self, audit_frac=None, fingerprint="", faults=None):
        self.audit_frac = (_env_audit_frac() if audit_frac is None
                           else float(audit_frac))
        if not 0.0 <= self.audit_frac <= 1.0:
            raise ValueError("audit_frac must be in [0, 1]")
        self.fingerprint = str(fingerprint)
        self.faults = faults
        self._lock = threading.Lock()
        self.checks = 0               # host-vs-device checksum compares
        self.checksum_mismatches = 0  # host.corrupt-window detections
        self.audits = 0               # duplicate executions run
        self.audit_mismatches = 0     # device-disagreement detections
        self.healed_chunks = 0        # chunks replaced by verified bytes
        self.permanent_failures = 0   # IntegrityError raised
        self.sdc_suspect = False      # sticky: device disagreed with its
        #                               own re-execution at least once

    # -- sampling / fault arms --------------------------------------------

    def audit_chunk(self, ident):
        return audit_selected(self.fingerprint, ident, self.audit_frac)

    def apply_sdc(self, dev, ident=None, token=None):
        return maybe_sdc(self.faults, dev,
                         token=f"start={ident}" if token is None else token,
                         ident=ident)

    def corrupt_host(self, arr, ident=None, token=None):
        """Apply the ``host.corrupt`` arm; returns the buffer to use
        downstream (a corrupted copy when the point fired)."""
        return maybe_host_corrupt(
            self.faults, arr,
            token=f"start={ident}" if token is None else token, ident=ident)

    # -- verdicts ----------------------------------------------------------

    def check_rows(self, device_digests, host_digests, ident=None,
                   producer=""):
        """Compare fetched device digests against the host recompute;
        returns the mismatching row indices (empty = the fetch->consume
        window was clean)."""
        # the card's int32 digests cast to their uint32 bits
        dev = np.asarray(device_digests, np.uint32).reshape(-1)
        host = np.asarray(host_digests, np.uint32).reshape(-1)
        n = min(dev.size, host.size)
        bad = np.nonzero(dev[:n] != host[:n])[0]
        with self._lock:
            self.checks += 1
            if bad.size:
                self.checksum_mismatches += 1
        return [int(j) for j in bad]

    def note_audit(self, mismatch_rows):
        with self._lock:
            self.audits += 1
            if mismatch_rows:
                self.audit_mismatches += 1
                self.sdc_suspect = True

    def note_healed(self):
        with self._lock:
            self.healed_chunks += 1

    def fail_permanent(self, message, evidence=None):
        with self._lock:
            self.permanent_failures += 1
            self.sdc_suspect = True
        raise IntegrityError(message, evidence)

    def verify_chunk(self, dig_dev, host, host_digest, reexec, *, producer,
                     ident, rows=None, evidence=None):
        """THE per-chunk verdict every producer runs on a fetched chunk.

        ``dig_dev`` holds the device's per-row digests of ``host`` (the
        fetched host arrays, after the producer's ``host.corrupt`` arm);
        ``host_digest(arrays)`` re-digests arrays on the host;
        ``reexec(audit)`` runs the chunk again (``audit`` True for the
        duplicate execution, False for the heal's independent second run)
        and returns ``(fetch, digests)``: its device digests on the host
        and a callable that fetches its host arrays, called only for the
        run whose arrays are adopted.  Only the first ``rows`` rows count
        (all when None; the rest pad the chunk), and ``ident`` keys the
        audit sample.

        1. the lattice: host re-digest against the device's claim;
        2. a sampled chunk with a clean lattice runs once more, and a
           duplicate that reproduces the claim lets the chunk stand;
        3. otherwise two executions that agree with each other and with
           their own host re-digest replace the chunk
           (:meth:`heal_verified`; one that cannot is permanent).

        Returns ``(arrays, digests, event)``: the arrays to adopt, the
        digests they are trusted under, and None or the healed event
        ``(kind, rows, lattice_rows)`` — ``kind`` ``"checksum"`` for a
        fetch-window corruption, ``"audit"`` for a device that disagreed
        with its re-execution; ``rows`` the chunk rows at fault; and
        ``lattice_rows`` those the lattice flagged.
        """
        dig_dev = np.asarray(dig_dev, np.uint32)
        bad = self.check_rows(dig_dev[:rows], host_digest(host)[:rows],
                              ident=ident, producer=producer)
        if not bad and not self.audit_chunk(ident):
            return host, dig_dev, None

        def _run(audit):
            fetch, dig = reexec(audit)
            return fetch, np.asarray(dig, np.uint32)

        first = None
        if not bad:
            first = _run(True)
            mism = [int(j) for j in
                    np.nonzero(first[1][:rows] != dig_dev[:rows])[0]]
            self.note_audit(mism)
            if not mism:
                return host, dig_dev, None

        def reexecute():
            a = first if first is not None else _run(True)
            b = _run(False)
            return a[0](), a[1], b[1]

        def verify(res):
            arrays, dig_a, dig_b = res
            return (np.array_equal(dig_a, dig_b)
                    and np.array_equal(host_digest(arrays), dig_a))

        arrays, dig_a, _ = self.heal_verified(
            reexecute, verify, producer=producer, ident=ident,
            evidence={"producer": producer, **(evidence or {}),
                      "lattice_rows": bad})
        sdc = [int(j) for j in np.nonzero(dig_a[:rows] != dig_dev[:rows])[0]]
        if sdc and bad:
            self.note_audit(sdc)   # the audit-only path counted its own
        return arrays, dig_a, ("audit" if sdc else "checksum", sdc or bad,
                               bad)

    def heal_verified(self, reexecute, verify, *, producer, ident,
                      evidence=None):
        """Run ``reexecute()`` and require ``verify(result) -> True`` —
        the heal contract: a fresh execution whose own device/host digests
        agree replaces the corrupt chunk; a verification that fails even
        on re-execution is PERMANENT and fails fast with the evidence
        attached (one transient re-execute is budgeted, an integrity
        mismatch that survives it never burns backoff)."""
        def _attempt():
            out = reexecute()
            if not verify(out):
                self.fail_permanent(
                    f"{producer}: re-executed chunk {ident} failed its own "
                    "digest verification", evidence)
            return out

        out = call_with_retry(
            _attempt,
            RetryPolicy(max_attempts=2, base_delay=0.0,
                        permanent_on=(IntegrityError,)))
        self.note_healed()
        return out

    # -- reporting ---------------------------------------------------------

    def stats(self):
        with self._lock:
            return {
                "audit_frac": self.audit_frac,
                "checks": self.checks,
                "checksum_mismatches": self.checksum_mismatches,
                "audits": self.audits,
                "audit_mismatches": self.audit_mismatches,
                "healed_chunks": self.healed_chunks,
                "permanent_failures": self.permanent_failures,
                "sdc_suspect": self.sdc_suspect,
            }

    def __repr__(self):
        return (f"IntegrityChecker(audit_frac={self.audit_frac}, "
                f"checks={self.checks}, audits={self.audits}, "
                f"sdc_suspect={self.sdc_suspect})")


def refuse_on_pod(armed, work, pod=None):
    """The integrity layer's audits and heals re-run a chunk on the
    detecting process alone, which would break a pod's host lockstep: an
    ``armed`` run on a pod (``pod``; by default whether this process is in
    one) refuses loudly instead of hanging."""
    if not armed:
        return
    if pod is None:
        from .dist import is_pod

        pod = is_pod()
    if pod:
        raise RuntimeError(
            "integrity checking is not supported on a pod yet "
            "(duplicate-execution audits break host lockstep); run "
            f"integrity-armed {work} single-host")


def resolve_integrity(integrity, fingerprint="", faults=None):
    """The one arming rule.

    ``integrity`` may be: None (consult ``PSS_INTEGRITY`` — unset means
    OFF, the zero-cost default), False (force off), True (on with env/
    default audit fraction), a float (on with that audit fraction), or
    an :class:`IntegrityChecker` (used as-is; an unset fingerprint or
    fault plan is stamped from the call site so the checker follows the
    run it guards).  Returns a checker or None."""
    if integrity is None:
        if not _env_enabled():
            return None
        integrity = True
    if integrity is False:
        return None
    if integrity is True:
        return IntegrityChecker(fingerprint=fingerprint, faults=faults)
    if isinstance(integrity, (int, float)) and not isinstance(
            integrity, bool):
        return IntegrityChecker(audit_frac=float(integrity),
                                fingerprint=fingerprint, faults=faults)
    if isinstance(integrity, IntegrityChecker):
        if not integrity.fingerprint:
            integrity.fingerprint = str(fingerprint)
        if integrity.faults is None:
            integrity.faults = faults
        return integrity
    raise TypeError(f"integrity must be None/bool/float/IntegrityChecker, "
                    f"got {integrity!r}")


# ---------------------------------------------------------------------------
# the scrub layer
# ---------------------------------------------------------------------------


class DirScrubber:
    """Incremental scrubber over a ``{basename: sha256}`` record (an
    export manifest's ``files`` map): :meth:`step` re-hashes a bounded
    number of files per call, rotating through the record forever.

    A mismatched file is QUARANTINED (renamed ``<name>.quarantine``) so
    even a plain existence-keyed resume re-runs it; a hash-verified
    resume would also catch it, but quarantine means the very next
    resume heals regardless of its verify mode."""

    def __init__(self, out_dir, hashes, quarantine=True):
        self.out_dir = str(out_dir)
        self.hashes = dict(hashes)
        self.quarantine = bool(quarantine)
        self._ring = sorted(self.hashes)
        self._pos = 0
        self.scrubbed = 0      # files re-hashed clean
        self.scrub_errors = 0  # mismatches found (and quarantined)
        self.bad = []          # basenames that failed

    def step(self, max_files=1):
        """Re-hash up to ``max_files`` committed files; returns the list
        of basenames found corrupt THIS step."""
        found = []
        for _ in range(int(max_files)):
            if not self._ring:
                return found
            name = self._ring[self._pos % len(self._ring)]
            self._pos += 1
            path = os.path.join(self.out_dir, name)
            try:
                ok = file_sha(path) == self.hashes[name]
            except OSError:
                continue   # missing: resume already treats it as undone
            if ok:
                self.scrubbed += 1
                continue
            self.scrub_errors += 1
            self.bad.append(name)
            found.append(name)
            if self.quarantine:
                try:
                    os.replace(path, path + ".quarantine")
                except OSError:
                    pass
        return found

    def run_all(self):
        """One full pass over the record; returns the summary dict."""
        self.step(max_files=len(self._ring))
        return {"scanned": self.scrubbed + self.scrub_errors,
                "scrubbed": self.scrubbed,
                "scrub_errors": self.scrub_errors,
                "bad": list(self.bad)}


def scrub_export_dir(out_dir, quarantine=True):
    """One full scrub pass over a supervised export's manifest record:
    re-hash every committed file against its journaled sha256 and
    quarantine mismatches aside (``*.quarantine``) so the next
    ``supervised_export(..., resume=True)`` re-runs exactly those
    observations — detection here, heal on resume, bytes identical to a
    never-rotted run."""
    man = load_manifest(out_dir) or {}
    return DirScrubber(out_dir, man.get("files", {}),
                       quarantine=quarantine).run_all()


def scrub_mc_dir(out_dir):
    """Scrub a study sweep dir: re-hash every journaled trial chunk's rows
    from ``trials.f32`` against the journal's sha256.  Returns the summary
    with ``bad`` = the corrupt chunks' starts; healing is
    ``study.run(resume=True)``, whose resume re-verifies the same hashes
    and recomputes exactly the failing chunks."""
    import json

    from ..mc import study as _study

    journal = os.path.join(out_dir, _study._JOURNAL_NAME)
    raw = os.path.join(out_dir, _study._TRIALS_RAW)
    done = load_chunk_journal(journal)
    with open(os.path.join(out_dir, _study._MANIFEST_NAME)) as f:
        n_metrics = len(json.load(f).get("metrics", ()))
    bad, ok = [], 0
    try:
        fd = os.open(raw, os.O_RDONLY)
    except FileNotFoundError:
        return {"scanned": 0, "scrubbed": 0, "scrub_errors": 0, "bad": []}
    try:
        for start, rec in sorted(done.items()):
            nbytes = int(rec["count"]) * n_metrics * 4
            blob = os.pread(fd, nbytes, start * n_metrics * 4)
            if (len(blob) == nbytes
                    and hashlib.sha256(blob).hexdigest() == rec.get("sha")):
                ok += 1
            else:
                bad.append(int(start))
    finally:
        os.close(fd)
    return {"scanned": ok + len(bad), "scrubbed": ok,
            "scrub_errors": len(bad), "bad": bad}


def scrub_dataset_dir(out_dir):
    """Scrub a dataset corpus dir: re-hash every journaled record chunk's
    bytes out of the shards against the journal's sha256.  Returns the
    summary with ``bad`` = the corrupt chunks' starts; healing is
    ``DatasetFactory.run(resume=True)``, whose resume re-hashes the
    journaled chunks from the shard bytes and recomputes any that fail."""
    from ..datasets import factory as _factory
    from ..datasets.writer import DatasetReader

    done = load_chunk_journal(os.path.join(out_dir, _factory._JOURNAL_NAME))
    if not os.path.exists(os.path.join(out_dir, _factory._MANIFEST_NAME)):
        raise FileNotFoundError(f"{out_dir} holds no dataset manifest")
    bad, ok = [], 0
    with DatasetReader(out_dir) as reader:
        for start, rec in sorted(done.items()):
            h = hashlib.sha256()
            complete = True
            for i in range(start, start + int(rec["count"])):
                buf = reader.record_bytes(i)
                if len(buf) != reader.stride:
                    complete = False
                    break
                h.update(buf)
            if complete and h.hexdigest() == rec.get("sha"):
                ok += 1
            else:
                bad.append(int(start))
    return {"scanned": ok + len(bad), "scrubbed": ok,
            "scrub_errors": len(bad), "bad": bad}
