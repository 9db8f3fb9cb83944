"""Bulk ensemble -> PSRFITS export: the 10k-observation exit path
(counterpart: psrsigsim_tpu/io/export.py).

Streams a Monte-Carlo ensemble through the device-side int16 quantizer
(:meth:`FoldEnsemble.iter_chunks` with ``quantized=True`` — on the card
the fused fold → quantize → pack kernel, quarter-size bytes over the
host link, real DAT_SCL/DAT_OFFS columns) into PSRFITS files — one per
observation, or ``obs_per_file`` observations packed as consecutive
SUBINT rows of each file (the multi-row subint-table shape real
PUPPI/GUPPI archives use, which amortizes the per-file header/assembly
cost that bounds one-obs-per-file exports) — with user-visible progress
and resume.  The reference's save path handles one in-memory signal at a
time (reference: io/psrfits.py:305-424, simulate/simulate.py:328-377).

The export is a bounded-depth streaming pipeline (``pipeline_depth``):
the device computes chunk N+1 (``prefetch`` dispatch-ahead in
:meth:`FoldEnsemble.iter_chunks`) while a dedicated fetch thread copies
chunk N to pinned host memory on its own CUDA stream, as ONE packed
buffer (data+scales+offsets), and chunk N-1's files are encoded/written
— so the device, the link and the disk are all busy at once, with
bounded queues giving backpressure and keeping the serial write order.
File writing itself parallelizes across ``writers`` processes (spawn
workers fed through shared memory, one memcpy per chunk) — PSRFITS
assembly is Python/GIL-bound per file, so on multi-core hosts the writer
pool keeps the exit path off the critical path.  ``writers=1`` writes
in-process.  Per-stage telemetry (dispatch/fetch/encode/write, queue
depths, bytes) accumulates into the export manifest's ``pipeline`` key.

Resume correctness: chunk keys derive from GLOBAL observation indices,
so re-running the same export skips finished files and produces
byte-identical data for the rest — wherever the previous run died.  A
manifest records the run's parameters (seed, n_obs, per-obs DM digest,
template id); resuming against an out_dir whose manifest does not match
raises instead of silently mixing two different ensembles' files.

Under a :class:`~psrsigsim_torch.runtime.RunSupervisor` (most callers use
:func:`~psrsigsim_torch.runtime.supervised_export`) every committed file's
sha256 lands in an fsync'd journal, ``resume="verify"`` re-hashes existing
files against it, non-finite observations are quarantined and re-run once
with a salted key, and ``integrity=`` arms the checksum lattice and the
duplicate-execution audit (:mod:`psrsigsim_torch.runtime.integrity`).

Given the same quantized chunks the files are byte-identical to the JAX
package's (tests/test_torch_export.py).  A scenario ensemble
(``FoldEnsemble(scenario=[...])``) exports with ``scenario_params=``;
supervised, its RFI ground truth is journaled per observation.  On a pod
(:mod:`psrsigsim_torch.runtime.dist`) the leader runs the supervised export
and owns every file, journal and manifest, while each follower drives the
same chunk loop through :func:`pod_export_follower`.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle

import numpy as np

from ..runtime.faults import crash_process, should_fire
from ..runtime.journal import (EXPORT_MANIFEST_NAME, file_sha, load_manifest,
                               write_manifest)
from ..runtime.retry import RetriesExhausted, RetryPolicy, call_with_retry
from ..utils.quantity import make_quant
from .fits import FitsFile
from .psrfits import PSRFITS

__all__ = ["export_ensemble_psrfits", "ExportManifestError",
           "pod_export_follower"]

# operator-facing hints for manifest fingerprint fields: a mismatch on a
# content hash usually means a stale out_dir from an older run; a mismatch
# on a scalar usually means a config typo in THIS invocation
_FINGERPRINT_HINTS = {
    "n_obs": "ensemble size differs (config typo, or out_dir from a "
             "differently sized run)",
    "seed": "RNG seed differs — same out_dir, different ensemble",
    "dms_sha256": "per-observation DM array content differs",
    "noise_norms_sha256": "per-observation noise-norm array content differs",
    "template_sha256": "PSRFITS template file CONTENT differs (swapped or "
                       "edited template)",
    "parfile": "par file name differs",
    "MJD_start": "start epoch differs",
    "ref_MJD": "polyco reference epoch differs",
    "obs_per_file": "file packing differs — files would interleave "
                    "incompatibly",
    "scenario": "scenario-effect stack differs — same out_dir, different "
                "physics",
    "scenario_params_sha256": "scenario parameter content differs",
}


class ExportManifestError(RuntimeError):
    """resume=True against an out_dir written with different parameters.

    Carries the exact disagreement so operators can tell a stale out_dir
    from a config typo without diffing JSON by hand: :attr:`mismatches`
    maps each differing fingerprint field to ``(found_in_out_dir,
    expected_by_this_run)``; the message renders one line per field with
    the field-specific hint from ``_FINGERPRINT_HINTS``.
    """

    def __init__(self, out_dir, mismatches):
        self.out_dir = out_dir
        self.mismatches = dict(mismatches)
        lines = []
        for field in sorted(self.mismatches):
            found, expected = self.mismatches[field]
            hint = _FINGERPRINT_HINTS.get(field, "parameter differs")
            lines.append(f"  - {field}: out_dir has {found!r}, this run "
                         f"has {expected!r}  [{hint}]")
        super().__init__(
            f"out_dir {out_dir} holds an export with different parameters; "
            "resuming would silently mix two ensembles.  Differing "
            "fingerprint fields:\n" + "\n".join(lines) +
            "\nUse a fresh out_dir, or resume=False to overwrite.")


# ---------------------------------------------------------------------------
# multiprocess writer pool (spawn + shared memory)
# ---------------------------------------------------------------------------

_worker_state = None  # per-process: dict set by _writer_init


def _writer_init(shm_name, size):
    """Spawn-worker initializer: unpickle the shared write context once,
    out of the shared-memory block ``shm_name`` (its first ``size``
    bytes; see :class:`_WriterPool` for why it does not ride in the
    initializer's arguments).

    Spawn workers start with fresh module state: an ephemeris the parent
    activated via ``ephem.set_ephemeris(path)`` would silently NOT apply
    to worker-written files — only the ``PSS_EPHEM`` env var survives a
    spawn — so the parent's active source rides along in the pickled
    state.  The parent's measured native-encode probe verdicts ride along
    the same way (``native_probe``), so a worker neither re-pays the
    per-size speed probe nor leaves a compiled encoder the parent proved
    faster unused.  The state holds no tensor, and a worker imports
    neither torch nor anything that touches the card."""
    from multiprocessing import shared_memory

    global _worker_state
    shm = shared_memory.SharedMemory(name=shm_name)
    try:
        _worker_state = pickle.loads(shm.buf[:size])
    finally:
        shm.close()
    src = _worker_state.get("ephemeris_source")
    if src is not None:
        from . import ephem

        ephem.set_ephemeris(src)
    from . import native

    native.seed_probe_state(_worker_state.get("native_probe"))


def _attach_chunk(shm_name, meta, faults=None):
    """Reconstruct the (data, scl, offs) views from a shared-memory block."""
    from multiprocessing import shared_memory

    if should_fire(faults, "shm.attach", shm_name):
        raise OSError(f"injected shm-attach failure for {shm_name}")
    shm = shared_memory.SharedMemory(name=shm_name)
    arrays = []
    off = 0
    for shape, dtype in meta:
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        arrays.append(np.frombuffer(shm.buf, dtype=dtype, count=int(np.prod(shape)),
                                    offset=off).reshape(shape))
        off += n
    return shm, arrays


def _write_obs_full(state, path, triple, dm):
    """Write ONE output file (one observation, or ``obs_per_file``
    observations packed as consecutive SUBINT rows) through the full
    assembly pipeline; atomic via .tmp + rename.

    The signal shell's subint geometry is resized to the triple: a packed
    group of g observations IS a g-times-longer observation — same
    subintegration cadence, OFFS_SUB continuing across the file, polyco
    segments spanning the full duration (PSRFITS.save already fits one
    segment per segLength minutes)."""
    import time as _time

    timers = state.get("timers")
    t0 = _time.perf_counter()
    sig = state["sig"]
    if dm is not None:
        sig._dm = make_quant(float(dm), "pc/cm^3")
    nsub_rows = int(np.asarray(triple[0]).shape[0])
    if nsub_rows != sig.nsub:
        nbin = int(sig.nsamp // sig.nsub)   # invariant under resizing
        sig._nsub = nsub_rows
        sig._nsamp = nsub_rows * nbin
        sig._tobs = make_quant(
            nsub_rows * float(sig.sublen.to("s").value), "s")
    tmp = path + ".tmp"
    pfit = PSRFITS(path=tmp, template=state["template"], obs_mode="PSR")
    pfit.get_signal_params(signal=sig)
    pfit.save(sig, state["pulsar"], parfile=state["parfile"],
              MJD_start=state["MJD_start"], ref_MJD=state["ref_MJD"],
              quantized=triple, verbose=False)
    os.replace(tmp, path)
    if timers is not None:
        # the rare full-assembly writes (prototype priming, per-obs DMs)
        # count wholly as "write": their cost is dominated by FITS
        # assembly + the write itself, and splitting them would not
        # change which stage the telemetry names as the bottleneck
        timers.add("write", _time.perf_counter() - t0)


def _stream_chunk_bytes():
    """Bounded buffer size of the streamed group writes (bytes).  Packed
    groups are tens of MB per file; feeding the kernel bounded slices
    instead of one whole-file burst keeps the dirty-page window per file
    small (a single multi-MB ``writev`` can stall on writeback
    throttling mid-call) while staying gathered enough that the syscall
    count is negligible.  ``PSS_EXPORT_STREAM_MB`` overrides (floor
    64 KiB)."""
    try:
        mb = float(os.environ.get("PSS_EXPORT_STREAM_MB", "8"))
    except ValueError:
        mb = 8.0
    return max(1 << 16, int(mb * (1 << 20)))


def _iov_batches(bufs, chunk_bytes):
    """Slice a buffer sequence into bounded ``writev`` batches: each
    yielded batch is a list of memoryviews totaling at most
    ``chunk_bytes`` (the last one smaller).  Zero-copy — every view
    aliases the caller's buffers."""
    batch, size = [], 0
    for b in bufs:
        mv = memoryview(b)
        if mv.ndim != 1 or mv.itemsize != 1:
            mv = mv.cast("B")
        off = 0
        while off < len(mv):
            take = min(len(mv) - off, chunk_bytes - size)
            batch.append(mv[off:off + take])
            size += take
            off += take
            if size >= chunk_bytes:
                yield batch
                batch, size = [], 0
    if batch:
        yield batch


class _FastObsWriter:
    """Byte-prototype bulk writer for quantized PSR exports.

    Every file of a bulk export shares its epochs, polycos, par file, and
    all header/table structure; only the SUBINT table's DAT_SCL /
    DAT_OFFS / DATA columns carry the observation — and, for
    per-observation-DM exports, the handful of DM header/table fields.
    So: the FIRST file of each (geometry, DM) is written by the full
    :meth:`PSRFITS.save` assembly, read back, and kept as a prototype
    whose three columns are refilled per file — a handful of vectorized
    copies plus bounded gathered writes instead of ~8k python calls of
    FITS assembly (the measured bulk-export host-write bound).
    Byte-for-byte identical to the full path (tests/test_torch_export.py).

    Prototypes are keyed by ``(payload shape, DM)``: a DM change patches
    CHAN_DM/DM header cards and the HISTORY row, so each distinct DM
    needs its own prototype — which makes the per-pulsar grouped packed
    export (one DM per file, many files per DM) pay full assembly once
    per pulsar instead of once per file.  The cache is LRU-bounded
    (``proto_cache`` in the writer state, default 8): packed prototypes
    hold a whole file's record array, and the grouped exporter visits
    DMs in runs, so a small cache hits essentially always."""

    def __init__(self, state):
        from collections import OrderedDict

        self._state = state
        # LRU keyed by ((nsub_rows, nchan, nbin), dm): packed exports
        # end with one short final group whose geometry differs from the
        # full groups', and each (geometry, DM) needs its own prototype
        self._protos = OrderedDict()
        self._max_protos = max(1, int(state.get("proto_cache") or 8))

    def write(self, path, triple, dm):
        """Write one file; returns its sha256 when the state records
        hashes AND the fast path had the payload in memory (None
        otherwise — the caller falls back to hashing the file)."""
        import time as _time

        shape = tuple(np.asarray(triple[0]).shape)
        pkey = (shape, None if dm is None else float(dm))
        proto = self._protos.get(pkey)
        if proto is None:
            _write_obs_full(self._state, path, triple, dm)
            self._protos[pkey] = self._init_proto(path)
            while len(self._protos) > self._max_protos:
                self._protos.popitem(last=False)
            return None
        self._protos.move_to_end(pkey)
        timers = self._state.get("timers")
        t0 = _time.perf_counter()
        pre, sub, post, pad = proto
        q_data, q_scl, q_offs = (np.asarray(a) for a in triple)
        arr = sub.data
        nsub, npol, nchan, nbin = arr["DATA"].shape
        # same shape contract PSRFITS.save enforces (psrfits.py) — a
        # wrong-shaped triple must raise, never broadcast silently
        if q_data.shape != (nsub, nchan, nbin):
            raise ValueError(
                f"quantized data shape {q_data.shape} != "
                f"{(nsub, nchan, nbin)}")
        if q_scl.shape != (nsub, nchan) or q_offs.shape != (nsub, nchan):
            raise ValueError(
                f"quantized scl/offs shapes {q_scl.shape}/{q_offs.shape} "
                f"!= {(nsub, nchan)}")
        # broadcast across pols exactly as PSRFITS.save's row assignment
        # does (numpy converts to the on-disk '>i2' in place); npol==1
        # (every generated payload) skips the tile copies outright
        arr["DATA"][:] = q_data[:, None, :, :]
        if npol == 1:
            arr["DAT_SCL"] = q_scl
            arr["DAT_OFFS"] = q_offs
        else:
            arr["DAT_SCL"] = np.tile(q_scl, (1, npol))
            arr["DAT_OFFS"] = np.tile(q_offs, (1, npol))
        tmp = path + ".tmp"
        bufs = [pre, arr.view(np.uint8).reshape(-1), pad, post]
        total = sum(len(b) for b in bufs)
        if timers is not None:
            timers.add("encode", _time.perf_counter() - t0)
            t0 = _time.perf_counter()
        if should_fire(self._state.get("faults"), "file.partial", path):
            # model a power-cut/SIGKILL mid-write: half the payload lands
            # in the temp file, then the writing process dies without
            # Python teardown — the .tmp must never be mistaken for a
            # finished file by resume (finished files are renamed)
            with open(tmp, "wb") as f:
                blob = b"".join(bufs)
                f.write(blob[: len(blob) // 2])
                f.flush()
                os.fsync(f.fileno())
            crash_process()
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            # streamed gathered writes: bounded memoryview batches over
            # the same buffers (the arrays' raw bytes ARE the on-disk
            # big-endian FITS payload already), so a one-obs file is
            # still a single writev while a packed group streams in
            # bounded slices instead of one whole-file burst.  A short
            # write (disk full, RLIMIT_FSIZE) must NOT reach the rename —
            # resume treats existing files as complete.
            written = 0
            for batch in _iov_batches(bufs, _stream_chunk_bytes()):
                n = os.writev(fd, batch)
                want = sum(len(b) for b in batch)
                written += n
                if n != want:
                    raise IOError(
                        f"short write to {tmp}: {written}/{total} bytes")
            if written != total:
                raise IOError(
                    f"short write to {tmp}: {written}/{total} bytes")
        except BaseException:
            os.close(fd)
            os.unlink(tmp)
            raise
        os.close(fd)
        os.replace(tmp, path)
        sha = None
        if self._state.get("hash_files"):
            # the bufs ARE the file bytes just written: hash them in
            # memory instead of re-reading a multi-GB run back from disk
            h = hashlib.sha256()
            for b in bufs:
                h.update(b)
            sha = h.hexdigest()
        if timers is not None:
            timers.add("write", _time.perf_counter() - t0)
        return sha

    def _init_proto(self, path):
        from .fits import BLOCK

        f = FitsFile.read(path)
        i_sub = next(i for i, h in enumerate(f.hdus) if h.name == "SUBINT")
        sub = f.hdus[i_sub]
        if sub.data["DATA"].ndim != 4 or sub.data["DATA"].shape[1] < 1:
            raise ValueError("unexpected SUBINT DATA layout for fast writes")

        def _hdu_bytes(h):
            out = [h.header.serialize()]
            if h.data is not None:
                payload = np.ascontiguousarray(h.data).tobytes()
                out.append(payload)
                out.append(b"\x00" * ((-len(payload)) % BLOCK))
            return b"".join(out)

        pre = b"".join(_hdu_bytes(h) for h in f.hdus[:i_sub])
        pre += sub.header.serialize()
        post = b"".join(_hdu_bytes(h) for h in f.hdus[i_sub + 1:])
        pad = b"\x00" * ((-sub.data.nbytes) % BLOCK)
        return (pre, sub, post, pad)


def _write_obs(state, path, triple, dm):
    """Write ONE observation (serial and worker paths): fast prototype
    writer once primed, full pipeline otherwise.  Returns the file's
    sha256 when the run records hashes (supervised exports), else None —
    computed from the in-memory payload on the fast path, read back from
    disk only for the rare full-pipeline writes."""
    writer = state.get("_fast_writer")
    if writer is None:
        writer = state["_fast_writer"] = _FastObsWriter(state)
    sha = writer.write(path, triple, dm)
    if state.get("hash_files"):
        return sha if sha is not None else file_sha(path)
    return None


def _serial_write_jobs(state, arrays, jobs):
    """In-process write of a job batch straight from host arrays (the
    degraded/no-pool path).  Returns ``[(path, sha_or_None), ...]``."""
    data, scl, offs = arrays
    out = []
    for j, path, dm in jobs:
        sha = _write_obs(state, path, (data[j], scl[j], offs[j]), dm)
        out.append((path, sha))
    return out


def _serial_write_from_shm(state, shm_name, meta, jobs):
    """In-process write of a job batch out of a shared-memory chunk — how
    a degraded pool finishes work its dead workers left behind."""
    shm, arrays = _attach_chunk(shm_name, meta)
    try:
        return _serial_write_jobs(state, arrays, jobs)
    finally:
        del arrays
        shm.close()


def _probe():
    """Startup canary: proves spawn workers can come up (spawn re-imports
    ``__main__``, which fails for stdin/REPL scripts) before any chunk is
    committed to the pool."""
    return os.getpid()


def _worker_write(shm_name, meta, jobs):
    """Write a batch of observations out of one shared-memory chunk.
    ``jobs`` is a list of (local_index, path, dm_or_None); returns
    ``[(path, sha_or_None), ...]`` so the parent can journal hashes."""
    faults = _worker_state.get("faults")
    shm, (data, scl, offs) = _attach_chunk(shm_name, meta, faults=faults)
    out = []
    try:
        for j, path, dm in jobs:
            if should_fire(faults, "writer.crash", path):
                # the fault being modeled is an OOM-killed / preempted
                # writer process: die hard, mid-batch, no cleanup
                crash_process()
            sha = _write_obs(_worker_state, path,
                             (data[j], scl[j], offs[j]), dm)
            out.append((path, sha))
    finally:
        del data, scl, offs
        shm.close()
    return out


def _release_segment(shm):
    """Close and unlink a shared-memory block (already gone is fine)."""
    try:
        shm.close()
    finally:
        try:
            shm.unlink()
        except FileNotFoundError:  # pragma: no cover - already gone
            pass


class _WriterPool:
    """Fan observation writes out to spawn workers through shared memory —
    and survive those workers dying.

    One SHM block per chunk (a single memcpy from the fetched host arrays),
    jobs round-robined across workers in contiguous slices, and a
    two-chunk window so writes overlap the next chunk's transfer without
    holding unbounded host memory.  A drained chunk's block is kept for a
    later chunk (at most two are kept): the first write into a fresh
    block faults in every page, which costs several times the copy
    itself on some hosts.

    Self-healing (the 10k-observation run must outlive its workers):

    - A dead worker breaks the whole ``ProcessPoolExecutor``; the pool
      detects it (``BrokenExecutor`` on drain), re-spawns a fresh executor
      under the capped-exponential-backoff :class:`RetryPolicy`, and
      resubmits every not-yet-drained batch — output files are written
      atomically, so re-running a half-finished batch is idempotent.
    - Plain job failures (an exception out of a live worker — e.g. a
      transient shm attach error) retry the one batch up to
      ``job_retries`` times before surfacing.
    - After ``max_pool_deaths`` CONSECUTIVE pool deaths (the counter
      resets on any drained batch) the pool degrades to an in-process
      serial writer instead of aborting the run: queued shm batches are
      finished by the parent, and later ``submit_chunk`` calls write
      synchronously.  Slower beats dead.
    - Every exit path — success, job failure, pool death, degradation —
      closes AND unlinks every shared-memory segment, in flight or kept,
      in ``finally`` blocks; a multi-hour run must not bleed /dev/shm.

    ``on_chunk_done(token, results)`` fires after a chunk's writes are
    durably complete (the run supervisor journals there); drains are FIFO
    so commit order follows submit order.

    Start-up: every worker is started at once and the pool waits for all
    of them.  The pickled write context (a pulsar's portrait is megabytes)
    reaches the workers through one shared-memory block: spawn writes a
    worker's initializer arguments into a pipe that the child drains only
    after importing this module, so megabytes there would start the
    workers one after another.
    """

    def __init__(self, n_writers, payload, state, startup_timeout=120.0,
                 respawn_policy=None, max_pool_deaths=3, job_retries=2,
                 on_chunk_done=None, timers=None):
        self.n = n_writers
        self._payload_size = len(payload)
        self._state = state  # parent-side writer state for serial fallback
        self._timers = timers  # parent-side StageTimers (encode = shm
        #                        memcpy, write = blocked wait on workers)
        self._timeout = startup_timeout
        self._policy = respawn_policy or RetryPolicy(
            max_attempts=3, base_delay=0.25, max_delay=5.0)
        self._max_pool_deaths = int(max_pool_deaths)
        self._job_retries = int(job_retries)
        self._on_chunk_done = on_chunk_done
        self._deaths = 0      # consecutive pool deaths (resets on progress)
        self.degraded = False
        self._pool = None
        self._inflight = []   # [{shm, meta, pending: [{jobs, fut, tries}], token}]
        self._spare = []      # drained blocks, kept for later chunks
        from multiprocessing import shared_memory

        self._payload_shm = shared_memory.SharedMemory(
            create=True, size=max(len(payload), 1))
        self._payload_shm.buf[:len(payload)] = payload
        try:
            self._spawn_pool()  # raises if workers cannot start at all
        except BaseException:
            self._release_payload()
            raise

    # -- lifecycle ---------------------------------------------------------

    def _spawn_pool(self):
        import concurrent.futures as cf
        import multiprocessing as mp

        ctx = mp.get_context("spawn")  # fork after CUDA init is unsafe
        pool = cf.ProcessPoolExecutor(
            max_workers=self.n, mp_context=ctx, initializer=_writer_init,
            initargs=(self._payload_shm.name, self._payload_size))
        # fail fast if workers cannot start at all (e.g. __main__ not
        # importable under spawn) instead of hanging on the first drain;
        # one probe per worker starts them all now (the executor starts a
        # worker per submit while none is idle), not inside the first chunk
        try:
            probes = [pool.submit(_probe) for _ in range(self.n)]
            for probe in probes:
                probe.result(timeout=self._timeout)
        except BaseException:
            pool.shutdown(wait=False, cancel_futures=True)
            raise
        self._pool = pool

    def _shutdown_pool(self, wait=True):
        if self._pool is not None:
            self._pool.shutdown(wait=wait, cancel_futures=not wait)
            self._pool = None

    def _degrade(self, err):
        import warnings

        self.degraded = True
        self._shutdown_pool(wait=False)
        warnings.warn(
            f"writer pool died {self._deaths} consecutive time(s) "
            f"(last: {err!r}); degrading to the in-process serial writer "
            "for the rest of the export", RuntimeWarning)

    def _try_respawn(self):
        """Replace a dead executor under the backoff policy.  False means
        respawn itself keeps failing — callers degrade."""
        import warnings

        self._shutdown_pool(wait=False)
        try:
            call_with_retry(
                self._spawn_pool, self._policy,
                on_retry=lambda k, e, d: warnings.warn(
                    f"writer-pool respawn attempt {k + 1} failed ({e!r}); "
                    f"retrying in {d:.2f}s", RuntimeWarning))
            return True
        except RetriesExhausted:
            return False

    def _handle_pool_death(self, err, entry=None):
        """One consecutive pool death: respawn under the backoff policy
        and resubmit every broken future, or degrade once the streak (or
        the respawn budget) is spent.  Callers continue their loop either
        way — the degraded flag redirects remaining work to the serial
        writer."""
        self._deaths += 1
        if self._deaths >= self._max_pool_deaths or not self._try_respawn():
            self._degrade(err)
            return
        import warnings

        warnings.warn(
            f"writer pool died ({err!r}); respawned (consecutive death "
            f"{self._deaths}/{self._max_pool_deaths}) and resubmitted "
            "pending batches", RuntimeWarning)
        self._resubmit_all(entry)

    def _resubmit_all(self, entry=None):
        """After a respawn every broken future — in ``entry`` (if given)
        and in every in-flight chunk — must be re-queued on the new
        executor.  Batches that already FINISHED on the dead executor
        keep their results (harvested into ``done_result``) instead of
        being rewritten — one worker death must not double the window's
        I/O.  A pool that dies again DURING resubmission degrades (the
        fresh-spawned probe passed, so workers are dying faster than
        they start — respawning again would spin)."""
        from concurrent.futures import BrokenExecutor

        entries = ([entry] if entry is not None else []) + self._inflight
        try:
            for e in entries:
                for item in e["pending"]:
                    if "done_result" in item:
                        continue
                    fut = item["fut"]
                    if fut.done():
                        try:
                            item["done_result"] = fut.result()
                            continue
                        except BaseException:  # noqa: BLE001 — broken or
                            pass               # cancelled: resubmit below
                    item["fut"] = self._pool.submit(
                        _worker_write, e["shm"].name, e["meta"],
                        item["jobs"])
        except BrokenExecutor as err:
            self._degrade(err)

    # -- submission / drain ------------------------------------------------

    def submit_chunk(self, triple, jobs, token=None):
        import time as _time

        from concurrent.futures import BrokenExecutor
        from multiprocessing import shared_memory

        if self.degraded:
            # drain older chunks FIRST: their segments must not pin
            # /dev/shm for the rest of the run, and journal commits must
            # keep following submit order (the degraded _collect path
            # writes them serially out of their shm blocks)
            while self._inflight:
                self._drain_oldest()
            arrays = tuple(np.asarray(a) for a in triple)
            self._notify(token, _serial_write_jobs(self._state, arrays, jobs))
            return
        # np.asarray, NOT ascontiguousarray: the copy into the shared
        # block below handles strided sources (the fused-transport data
        # view), and a contiguity pre-copy would double the memcpy
        data, scl, offs = (np.asarray(a) for a in triple)
        nbytes = data.nbytes + scl.nbytes + offs.nbytes
        shm = next((b for b in self._spare if b.size >= nbytes), None)
        if shm is not None:
            self._spare.remove(shm)
        else:
            shm = shared_memory.SharedMemory(create=True, size=max(nbytes, 1))
        try:
            t0 = _time.perf_counter()
            off = 0
            meta = []
            for a in (data, scl, offs):
                # single memcpy straight into the shared block
                view = np.ndarray(a.shape, dtype=a.dtype, buffer=shm.buf,
                                  offset=off)
                view[...] = a
                meta.append((a.shape, a.dtype.str))
                off += a.nbytes
                del view
            if self._timers is not None:
                self._timers.add("encode", _time.perf_counter() - t0)
            step = max(1, -(-len(jobs) // self.n))
            batches = [jobs[k:k + step] for k in range(0, len(jobs), step)]
            while True:
                # a worker can die while the pool is idle between chunks:
                # the death then surfaces HERE (submit raises
                # BrokenExecutor), and must enter the same
                # respawn/degrade ladder as a death caught at drain
                try:
                    pending = [
                        {"jobs": batch, "tries": 0,
                         "fut": self._pool.submit(_worker_write, shm.name,
                                                  meta, batch)}
                        for batch in batches]
                    break
                except BrokenExecutor as err:
                    self._handle_pool_death(err)
                    if self.degraded:
                        break
            if self.degraded:
                while self._inflight:
                    self._drain_oldest()
                results = _serial_write_jobs(self._state, (data, scl, offs),
                                             jobs)
                shm.close()
                shm.unlink()
                self._notify(token, results)
                return
        except BaseException:
            # submission failed mid-way: this chunk's segment would never
            # reach a drain, so release it here (satellite: unlink on
            # EVERY exit path).  The degraded branch above already
            # unlinked before its commit notification — a second unlink
            # must not shadow the real error with FileNotFoundError
            try:
                shm.close()
                shm.unlink()
            except FileNotFoundError:
                pass
            raise
        self._inflight.append({"shm": shm, "meta": meta, "pending": pending,
                               "token": token})
        if len(self._inflight) > 1:
            self._drain_oldest()

    def _drain_oldest(self):
        entry = self._inflight.pop(0)
        shm = entry["shm"]
        try:
            results = self._collect(entry)
        finally:
            # unconditional: whatever _collect raised, no worker reads
            # this chunk's segment any more; it is kept for a later chunk
            # or released
            self._spare.append(shm)
            while len(self._spare) > 2:
                _release_segment(self._spare.pop(0))
        self._notify(entry["token"], results)

    def _collect(self, entry):
        from concurrent.futures import BrokenExecutor

        results = []
        pending = entry["pending"]
        while pending:
            if self.degraded:
                # a prior chunk already tripped degradation: the executor
                # is gone, finish this chunk's remainder in-process
                # (batches harvested before the death keep their results)
                for item in pending:
                    if "done_result" in item:
                        results.extend(item["done_result"])
                    else:
                        results.extend(_serial_write_from_shm(
                            self._state, entry["shm"].name, entry["meta"],
                            item["jobs"]))
                del pending[:]
                break
            item = pending[0]
            if "done_result" in item:
                # finished on an executor that later died; the writes are
                # on disk — keep them (no deaths-streak reset: this is
                # pre-death progress, not evidence the new pool works)
                results.extend(item["done_result"])
                pending.pop(0)
                continue
            try:
                import time as _time

                t0 = _time.perf_counter()
                batch = item["fut"].result()
                if self._timers is not None:
                    # parent-side wait on the workers IS the pipeline's
                    # write-stage cost (worker internals hide under it)
                    self._timers.add("write", _time.perf_counter() - t0)
                results.extend(batch)
            except BrokenExecutor as err:
                self._handle_pool_death(err, entry)
                continue
            except Exception as err:
                item["tries"] += 1
                if item["tries"] > self._job_retries:
                    raise
                import warnings

                warnings.warn(
                    f"writer job batch failed ({err!r}); retry "
                    f"{item['tries']}/{self._job_retries}", RuntimeWarning)
                try:
                    item["fut"] = self._pool.submit(
                        _worker_write, entry["shm"].name, entry["meta"],
                        item["jobs"])
                except BrokenExecutor as err2:
                    # the pool died between the job failure and its
                    # retry: same ladder as a death caught at drain
                    self._handle_pool_death(err2, entry)
                continue
            pending.pop(0)
            self._deaths = 0  # forward progress resets the death streak
        return results

    def _notify(self, token, results):
        if self._on_chunk_done is not None and token is not None:
            self._on_chunk_done(token, results)

    # -- teardown ----------------------------------------------------------

    def finish(self):
        """Drain every in-flight chunk and shut the pool down.  A worker
        failure must not leak ANY chunk's shared memory or mask the first
        error — drain everything, then re-raise the first."""
        first_err = None
        try:
            while self._inflight:
                try:
                    self._drain_oldest()
                except BaseException as err:  # noqa: BLE001 — re-raised below
                    if first_err is None:
                        first_err = err
        finally:
            # belt and braces: _drain_oldest unlinks its own chunk on all
            # paths, but an interrupt between drains must not leak the
            # rest of the window either
            self._release_inflight()
            while self._spare:
                _release_segment(self._spare.pop())
            self._shutdown_pool(wait=first_err is None)
            self._release_payload()
        if first_err is not None:
            raise first_err

    def abort(self):
        """finish() for an already-failing export: clean up everything,
        swallow worker errors so the original exception stays primary."""
        try:
            self.finish()
        except BaseException:  # noqa: BLE001 — cleanup on failure path
            pass

    def _release_payload(self):
        if self._payload_shm is not None:
            self._payload_shm.close()
            self._payload_shm.unlink()
            self._payload_shm = None

    def _release_inflight(self):
        while self._inflight:
            entry = self._inflight.pop(0)
            try:
                entry["shm"].close()
                entry["shm"].unlink()
            except Exception:  # pragma: no cover - cleanup best effort
                pass


# ---------------------------------------------------------------------------
# the exporter
# ---------------------------------------------------------------------------


def _array_sha(arr):
    if arr is None:
        return None
    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(arr, np.float64)).tobytes()
    ).hexdigest()


def _template_sha(tmpl):
    """Content hash of a template: each HDU's serialized header cards and
    raw data bytes — NOT pickle bytes, which vary across numpy/Python
    versions and construction details and would spuriously reject a
    legitimate cross-environment resume."""
    h = hashlib.sha256()
    for hdu in tmpl.hdus:
        h.update(hdu.header.serialize())
        if hdu.data is not None:
            arr = np.ascontiguousarray(hdu.data)
            h.update(str(arr.dtype.descr).encode())
            h.update(arr.tobytes())
    return h.hexdigest()


def _manifest_fingerprint(n_obs, seed, dms, noise_norms, tmpl, parfile,
                          MJD_start, ref_MJD, obs_per_file=1,
                          scenario=None, scenario_params=None):
    # the template is fingerprinted by CONTENT, so str-path and FitsFile
    # callers of the same file agree and a swapped template is caught on
    # resume
    tmpl_sha = _template_sha(tmpl)
    fp = {
        "n_obs": int(n_obs),
        "seed": int(seed),
        "dms_sha256": _array_sha(dms),
        "noise_norms_sha256": _array_sha(noise_norms),
        "template_sha256": tmpl_sha,
        "parfile": None if parfile is None else os.path.basename(str(parfile)),
        "MJD_start": float(MJD_start),
        "ref_MJD": float(ref_MJD),
        "obs_per_file": int(obs_per_file),
    }
    if scenario is not None:
        # stamped for scenario exports only, so scenario-free out_dirs keep
        # their manifests; the fields and their bytes are the JAX
        # package's, so the two packages' out_dirs resume alike
        from ..scenarios.registry import _param

        fp["scenario"] = "+".join(scenario.labels())
        canon = {}
        for name in scenario.param_names():
            # hash the RESOLVED value: passing a knob's registry default
            # explicitly hashes like omitting it
            v = (scenario_params or {}).get(name)
            if v is None:
                canon[name] = float(_param(name).default)
            elif np.ndim(v) == 0:
                canon[name] = float(v)
            else:
                canon[name] = [float(x) for x in np.ravel(v)]
        fp["scenario_params_sha256"] = hashlib.sha256(
            json.dumps(canon, sort_keys=True).encode()).hexdigest()
    return fp


def _check_manifest(out_dir, fp, resume):
    """Write the manifest on first use; on resume, refuse a mismatch
    (resume keyed on file existence alone would silently keep stale files
    from a run with different seed/dms/config).

    Comparison is fingerprint-keyed only, and non-fingerprint keys
    (``pipeline``, ``manifest_extra`` stamps) survive the rewrite on a
    matching resume; ``resume=False`` starts clean.

    A manifest that EXISTS but cannot be parsed refuses a resume loudly:
    with no readable fingerprint there is no way to prove the out_dir
    holds this ensemble, and trusting existing files anyway is exactly
    the silent-mixing bug the manifest exists to prevent."""
    path = os.path.join(out_dir, EXPORT_MANIFEST_NAME)
    old = load_manifest(out_dir)
    if old is None and resume and os.path.exists(path):
        raise RuntimeError(
            f"manifest {path} exists but is unreadable; cannot prove the "
            "out_dir holds this ensemble's files. Use resume=False to "
            "overwrite, or a fresh out_dir.")
    merged = dict(fp)
    if old is not None:
        # manifests written before packing existed lack the key and mean
        # one observation per file; a legitimate resume must not abort
        old.setdefault("obs_per_file", 1)
        if resume:
            mismatches = {k: (old.get(k), fp[k])
                          for k in fp if old.get(k) != fp[k]}
            if mismatches:
                raise ExportManifestError(out_dir, mismatches)
            extras = {k: v for k, v in old.items() if k not in fp}
            merged = {**extras, **fp}
    write_manifest(out_dir, merged)


def _export_paths(out_dir, n_obs, obs_per_file, packer):
    """Output file names for one export — THE naming scheme (the JAX
    package's, so the two packages' out_dirs name files alike)."""
    width = max(5, len(str(n_obs - 1)))
    if obs_per_file == 1:
        return [os.path.join(out_dir, f"obs_{i:0{width}d}.fits")
                for i in range(n_obs)]
    paths = []
    for g in range(packer.n_groups):
        first, end = packer.group_span(g)
        paths.append(os.path.join(
            out_dir, f"obs_{first:0{width}d}-{end - 1:0{width}d}.fits"))
    return paths


def _chunk_skip_predicate(packer, paths, file_done):
    """The chunk-level resume predicate, derived from ONE group-level
    definition of "this group's file is done": a chunk skips only when
    every file any of its observations feeds is done.  Returns
    ``(skip, skip_group)``: the chunk predicate
    :meth:`FoldEnsemble.iter_chunks` consults before it computes a chunk,
    and the group predicate the packer consults before it buffers one."""
    def skip_group(g):
        return file_done(paths[g])

    def skip(start, count):
        g_lo = packer.group_of(start)
        g_hi = packer.group_of(start + count - 1)
        return all(skip_group(g) for g in range(g_lo, g_hi + 1))

    return skip, skip_group


class _GroupPacker:
    """Accumulate per-observation quantized triples into packed file
    groups along the subint axis.

    Group spans are uniform ``obs_per_file`` slices when every
    observation shares one DM, and **per-pulsar/DM runs** otherwise: with
    per-observation ``dms``, consecutive observations with the SAME DM
    form a run (the heterogeneous multi-pulsar layout — pulsar-major
    observation order, one DM per pulsar), each run is cut into
    ``obs_per_file``-sized groups, and every group therefore holds ONE
    source — the physically correct PSRFITS shape (a file carries a
    single CHAN_DM/DM header).  The spans are a pure function of
    ``(n_obs, obs_per_file, dms)``, all three fingerprinted in the export
    manifest, so a resumed export regroups identically and group-level
    journaling stays byte-stable.

    Chunk boundaries from :meth:`FoldEnsemble.iter_chunks` need not align
    with file groups (chunk sizes round to the mesh's obs-shard count), so
    groups fill incrementally from whatever slices arrive; a group's file
    is written once its last observation lands.  Bounded memory: at most
    the groups overlapping one chunk are buffered."""

    def __init__(self, n_obs, obs_per_file, dms=None):
        self.n_obs = int(n_obs)
        self.opf = int(obs_per_file)
        if dms is None or self.opf == 1 or self.n_obs == 0:
            firsts = np.arange(0, self.n_obs, self.opf, dtype=np.int64)
        else:
            d = np.asarray(dms, np.float64)
            edges = np.flatnonzero(d[1:] != d[:-1]) + 1
            run_lo = np.concatenate([[0], edges])
            run_hi = np.concatenate([edges, [self.n_obs]])
            firsts = np.concatenate(
                [np.arange(a, b, self.opf) for a, b in zip(run_lo, run_hi)])
        # span starts plus the terminal sentinel: group g spans
        # [_firsts[g], _firsts[g+1])
        self._firsts = np.concatenate(
            [firsts, [self.n_obs]]).astype(np.int64)
        # group index -> [preallocated (data, scl, offs) buffers, filled
        # bool-per-obs]; buffers are handed out on completion, never reused
        self._buf = {}

    @property
    def n_groups(self):
        return len(self._firsts) - 1

    def group_of(self, i):
        """The group index holding global observation ``i``."""
        return int(np.searchsorted(self._firsts, i, side="right") - 1)

    def group_span(self, g):
        return int(self._firsts[g]), int(self._firsts[g + 1])

    def add_chunk(self, start, triple, skip_group=None):
        """Feed one fetched chunk; yield ``(group_index, packed_triple)``
        for every group the chunk completes.

        A group wholly inside the chunk packs as a reshape of the chunk
        arrays; only boundary-straddling groups buffer — into
        preallocated contiguous per-group buffers filled by ONE slice
        assignment per overlapping chunk (a per-observation ``.copy()`` +
        ``np.concatenate`` scheme once cost more than the whole unpacked
        write path), so a pending group never pins the previous chunk's
        arrays and its completion yield is a zero-copy reshape of its own
        buffer.

        ``skip_group``: optional predicate ``skip_group(g) -> bool``; a
        True group is neither buffered nor yielded.  The resuming
        exporter passes its file-exists check here, so a
        boundary-straddling group whose output already exists never
        starts a partial buffer that nothing would ever complete (such a
        buffer would persist for the whole export when a sibling group
        forced one of its chunks to run)."""
        data, scl, offs = (np.asarray(a) for a in triple)
        count = data.shape[0]
        for g in range(self.group_of(start),
                       self.group_of(start + count - 1) + 1):
            if skip_group is not None and skip_group(g):
                continue
            first, end = self.group_span(g)
            size = end - first
            lo = max(first, start)
            hi = min(end, start + count)
            if lo == first and hi == end and g not in self._buf:
                sl = slice(lo - start, hi - start)
                yield g, tuple(
                    a[sl].reshape((size * a.shape[1],) + a.shape[2:])
                    for a in (data, scl, offs))
                continue
            slot = self._buf.get(g)
            if slot is None:
                slot = self._buf[g] = (
                    tuple(np.empty((size,) + a.shape[1:], a.dtype)
                          for a in (data, scl, offs)),
                    np.zeros(size, bool))
            bufs, filled = slot
            src = slice(lo - start, hi - start)
            dst = slice(lo - first, hi - first)
            for buf, a in zip(bufs, (data, scl, offs)):
                buf[dst] = a[src]
            filled[dst] = True
            if filled.all():
                del self._buf[g]
                yield g, tuple(
                    b.reshape((size * b.shape[1],) + b.shape[2:])
                    for b in bufs)




def pod_export_follower(ens, n_obs, out_dir, seed=0, dms=None,
                        noise_norms=None, chunk_size=256, resume=True,
                        verify=False, obs_per_file=1, pipeline_depth=2,
                        scenario_params=None, progress=None):
    """A pod FOLLOWER's half of a supervised export: drive the SAME chunk
    sequence as the leader (same skip decisions, same dispatches, same
    exchanges) while the leader alone owns files, journal and manifest.

    Lockstep is by construction, not coordination: both sides read the
    same ``out_dir`` state before computing anything (existence under plain
    resume; journal/manifest sha256 under ``verify``, read with
    ``truncate=False`` because the live leader owns the journal), and every
    later decision is a function of data every process holds identically
    (the exchange gives each process the whole chunk).  The leader's
    salted-retry quarantine is single-host, so a non-finite observation
    raises here after the loop, as the leader's pod guard does.

    Returns the (leader-owned) output paths this process mirrored.
    """
    from ..runtime.dist import is_pod

    if not is_pod():
        raise RuntimeError("pod_export_follower requires an initialized "
                           "pod (runtime.dist.init_pod)")
    from ..runtime.supervisor import file_done_check, load_resume_hashes

    dms_np = None if dms is None else np.asarray(dms, np.float64)
    packer = _GroupPacker(n_obs, obs_per_file, dms=dms_np)
    paths = _export_paths(out_dir, n_obs, obs_per_file, packer)

    # the SAME hash source and per-file predicate the leader's supervisor
    # uses, so the skip decisions are identical by construction
    hashes = {}
    if verify:
        hashes, _ = load_resume_hashes(out_dir, truncate=False)
    verified = set()

    def file_done(path):
        return file_done_check(path, hashes, verify, verified)

    skip = None
    if resume:
        skip, _ = _chunk_skip_predicate(packer, paths, file_done)

    want_rfi = getattr(ens, "_has_rfi", False)
    bad_chunks = []
    for start, block in ens.iter_chunks(
        n_obs, chunk_size=chunk_size, seed=seed, dms=dms,
        noise_norms=noise_norms, quantized=True, progress=progress,
        skip_chunk=skip, byte_order="big", finite_mask=True,
        rfi_mask=want_rfi, scenario_params=scenario_params,
        prefetch=max(1, pipeline_depth), fetch_ahead=pipeline_depth,
    ):
        if not np.asarray(block[3]).all():
            # the leader quarantines and keeps driving the loop, raising
            # only after it; raising here mid-loop would kill this process
            # while the leader still exchanges
            bad_chunks.append(int(start))
    if bad_chunks:
        raise RuntimeError(
            f"pod export: non-finite observation(s) in chunk(s) "
            f"{bad_chunks} on a pod mesh (the leader's salted-retry "
            "quarantine is single-host only; this mirrors its loud "
            "post-loop failure — fix the inputs or export single-host)")
    return paths


def export_ensemble_psrfits(ens, n_obs, out_dir, template, pulsar,
                            seed=0, dms=None, noise_norms=None,
                            chunk_size=256, progress=None, resume=True,
                            parfile=None, MJD_start=56000.0,
                            ref_MJD=56000.0, writers=None,
                            obs_per_file=1, supervisor=None, faults=None,
                            pipeline_depth=2, telemetry=None,
                            manifest_extra=None, scenario_params=None,
                            integrity=None):
    """Export ``n_obs`` ensemble observations as PSRFITS files.

    The port of :func:`psrsigsim_tpu.io.export_ensemble_psrfits`, with the
    same signature and the same bytes: given the same quantized chunks, the
    files equal the JAX package's byte for byte.  On the card the chunks
    come from the fused fold → quantize → pack kernel through
    :meth:`~psrsigsim_torch.parallel.FoldEnsemble.iter_chunks`, whose copy
    stream and fetch thread keep the link busy while the device computes
    the next chunk and the writers write the last one.

    Args:
        ens: a configured :class:`~psrsigsim_torch.parallel.FoldEnsemble`
            built from signal/pulsar/telescope objects (its signal shell
            carries the file metadata).
        n_obs: number of observations to export.
        out_dir: output directory; files are ``obs_<index>.fits``
            (``obs_<first>-<last>.fits`` when ``obs_per_file > 1``).
        template: PSRFITS template path (read once) or a ``FitsFile``.
        pulsar: the :class:`Pulsar` the ensemble simulates (metadata +
            auto-par generation).
        seed / dms / noise_norms / chunk_size / progress: as
            :meth:`FoldEnsemble.iter_chunks`.
        resume: skip observations whose output file already exists (files
            are written to a temp name and renamed, so existence means
            complete; a chunk whose files all exist is never computed); a
            manifest guards against resuming with different parameters
            (:class:`ExportManifestError`).  ``"verify"`` (supervised
            exports only) re-hashes existing files against the journal
            instead of trusting existence.
        parfile: optional par file for phase connection; auto-generated
            into ``out_dir`` otherwise.
        MJD_start / ref_MJD: polyco + header epochs, as
            :meth:`PSRFITS.save`.
        writers: file-writer processes.  Default: ``min(8, cpu_count)``;
            values <= 1 write in-process.  Workers are spawned (never
            forked — the parent may hold a CUDA context) and receive chunk
            data through shared memory; they import neither torch nor
            anything that touches the card.  Spawn re-imports the caller's
            ``__main__``: scripts must use the ``if __name__ == "__main__"``
            guard; otherwise the startup probe detects the broken pool and
            falls back to in-process writes with a warning.
        obs_per_file: observations packed per output file as consecutive
            SUBINT rows (a packed file is byte-wise one
            ``obs_per_file``-times-longer observation: OFFS_SUB continues
            across the file, polycos span its duration; data, DAT_SCL and
            DAT_OFFS per observation equal a one-file-per-observation
            export's).  With per-observation ``dms`` groups are cut at every
            DM change, so each file carries one CHAN_DM/DM header
            (:class:`_GroupPacker`).
        supervisor: optional
            :class:`psrsigsim_torch.runtime.RunSupervisor` — arms the
            fault-tolerant run loop: per-file sha256 journaling,
            hash-verified resume, the finite-mask guard with NaN
            quarantine + salted retry, and the append-only chunk journal.
            Most callers should use
            :func:`psrsigsim_torch.runtime.supervised_export` instead of
            passing one by hand.
        faults: optional :class:`psrsigsim_torch.runtime.FaultPlan` —
            deterministic fault injection for tests; never armed unless a
            plan is passed explicitly.
        pipeline_depth: depth of the streaming pipeline (default 2).  With
            depth N the device runs up to N chunks ahead of the fetch, a
            fetch thread copies chunk k while the writers write chunk k-1,
            and bounded queues hold host memory to about N+2 chunks.
            ``pipeline_depth=0`` is the strictly inline
            dispatch → fetch → write loop; the bytes are the same at every
            depth.
        telemetry: optional
            :class:`psrsigsim_torch.runtime.StageTimers`; one is created
            internally otherwise.  Per-stage busy times
            (dispatch/fetch/encode/write), fetched bytes and queue depths
            accumulate there and are folded into the export manifest under
            ``"pipeline"``.
        manifest_extra: optional dict of extra NON-fingerprint keys merged
            into the export manifest (provenance stamps); they never take
            part in resume matching and may not collide with fingerprint
            fields.
        scenario_params: ``{knob: scalar or (n_obs,) array}`` for a scenario
            ensemble's stack (registry defaults fill unset knobs); they are
            fingerprinted in the manifest.  Under a supervisor the RFI
            ground truth of every delivered observation is journaled and
            summarized in the manifest's ``"rfi"`` block.
        integrity: the silent-corruption defense
            (:mod:`psrsigsim_torch.runtime.integrity`): ``None`` consults
            ``PSS_INTEGRITY`` (unset = off, the default); ``True`` / a
            float audit fraction / an
            :class:`~psrsigsim_torch.runtime.IntegrityChecker` arm the
            per-chunk device digests (the packed-digest kernel), the
            deterministic duplicate-execution audit (healed by verified
            re-execution, byte-identical to a clean run), and the
            ``integrity`` journal/manifest record.  Requires a supervisor
            (the events need the durable journal).  Off, the digest kernel
            never runs and the bytes are the unarmed path's.

    Returns:
        list of the output file paths (length ``ceil(n_obs/obs_per_file)``).
    """
    from ..runtime.dist import is_leader as _pod_leader, is_pod as _pod
    from ..runtime.integrity import refuse_on_pod, resolve_integrity
    from ..runtime.telemetry import StageTimers

    if _pod() and not _pod_leader():
        # one process owns the files/journal/manifest; followers drive the
        # same chunk loop through the mirror instead
        raise RuntimeError(
            "pod followers must drive exports with "
            "psrsigsim_torch.io.export.pod_export_follower(); only the "
            "pod leader runs export_ensemble_psrfits")
    if _pod() and supervisor is None:
        # the follower mirror replays the supervised leader's resume
        # decisions (journal and manifest); an unsupervised leader has
        # none to replay
        raise RuntimeError(
            "pod exports must be supervised: use "
            "psrsigsim_torch.runtime.supervised_export (the follower "
            "mirror assumes the supervised leader's chunk sequence)")
    refuse_on_pod(integrity is not None, "exports")
    pipeline_depth = int(pipeline_depth)
    if pipeline_depth < 0:
        raise ValueError("pipeline_depth must be >= 0")
    if telemetry is None:
        telemetry = StageTimers()
    if resume == "verify" and supervisor is None:
        # hash-verified resume is a supervisor capability; silently
        # downgrading to exists-only resume would ship the very torn
        # files the caller asked to re-check
        raise ValueError(
            'resume="verify" requires supervision: use '
            "psrsigsim_torch.runtime.supervised_export (or pass "
            "supervisor=)")
    obs_per_file = int(obs_per_file)
    if obs_per_file < 1:
        raise ValueError("obs_per_file must be >= 1")
    sig = ens.signal_shell()
    if sig is None:
        raise ValueError(
            "the ensemble carries no signal shell (FoldEnsemble.from_config); "
            "build it from signal/pulsar/telescope objects to export PSRFITS")
    os.makedirs(out_dir, exist_ok=True)
    tmpl = template if isinstance(template, FitsFile) else FitsFile.read(template)
    if parfile is None:
        from ..utils.utils import make_par

        parfile = os.path.join(out_dir, f"{pulsar.name}_sim.par")
        make_par(sig, pulsar, outpar=parfile)

    fp = _manifest_fingerprint(
        n_obs, seed, dms, noise_norms, tmpl, parfile, MJD_start, ref_MJD,
        obs_per_file, scenario=getattr(ens, "scenario", None),
        scenario_params=scenario_params)
    _check_manifest(out_dir, fp, resume)
    checker = resolve_integrity(
        integrity,
        fingerprint=hashlib.sha256(
            json.dumps(fp, sort_keys=True).encode()).hexdigest(),
        faults=faults)
    if checker is not None and supervisor is None:
        # integrity events are durable claims; without the supervisor's
        # journal a detection would be a log line lost with the process
        raise ValueError(
            "integrity checking requires supervision: use "
            "psrsigsim_torch.runtime.supervised_export(..., integrity=...) "
            "(or pass supervisor=)")
    if manifest_extra:
        clash = set(manifest_extra) & set(fp)
        if clash:
            raise ValueError(
                f"manifest_extra keys {sorted(clash)} collide with "
                "fingerprint fields")
        man = load_manifest(out_dir) or dict(fp)
        man.update(manifest_extra)
        write_manifest(out_dir, man)

    if writers is None:
        writers = min(8, os.cpu_count() or 1)

    dms_np = None if dms is None else np.asarray(dms, np.float64)
    packer = _GroupPacker(n_obs, obs_per_file, dms=dms_np)
    paths = _export_paths(out_dir, n_obs, obs_per_file, packer)

    # a finished file is the unit of resume; files are written to a temp
    # name and renamed on success, so existence implies completeness and
    # whole chunks of finished work skip the device entirely (a chunk
    # skips only when every file any of its observations feeds exists).
    # Under a supervisor the definition of "done" sharpens: hash-verified
    # resume re-checks each existing file's sha256 against the journal/
    # manifest record instead of trusting existence.
    skip = None
    skip_group = None
    if supervisor is not None:
        def file_done(path):
            return supervisor.file_ok(path)
    else:
        def file_done(path):
            return os.path.exists(path)
    if resume:
        # skip_group is THE definition of "this group's file is done"; it
        # feeds the packer so finished straddling groups are never
        # buffered, and the chunk-level predicate derives from it
        skip, skip_group = _chunk_skip_predicate(packer, paths, file_done)

    # the writer state carries a shallow COPY of the ensemble's signal
    # shell: packed groups resize its subint geometry and per-obs DMs
    # rebind its _dm, and neither mutation may leak into the live
    # ensemble's signal object.  Neither copy carries a tensor: not the
    # signal's data (an object-oriented run may have left some), not the
    # pulsar's key sequence — unpickling either would import torch in the
    # writers
    import copy as _copy

    sig_shell = _copy.copy(sig)
    sig_shell._state = None
    pulsar_shell = _copy.copy(pulsar)
    pulsar_shell._keys = None

    from . import ephem as _ephem

    # barycenter with the ensemble's own kernel when it names one (free
    # when already active: set_ephemeris is idempotent)
    if getattr(ens, "ephemeris_source", None) is not None:
        _ephem.set_ephemeris(ens.ephemeris_source, warn=False)

    state = {"sig": sig_shell, "pulsar": pulsar_shell, "template": tmpl,
             "parfile": parfile, "MJD_start": MJD_start, "ref_MJD": ref_MJD,
             # workers must barycenter with the SAME ephemeris as the
             # parent (see _writer_init); None = analytic/PSS_EPHEM
             "ephemeris_source": _ephem._EPHEM_SOURCE,
             # supervised runs journal per-file sha256; fault plans ride
             # to workers inside the same pickled state
             "hash_files": supervisor is not None,
             "faults": faults,
             # parent-side stage timers: NOT shipped to spawn workers
             # (worker cost surfaces as the parent's write-stage wait)
             "timers": telemetry}

    # the supervisor journals a chunk the moment its files are durably
    # written — from the pool's FIFO drain or straight after serial writes
    commit = None
    if supervisor is not None:
        commit = supervisor.chunk_committed

    pool = None
    if writers > 1:
        from . import native as _native

        # spawn workers carry the parent's write context minus the
        # unpicklable parent-side timers, plus the parent's measured
        # native-encode probe verdicts (see _writer_init).  Prime the
        # CHEAP probes first so the snapshot is meaningful in a fresh
        # process: encode_available() builds/publishes the cached .so
        # (workers dlopen it instead of racing N concurrent g++ builds)
        # and settles int16 cast parity
        _native.encode_available()
        worker_state = {k: v for k, v in state.items() if k != "timers"}
        worker_state["native_probe"] = _native.probe_state()
        try:
            pool = _WriterPool(writers, pickle.dumps(worker_state), state,
                               on_chunk_done=commit, timers=telemetry)
        except Exception as err:  # pragma: no cover - environment-dependent
            import warnings

            warnings.warn(
                f"writer pool unavailable ({err!r}); falling back to "
                "in-process writes", RuntimeWarning)
            pool = None

    # NaN injection (tests) poisons the MAIN pass inputs only; the
    # manifest fingerprint and the retry pass always use the clean arrays
    norms_main = noise_norms
    if supervisor is not None:
        norms_main = supervisor.poisoned_noise_norms(
            n_obs, noise_norms, default=ens.noise_norm)

    bad_obs = set()   # global ids quarantined by the finite-mask guard

    def serial_commit(token, results):
        if commit is not None:
            commit(token, results)

    # the scenario engine's ground-truth RFI mask rides beside the finite
    # guard; supervised scenario exports journal each observation's
    # contamination as provenance
    want_rfi = supervisor is not None and getattr(ens, "_has_rfi", False)

    ok = False
    try:
        for start, block in ens.iter_chunks(
            n_obs, chunk_size=chunk_size, seed=seed, dms=dms,
            noise_norms=norms_main, quantized=True, progress=progress,
            skip_chunk=skip, byte_order="big",
            finite_mask=supervisor is not None, rfi_mask=want_rfi,
            scenario_params=scenario_params,
            prefetch=max(1, pipeline_depth), fetch_ahead=pipeline_depth,
            timers=telemetry, integrity=checker,
        ):
            dig_dev = None
            if checker is not None:
                # the device-attested per-observation digest rides the
                # chunk as its last element (iter_chunks integrity=)
                dig_dev = block[-1]
                block = block[:-1]
            if supervisor is not None:
                if want_rfi:
                    data, scl, offs, finite, rfi = block
                    supervisor.observe_rfi(start, rfi)
                else:
                    data, scl, offs, finite = block
                # the finite guard computed beside the codes: one small
                # bool host array per chunk, never a per-observation
                # round-trip
                bad_obs |= supervisor.observe_chunk(start, finite)
            else:
                data, scl, offs = block
            if checker is not None:
                # checksum lattice + duplicate-execution audit: verify the
                # fetched bytes against the device's claim (and, for
                # sampled chunks, the device against a second execution
                # of itself), healing any disagreement with verified
                # re-executed bytes BEFORE anything reaches the writers.
                # Must run before the '>i2' view below — the digest is
                # defined over the native int16 values the device produced
                data, scl, offs = _integrity_check_chunk(
                    ens, checker, supervisor, start, chunk_size, n_obs,
                    seed, dms, norms_main, scenario_params, data, scl, offs,
                    dig_dev)
            # the device already emitted big-endian bit patterns: a
            # reinterpretation, so every downstream record-array refill
            # and PSRFITS.save cast is a same-dtype memcpy
            data = np.asarray(data).view(">i2")
            if obs_per_file == 1:
                jobs = []
                for j in range(data.shape[0]):
                    i = start + j
                    if i in bad_obs:
                        continue  # quarantined: retried after the loop
                    if resume and file_done(paths[i]):
                        continue
                    jobs.append((j, paths[i],
                                 None if dms_np is None else dms_np[i]))
                if not jobs:
                    continue
                token = ("chunk", start, [p for _, p, _ in jobs])
                if pool is not None:
                    pool.submit_chunk((data, scl, offs), jobs, token=token)
                else:
                    serial_commit(token,
                                  _serial_write_jobs(state, (data, scl, offs),
                                                     jobs))
                continue
            todo = [(g, packed)
                    for g, packed in packer.add_chunk(
                        start, (data, scl, offs), skip_group=skip_group)
                    # a group holding ANY quarantined observation is not
                    # written this pass; the retry phase re-runs and
                    # writes it whole
                    if not any(i in bad_obs
                               for i in range(*packer.group_span(g)))]
            if not todo:
                continue

            def group_dm(g):
                # every member of a group shares one DM by construction
                # (_GroupPacker cuts at DM changes), so the group's file
                # header carries it
                if dms_np is None:
                    return None
                return float(dms_np[packer.group_span(g)[0]])

            if pool is None:
                for g, packed in todo:
                    sha = _write_obs(state, paths[g], packed, group_dm(g))
                    serial_commit(("group", g, [paths[g]]),
                                  [(paths[g], sha)])
                continue
            # one SHM block + one job batch per (shape, chunk): all the
            # groups a device chunk completes fan out across the pool
            # together (the short final group has its own shape)
            by_shape = {}
            for g, packed in todo:
                by_shape.setdefault(packed[0].shape, []).append((g, packed))
            for items in by_shape.values():
                stacked = tuple(
                    np.stack([packed[i] for _, packed in items])
                    for i in range(3))
                jobs = [(k, paths[g], group_dm(g))
                        for k, (g, _) in enumerate(items)]
                pool.submit_chunk(
                    stacked, jobs,
                    token=("groups", [g for g, _ in items],
                           [paths[g] for g, _ in items]))
        ok = True
    finally:
        if pool is not None:
            # on the failure path, clean up without masking the original
            # exception; on success, surface any worker error
            pool.finish() if ok else pool.abort()
            if pool.degraded and supervisor is not None:
                supervisor.note_degraded()

    if supervisor is not None and bad_obs and _pod():
        raise RuntimeError(
            f"pod export: {len(bad_obs)} observation(s) hit the NaN "
            "quarantine; the salted-retry pass re-runs on the leader alone, "
            "which would desynchronize the pod — fix the inputs or export "
            "single-host")
    if supervisor is not None and bad_obs:
        _retry_quarantined(ens, supervisor, state, packer, paths, bad_obs,
                           seed, dms, noise_norms, dms_np, scenario_params)

    # fold the run's stage telemetry into the manifest so every export
    # names its own bottleneck (supervisor.finalize preserves the key).
    # A fully-resumed no-op run records nothing: it must not replace the
    # real run's record with an all-zero snapshot.  (The JAX package also
    # stamps its program registry here; the port has none:
    # psrsigsim_torch/DIVERGENCES.md P6.)
    snap = telemetry.snapshot()
    ran = any(snap[f"{s}_calls"] for s in ("dispatch", "fetch", "encode",
                                           "write"))
    if ran or checker is not None:
        man = load_manifest(out_dir)
        if man is not None:
            if ran:
                man["pipeline"] = {"depth": pipeline_depth,
                                   "writers": int(writers),
                                   "chunk_size": int(chunk_size), **snap}
            if checker is not None:
                # the run's integrity verdict is part of the durable
                # record: whether the lattice/audit ever fired and whether
                # this host's device is SDC-suspect
                man["integrity"] = checker.stats()
            write_manifest(out_dir, man)
    return paths


def _host(t):
    """A device tensor as a host numpy array."""
    return t.detach().cpu().numpy()


def _integrity_check_chunk(ens, checker, supervisor, start, chunk_size,
                           n_obs, seed, dms, noise_norms, scenario_params,
                           data, scl, offs, dig_dev):
    """One chunk through the integrity verdict
    (:meth:`~psrsigsim_torch.runtime.IntegrityChecker.verify_chunk`): the
    lattice over the FETCHED triple, and for sampled chunks a duplicate
    execution of the SAME chunk (same width, same indices — bit-identical
    by the chunk-invariance contract).  A healed chunk's event lands in
    the run journal.  Returns the (possibly healed) ``(data, scl,
    offs)``."""
    from ..runtime.integrity import triple_digest_rows

    count = data.shape[0]
    # host.corrupt arm (tests): flip a fetched value right where the
    # exporter would encode it
    data = checker.corrupt_host(data, ident=start)
    # re-run at the EXACT width and index content of the main pass —
    # identical rows, so digests are comparable bit for bit (a mesh pads
    # the chunk to its obs shards, as iter_chunks does)
    eff = ens.mesh.padded(min(int(chunk_size), int(n_obs)))
    idx = (start + np.arange(eff)) % n_obs

    def _reexec(audit):
        out = ens.run_quantized_at(
            idx, seed=seed, dms=dms, noise_norms=noise_norms,
            byte_order="big", scenario_params=scenario_params,
            audit=audit, return_digest=True)
        return lambda: tuple(_host(t) for t in out[:3]), _host(out[-1])

    (data, scl, offs), _, event = checker.verify_chunk(
        dig_dev, (data, scl, offs), lambda a: triple_digest_rows(*a),
        _reexec, producer="export", ident=start, rows=count,
        evidence={"start": int(start), "device_digests": [
            int(v) for v in np.asarray(dig_dev, np.uint32)[:count]]})
    if event is not None:
        kind, rows, lattice = event
        supervisor.record_integrity(
            kind, start, obs=[start + j for j in rows], healed=True,
            detail={"lattice_rows": len(lattice),
                    "sdc_rows": len(rows) if kind == "audit" else 0})
    return data[:count], scl[:count], offs[:count]


def _retry_quarantined(ens, supervisor, state, packer, paths, bad_obs,
                       seed, dms, noise_norms, dms_np, scenario_params=None):
    """Re-run every quarantined observation ONCE with a fresh fold of its
    PRNG key (clean inputs — injection poisons the main pass only), write
    the files whose observations all came back finite, and record the
    rest as permanently quarantined.

    Packed groups re-run their healthy members with the ORIGINAL keys, so
    a recovered group's healthy rows stay bit-identical to an untroubled
    export; only the re-drawn observations differ (and are journaled).

    On an RFI scenario build the journaled ground truth follows the bytes
    delivered: a healed observation's is the salted re-fold's mask, and a
    group that writes no file drops every member's."""
    salt = supervisor.retry_fold_salt
    groups = sorted({packer.group_of(i) for i in bad_obs})
    want_rfi = getattr(ens, "_has_rfi", False)
    if not supervisor.retry_enabled:
        for g in groups:
            first, end = packer.group_span(g)
            bad = [i for i in range(first, end) if i in bad_obs]
            supervisor.record_retry(g, [], bad)
            if want_rfi:
                supervisor.observe_rfi_retry(list(range(first, end)), None)
        return
    # at most TWO launches however many groups are affected: one salted
    # run over every bad observation, one original-key run over every
    # healthy member of an affected group, regrouped on the host
    all_bad = sorted(bad_obs)
    all_good = sorted(
        i for g in groups for i in range(*packer.group_span(g))
        if i not in bad_obs)
    parts = {}
    if all_good:
        dg, sg, og, _ = (_host(a) for a in ens.run_quantized_at(
            all_good, seed=seed, dms=dms, noise_norms=noise_norms,
            byte_order="big", scenario_params=scenario_params))
        for k, i in enumerate(all_good):
            parts[i] = (dg[k], sg[k], og[k])
    out_bad = [_host(a) for a in ens.run_quantized_at(
        all_bad, seed=seed, dms=dms, noise_norms=noise_norms,
        byte_order="big", fold_salt=salt, scenario_params=scenario_params,
        return_rfi=want_rfi)]
    db, sb, ob, mb = out_bad[:4]
    rfi_bad = out_bad[4] if want_rfi else None
    pos = {i: k for k, i in enumerate(all_bad)}
    healed = {}
    for k, i in enumerate(all_bad):
        if mb[k].all():
            healed[i] = (db[k], sb[k], ob[k])
    for g in groups:
        first, end = packer.group_span(g)
        members = list(range(first, end))
        bad = [i for i in members if i in bad_obs]
        still_bad = [i for i in bad if i not in healed]
        if want_rfi:
            if still_bad:
                supervisor.observe_rfi_retry(members, None)
            elif bad:
                supervisor.observe_rfi_retry(
                    bad, np.stack([rfi_bad[pos[i]] for i in bad]))
        supervisor.record_retry(g, bad, still_bad)
        if still_bad:
            # the group's file is NOT written; the manifest records the
            # loss and a later resume gets a fresh attempt (the file reads
            # as missing)
            continue
        group_parts = {**{i: parts[i] for i in members if i not in bad_obs},
                       **{i: healed[i] for i in bad}}
        packed = tuple(
            np.concatenate([group_parts[i][c] for i in members], axis=0)
            for c in range(3))
        packed = (packed[0].view(">i2"), packed[1], packed[2])
        dm = None
        if dms_np is not None:
            # one DM per group by construction (per-DM grouping; for
            # obs_per_file == 1 this is just the observation's own DM)
            dm = float(dms_np[members[0]])
        sha = _write_obs(state, paths[g], packed, dm)
        supervisor.chunk_committed(("retry", g, [paths[g]]),
                                   [(paths[g], sha)])
