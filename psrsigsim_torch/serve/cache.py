"""Content-addressed result cache: sha256(canonical spec) -> journaled artifact
(counterpart: psrsigsim_tpu/serve/cache.py; host only, the same files).

Repeated identical requests must be served without touching the device,
and a SIGKILL'd server must come back with every committed result intact
— so the cache reuses the run supervisor's journal discipline end to end:

* Artifacts are ``.npy`` files written temp + fsync + rename (a crash
  leaves the old artifact or the new one, never a torn file).
* Every commit appends one fsync'd line to an append-only
  ``cache_journal.jsonl`` carrying the artifact's sha256, byte size, and
  shape/dtype — THE durable record.  On open, the journal is replayed
  with torn-tail truncation (a fragment with no newline is cut off, not
  welded to the next run's records).
* ``verify=True`` (the relaunched-server path) re-hashes every indexed
  artifact against its journal record; an artifact that is missing,
  truncated, or torn is dropped from the index (and the next request for
  it recomputes) instead of being served corrupt.

**Shared tier (cross-process commit discipline).**  One cache dir is
shared by every replica of a serving fleet, so commits must be safe
against *other processes*, not just other threads:

* One writer per artifact: a commit first takes a per-hash
  ``O_CREAT|O_EXCL`` claim marker (``claims/<hash>.claim``) — atomic on
  POSIX, the same once-semantics the fault plan uses.  A concurrent
  duplicate put loses the claim race and simply waits for the winner's
  journal record: duplicate puts are benign no-ops, never torn files or
  double journal records.
* Journal appends happen under an ``flock`` on ``cache.lock`` as ONE
  ``write`` to an ``O_APPEND`` fd, fsync'd before the lock drops — two
  replicas can never interleave halves of two records.
* Commit order is artifact-then-journal: the artifact is durably renamed
  into place BEFORE its journal line exists, and readers index from the
  journal only — so a reader can never index an artifact whose bytes are
  not yet durable.  A writer SIGKILL'd between the two leaves a stale
  claim and an unindexed file; the next writer for that hash breaks the
  claim (marker older than ``claim_timeout_s``), atomically re-renames
  its own bytes over the orphan, and commits normally.
* Readers refresh their in-memory index from the journal tail on every
  miss, so a replica serves artifacts committed by its peers without
  reopening anything.  Compaction (below) is detected by inode change
  and answered with a full replay.

**Journal compaction (on open).**  verify-drops and superseded records
accumulate forever in an append-only journal; once the dead-record count
passes ``compact_min_dead`` the journal is rewritten at open — live
records only, temp + fsync + atomic rename, under the cross-process lock
— so long-lived cache dirs stop replaying unbounded history.

**Write failures degrade, never wedge.**  Any ``OSError`` during the
artifact tmp write / fsync / rename or the journal append (ENOSPC being
the canonical case) unlinks the partial tmp, releases the per-hash
claim marker, bumps ``write_errors``, and re-raises — so a failed
writer leaves no torn journal, no orphan tmp, and no claim squatting
until ``claim_timeout_s``.  The serving engine catches the re-raise and
degrades to pass-through (the computed result is still served, just
not cached) with a loud ``cache_put_errors`` metric.

**In-memory hot tier (the viral-``spec_hash`` fix).**  Before this
tier, a repeated identical request re-opened, re-read, and re-parsed
its artifact from disk on EVERY hit.  ``ResultCache`` now keeps a
byte-bounded in-process LRU (``hot_max_bytes``, default 256 MiB via
``PSS_CACHE_HOT_MB``; 0 disables) of ``spec_hash -> (payload bytes,
decoded read-only array)``:

* **Populate** on commit (after — never before — the journal record
  exists, so a SIGKILL or injected ENOSPC mid-commit can never leave a
  hot entry for an unjournaled artifact) and on the first disk hit.
* **Serve**: a hot hit performs zero disk reads, zero re-hashing, and
  zero device calls; byte-identity to the disk path is structural —
  the hot entry IS the committed payload bytes.
* **Coherence with the cross-process journal discipline**: a hot entry
  lives exactly as long as its journal record.  The journal-tail
  refresh that applies a peer's ``drop`` (verify-drop) evicts the hot
  entry in the same step, and a compaction inode change (full
  re-replay) clears the whole tier — the same events that invalidate
  the index invalidate the tier, nothing else does (a committed
  artifact's bytes are immutable by content address).
* **Evict** least-recently-used entries whenever the byte budget is
  exceeded (``hot_evictions`` counts them; ``hot_bytes`` is the live
  footprint).

Even with the hot tier disabled, ``get`` memoizes the (inode, size)
and decoded array of its LAST disk read: a repeated ``get`` of the
same hash re-``stat``s (cheap) instead of re-opening and re-hashing,
unless the journal tail moved or the file changed underneath.

The ``serve.kill`` fault point fires here, immediately after a journal
commit (and deliberately before the claim marker is released, so the
relaunch path also proves orphan-claim cleanup); ``cache.contend``
sleeps inside the claim-held / journal-absent window so contention
stress tests reliably hit the race the discipline exists for;
``cache.enospc`` injects the disk-full OSError at either commit stage.
"""

from __future__ import annotations

import contextlib
import errno
import fcntl
import hashlib
import io
import json
import os
import threading
import time

import numpy as np

from ..runtime.faults import crash_process, should_fire

__all__ = ["ResultCache", "ByteLRU", "DEFAULT_HOT_MB"]

_JOURNAL_NAME = "cache_journal.jsonl"
_LOCK_NAME = "cache.lock"
_CLAIMS_DIR = "claims"

#: default in-memory hot-tier budget (MiB) when ``PSS_CACHE_HOT_MB``
#: is unset and no explicit ``hot_max_bytes`` is passed
DEFAULT_HOT_MB = 256.0


def _env_hot_bytes():
    try:
        mb = float(os.environ.get("PSS_CACHE_HOT_MB", DEFAULT_HOT_MB))
    except ValueError:
        mb = DEFAULT_HOT_MB
    return max(int(mb * (1 << 20)), 0)


class ByteLRU:
    """A byte-bounded LRU map (NOT thread-safe — callers hold their own
    lock).  Values are ``(nbytes, payload)`` conceptually; the caller
    supplies the byte cost at put time so the same container serves the
    cache hot tier (cost = artifact payload bytes) and the aio front
    end's rendered-response memo (cost = body bytes).  A zero budget
    disables storage entirely (every put is a no-op)."""

    __slots__ = ("max_bytes", "bytes", "evictions", "_d")

    def __init__(self, max_bytes):
        self.max_bytes = int(max_bytes)
        self.bytes = 0
        self.evictions = 0
        self._d = {}          # key -> (nbytes, value); insertion = LRU order

    def __len__(self):
        return len(self._d)

    def __contains__(self, key):
        return key in self._d

    def get(self, key):
        """The value for ``key`` (marked most-recently-used), or None."""
        ent = self._d.pop(key, None)
        if ent is None:
            return None
        self._d[key] = ent    # re-insert at MRU end
        return ent[1]

    def put(self, key, value, nbytes):
        """Insert/replace ``key``; evicts LRU entries past the budget.
        An entry larger than the whole budget is not stored at all."""
        nbytes = int(nbytes)
        if self.max_bytes <= 0 or nbytes > self.max_bytes:
            self.pop(key)
            return
        self.pop(key)
        self._d[key] = (nbytes, value)
        self.bytes += nbytes
        while self.bytes > self.max_bytes:
            old_key = next(iter(self._d))
            old_bytes, _ = self._d.pop(old_key)
            self.bytes -= old_bytes
            self.evictions += 1

    def pop(self, key):
        ent = self._d.pop(key, None)
        if ent is not None:
            self.bytes -= ent[0]
        return None if ent is None else ent[1]

    def clear(self):
        self._d.clear()
        self.bytes = 0


class ResultCache:
    """Crash-safe content-addressed artifact store for served results.

    Thread-safe AND process-safe: the HTTP threads, the batcher, and
    ``/metrics`` of every replica sharing the cache dir all call in
    concurrently; in-process index/journal mutations are under one
    thread lock, cross-process commits under the per-hash claim marker
    plus the journal ``flock`` (module docstring).

    Parameters
    ----------
    cache_dir : str
        Shared cache root (created if missing).
    verify : bool
        Re-hash every indexed artifact on open (the relaunch path).
    faults : FaultPlan, optional
        Arms ``serve.kill`` / ``cache.contend`` (tests only).
    claim_timeout_s : float
        Age after which another writer's claim marker is presumed
        abandoned (its process died mid-commit) and broken.
    compact_min_dead : int
        Dead journal records (drops/supersedes) tolerated before the
        open path compacts the journal.
    hot_max_bytes : int, optional
        Byte budget for the in-memory hot tier (module docstring).
        Default: ``PSS_CACHE_HOT_MB`` MiB (256 when unset); 0 disables
        the tier (the last-read memo still applies).
    hot_tail_check_s : float
        Coherence heartbeat for hot/memo hits: at most once per this
        interval, a hit ``stat``s the journal (one syscall, no read)
        and folds any peer-appended tail in — the disk path detected a
        peer's verify-drop by the artifact file vanishing, and a tier
        that never touches the file needs this bounded-staleness check
        instead.  The SAME heartbeat rate-limits the hot tier's
        integrity spot check: a hot hit re-hashes its in-memory payload
        against the journal's sha256 at most once per interval, so
        in-process memory corruption cannot keep serving wrong bytes
        from the zero-disk-read fast path (``hot_spot_checks`` /
        ``hot_spot_errors``; a failed check evicts the entry and the
        hit falls through to disk).  0 checks on every hit (tests).
    scrub_interval_s : float
        Incremental background scrub cadence: at most once per this
        interval (piggybacked on ``get`` traffic — no thread), ONE
        indexed artifact is re-hashed against its journal record;
        bit-rot found this way is verify-dropped (journaled, under the
        cross-process lock) and the artifact recommits on its next
        request — found before a reader is.  Default
        ``PSS_CACHE_SCRUB_S`` (5 s); 0 disables.  ``scrub_step`` runs
        the same check on demand (the fleet/bench gates call it).
    """

    def __init__(self, cache_dir, verify=False, faults=None,
                 claim_timeout_s=5.0, compact_min_dead=64,
                 hot_max_bytes=None, hot_tail_check_s=0.05,
                 scrub_interval_s=None):
        self.cache_dir = str(cache_dir)
        self.results_dir = os.path.join(self.cache_dir, "results")
        self.claims_dir = os.path.join(self.cache_dir, _CLAIMS_DIR)
        os.makedirs(self.results_dir, exist_ok=True)
        os.makedirs(self.claims_dir, exist_ok=True)
        self.journal_path = os.path.join(self.cache_dir, _JOURNAL_NAME)
        self.lock_path = os.path.join(self.cache_dir, _LOCK_NAME)
        self.claim_timeout_s = float(claim_timeout_s)
        self.compact_min_dead = int(compact_min_dead)
        self._lock = threading.Lock()
        self._journal_f = None
        self._lock_f = None
        self._faults = faults
        self._index = {}       # spec hash -> journal record
        self._journal_pos = 0  # bytes of journal already replayed
        self._journal_ino = None
        self._puts = 0         # commits by THIS process (serve.kill arm)
        self.hits = 0
        self.misses = 0
        self.verified = 0      # artifacts re-hashed ok on open
        self.dropped = 0       # artifacts dropped by verify
        self.compacted = 0     # dead journal records dropped at open
        self.claim_breaks = 0  # stale claims this process broke
        self.write_errors = 0  # commits aborted by OSError (ENOSPC, ...)
        # in-memory hot tier: spec hash -> (payload bytes, read-only
        # ndarray), LRU by payload bytes, coherent with the journal
        # (every index invalidation path evicts here too)
        self._hot = ByteLRU(_env_hot_bytes() if hot_max_bytes is None
                            else int(hot_max_bytes))
        self.hot_tail_check_s = float(hot_tail_check_s)
        self._last_tail_check = 0.0
        self.hot_hits = 0
        self.disk_hits = 0     # hits that had to read the artifact file
        self.memo_hits = 0     # hits served from the last-read memo
        # last disk read, for hot-disabled repeat gets: (hash, inode,
        # size, array) — valid while the file stats match and the entry
        # is still indexed
        self._last_read = None
        self.tmp_sweeps = 0    # dead writers' partial tmps removed at open
        # incremental bit-rot scrub (runtime/integrity.py layer 3):
        # bounded re-hash per heartbeat, rotating over the index
        if scrub_interval_s is None:
            try:
                scrub_interval_s = float(
                    os.environ.get("PSS_CACHE_SCRUB_S", 5.0))
            except ValueError:
                scrub_interval_s = 5.0
        self.scrub_interval_s = float(scrub_interval_s)
        self._last_scrub = time.monotonic()
        self._scrub_pos = 0
        self.scrubbed = 0        # artifacts re-hashed clean by the scrub
        self.scrub_errors = 0    # bit-rot found (and verify-dropped)
        self.hot_spot_checks = 0  # in-memory payload re-hashes
        self.hot_spot_errors = 0  # hot entries evicted as corrupt
        self._last_hot_check = 0.0
        with self._lock, self._flocked():
            self._open_journal_locked()
        self._sweep_dead_tmps()
        if verify:
            self.verify_all()

    # -- cross-process lock ------------------------------------------------

    @contextlib.contextmanager
    def _flocked(self):
        """Exclusive cross-process lock over journal mutations.  flock
        is per open-file-description, so even two cache instances inside
        ONE process exclude each other (which is what lets the stress
        tests drive the protocol in-process too)."""
        if self._lock_f is None:
            self._lock_f = open(self.lock_path, "a")
        fcntl.flock(self._lock_f.fileno(), fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(self._lock_f.fileno(), fcntl.LOCK_UN)

    # -- open / replay / compaction ---------------------------------------

    def _open_journal_locked(self):
        """Open-time replay under the cross-process lock, through the
        repo's ONE torn-tail loader
        (:func:`~psrsigsim_torch.runtime.journal.load_journal_records`
        — no writer is mid-append while we hold the flock, so a
        newline-less tail is definitely a crash remnant and is
        truncated), then compaction when dead records passed the
        threshold.  Caller holds the thread lock and the flock.  (The
        miss-path ``_refresh_locked`` deliberately stays hand-rolled:
        it runs WITHOUT the flock, where a peer may be mid-append and
        an incomplete tail must be left alone, never truncated.)"""
        from ..runtime.journal import load_journal_records

        records, valid_end = load_journal_records(self.journal_path)
        try:
            st = os.stat(self.journal_path)
        except FileNotFoundError:
            self._journal_pos = 0
            self._journal_ino = None
            return
        for rec in records:
            self._apply_record(rec)
        self._journal_pos = valid_end
        self._journal_ino = st.st_ino
        dead = len(records) - len(self._index)
        if dead >= self.compact_min_dead:
            self._compact_locked(dead)

    def _apply_record(self, rec):
        e = rec.get("e")
        if e == "put":
            self._index[rec["hash"]] = rec
        elif e == "drop":
            # a verify-drop kills the hot entry and the read memo with
            # the index record: hot-tier coherence IS index coherence
            self._index.pop(rec["hash"], None)
            self._hot.pop(rec["hash"])
            if self._last_read is not None \
                    and self._last_read[0] == rec["hash"]:
                self._last_read = None

    def _compact_locked(self, dead):
        """Rewrite the journal with live records only: temp + fsync +
        atomic rename.  Peers detect the inode change on their next
        refresh and re-replay from byte 0 — live entries survive
        compaction by construction, so their rebuilt index is identical.
        Caller holds the thread lock and the flock."""
        tmp = self.journal_path + ".tmp"
        with open(tmp, "w") as f:
            for h in sorted(self._index):
                f.write(json.dumps(self._index[h], sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.journal_path)
        if self._journal_f is not None:
            self._journal_f.close()
            self._journal_f = None
        st = os.stat(self.journal_path)
        self._journal_pos = st.st_size
        self._journal_ino = st.st_ino
        self.compacted += dead

    def _refresh_locked(self):
        """Fold journal records appended by OTHER processes since the
        last read into the index.  Complete lines only — without the
        flock a writer may be mid-append, so an incomplete tail is left
        for the next refresh, never truncated here.  A shrunken or
        re-inoded journal means a peer compacted: re-replay from zero
        (the compacted journal holds every live record).  Caller holds
        the thread lock."""
        try:
            st = os.stat(self.journal_path)
        except FileNotFoundError:
            return
        if st.st_ino != self._journal_ino or st.st_size < self._journal_pos:
            self._index = {}
            self._journal_pos = 0
            self._journal_ino = st.st_ino
            # a peer compacted (or replaced) the journal: conservative
            # full invalidation of the hot tier and read memo — live
            # entries re-enter on their next hit, dead ones must not
            # survive the re-replay
            self._hot.clear()
            self._last_read = None
        if st.st_size == self._journal_pos:
            return
        with open(self.journal_path, "rb") as f:
            f.seek(self._journal_pos)
            buf = f.read()
        pos = self._journal_pos
        for line in buf.splitlines(keepends=True):
            if not line.endswith(b"\n"):
                break
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                break
            pos += len(line)
            self._apply_record(rec)
        self._journal_pos = pos

    def _tail_heartbeat_locked(self):
        """Bounded-staleness coherence for hot/memo hits: at most once
        per ``hot_tail_check_s``, one journal ``stat`` (no read unless
        the tail actually moved) folds peer appends in — so a peer's
        verify-drop evicts our hot entry within the heartbeat window
        even when every local lookup is a hit and the miss-path refresh
        never runs.  Caller holds the thread lock."""
        now = time.monotonic()
        if now - self._last_tail_check < self.hot_tail_check_s:
            return
        self._last_tail_check = now
        try:
            st = os.stat(self.journal_path)
        except FileNotFoundError:
            return
        if (st.st_ino != self._journal_ino
                or st.st_size != self._journal_pos):
            self._refresh_locked()

    def _append_record_locked(self, rec):
        """One fsync'd journal append as a single ``write`` on an
        ``O_APPEND`` fd.  Caller holds the thread lock and the flock;
        the fd is re-opened when a peer's compaction swapped the inode
        out from under it (appends to the dead inode would vanish)."""
        if self._journal_f is not None:
            try:
                if (os.fstat(self._journal_f.fileno()).st_ino
                        != os.stat(self.journal_path).st_ino):
                    self._journal_f.close()
                    self._journal_f = None
            except FileNotFoundError:
                pass
        if self._journal_f is None:
            fd = os.open(self.journal_path,
                         os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644)
            self._journal_f = os.fdopen(fd, "w")
        line = json.dumps(rec, sort_keys=True) + "\n"
        self._journal_f.write(line)
        self._journal_f.flush()
        os.fsync(self._journal_f.fileno())
        self._journal_pos = os.stat(self.journal_path).st_size
        self._journal_ino = os.fstat(self._journal_f.fileno()).st_ino

    def _sweep_dead_tmps(self):
        """Remove artifact tmp files whose writing PROCESS is gone — a
        writer SIGKILLed mid-``put`` (before its atomic rename) leaves
        ``<hash>.npy.<pid>.<tid>.tmp`` behind, invisible to readers but
        flagged by leak audits forever.  The tmp name carries the
        writer's pid, so a dead pid identifies an orphan with
        certainty; a LIVE writer's tmp is never touched."""
        try:
            names = os.listdir(self.results_dir)
        except OSError:
            return
        for name in names:
            if not name.endswith(".tmp"):
                continue
            parts = name.split(".")
            try:               # <hash>.npy.<pid>.<tid>.tmp
                pid = int(parts[-3])
            except (ValueError, IndexError):
                continue
            if pid == os.getpid():
                continue
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                with contextlib.suppress(OSError):
                    os.unlink(os.path.join(self.results_dir, name))
                    self.tmp_sweeps += 1
            except PermissionError:
                pass           # alive under another uid: not ours to reap

    # -- verify ------------------------------------------------------------

    def verify_all(self):
        """Re-hash every indexed artifact against its journal record;
        drop entries whose file is missing or whose bytes differ — and
        journal the drop (under the cross-process lock), so peers and
        future opens do not resurrect a record whose artifact is gone.
        Returns ``(verified, dropped)`` counts."""
        with self._lock:
            bad = []
            for h, rec in self._index.items():
                path = self._artifact_path(h)
                try:
                    with open(path, "rb") as f:
                        data = f.read()
                except OSError:
                    bad.append(h)
                    continue
                if hashlib.sha256(data).hexdigest() != rec["sha256"]:
                    bad.append(h)
                    continue
                self.verified += 1
            if bad:
                with self._flocked():
                    for h in bad:
                        del self._index[h]
                        self._hot.pop(h)
                        if self._last_read is not None \
                                and self._last_read[0] == h:
                            self._last_read = None
                        self._append_record_locked({"e": "drop", "hash": h})
                        try:
                            os.unlink(self._artifact_path(h))
                        except OSError:
                            pass
            self.dropped += len(bad)
            return self.verified, self.dropped

    # -- incremental bit-rot scrub -----------------------------------------

    def _maybe_scrub(self):
        """The per-heartbeat scrub budget: at most once per
        ``scrub_interval_s``, re-hash ONE indexed artifact (bounded
        work, piggybacked on request traffic — no background thread to
        supervise)."""
        if self.scrub_interval_s <= 0:
            return
        now = time.monotonic()
        with self._lock:
            if now - self._last_scrub < self.scrub_interval_s:
                return
            self._last_scrub = now
        self.scrub_step(1)

    def scrub_step(self, max_items=1):
        """Re-hash up to ``max_items`` indexed artifacts against their
        journal records, rotating through the index forever.  Bit-rot
        (or a vanished file) is VERIFY-DROPPED under the cross-process
        lock — journaled ``drop`` record, hot/memo eviction, artifact
        unlinked — so peers see it too and the next request for that
        hash recomputes and recommits: self-healing, journal-coherent.
        Returns the list of hashes dropped this step."""
        dropped = []
        with self._lock:
            # one ring snapshot per step (not per item — a large fleet
            # index must not be re-sorted under the lock n times)
            ring = sorted(self._index)
        for _ in range(int(max_items)):
            with self._lock:
                if not ring:
                    break
                h = ring[self._scrub_pos % len(ring)]
                self._scrub_pos += 1
                rec = self._index.get(h)
                if rec is None:
                    continue   # dropped since the snapshot
            path = self._artifact_path(h)
            try:
                hasher = hashlib.sha256()
                with open(path, "rb") as f:
                    for block in iter(lambda: f.read(1 << 20), b""):
                        hasher.update(block)
                ok = hasher.hexdigest() == rec["sha256"]
            except OSError:
                ok = False
            with self._lock:
                if h not in self._index:
                    continue   # dropped meanwhile (peer / verify)
                if ok:
                    self.scrubbed += 1
                    continue
                with self._flocked():
                    del self._index[h]
                    self._hot.pop(h)
                    if self._last_read is not None \
                            and self._last_read[0] == h:
                        self._last_read = None
                    self._append_record_locked({"e": "drop", "hash": h})
                    with contextlib.suppress(OSError):
                        os.unlink(path)
                self.scrub_errors += 1
                self.dropped += 1
                dropped.append(h)
        return dropped

    # -- lookup / commit ---------------------------------------------------

    def _artifact_path(self, h):
        return os.path.join(self.results_dir, f"{h}.npy")

    def _claim_path(self, h):
        return os.path.join(self.claims_dir, f"{h}.claim")

    def __contains__(self, h):
        with self._lock:
            if h in self._index:
                return True
            self._refresh_locked()
            return h in self._index

    def __len__(self):
        with self._lock:
            return len(self._index)

    def get(self, h):
        """The cached artifact for spec hash ``h`` (a read-only numpy
        array), or None on miss.  Tier order: in-memory hot tier (zero
        syscalls), last-read memo (one ``stat``), disk (read + decode,
        then populate the hot tier).  A miss refreshes the index from
        the journal tail first, so commits by peer replicas over the
        shared dir are served without any restart.  A hit never touches
        the device — the serving engine's device-call counter is
        asserted against exactly this."""
        self._maybe_scrub()
        with self._lock:
            rec = self._index.get(h)
            if rec is None:
                self._refresh_locked()
                rec = self._index.get(h)
            else:
                self._tail_heartbeat_locked()
                rec = self._index.get(h)
            if rec is None:
                self.misses += 1
                return None
            ent = self._hot.get(h)
            if ent is not None:
                # rate-limited in-memory integrity spot check (same
                # heartbeat as tail coherence): the hot tier serves
                # with zero disk reads, so a flipped bit in THIS
                # process's memory would otherwise be served forever —
                # re-hash the payload against the journal's sha256 and
                # evict on mismatch (the hit falls through to disk,
                # whose bytes are scrub-guarded separately)
                now = time.monotonic()
                if now - self._last_hot_check >= self.hot_tail_check_s:
                    self._last_hot_check = now
                    self.hot_spot_checks += 1
                    if hashlib.sha256(ent[0]).hexdigest() \
                            != rec["sha256"]:
                        self._hot.pop(h)
                        self.hot_spot_errors += 1
                        ent = None
                        # the last-read memo aliases the SAME decoded
                        # array/payload from the same disk read: it is
                        # equally suspect and must not catch the
                        # fall-through — force the disk path
                        self._last_read = None
            if ent is not None:
                self.hits += 1
                self.hot_hits += 1
                return ent[1]
            memo = self._last_read
        if memo is not None and memo[0] == h:
            # hot tier disabled (or entry evicted) but this very hash
            # was the last disk read: re-validate with one cheap stat
            # instead of re-opening and re-decoding the artifact.  The
            # memo is still IN-PROCESS memory, so it gets the same
            # rate-limited integrity spot check as the hot tier — the
            # stat proves the DISK didn't change, not that our pages
            # didn't
            try:
                st = os.stat(self._artifact_path(h))
            except OSError:
                st = None
            if (st is not None and st.st_ino == memo[1]
                    and st.st_size == memo[2]):
                with self._lock:
                    ok = h in self._index    # not dropped meanwhile
                    if ok:
                        now = time.monotonic()
                        if (now - self._last_hot_check
                                >= self.hot_tail_check_s):
                            self._last_hot_check = now
                            self.hot_spot_checks += 1
                            if hashlib.sha256(memo[4]).hexdigest() \
                                    != rec["sha256"]:
                                self.hot_spot_errors += 1
                                self._last_read = None
                                ok = False   # fall through to disk
                    if ok:
                        self.hits += 1
                        self.memo_hits += 1
                        return memo[3]
        try:
            path = self._artifact_path(h)
            with open(path, "rb") as f:
                data = f.read()
            st = os.stat(path)
            arr = np.load(io.BytesIO(data))
        except (OSError, ValueError):
            # artifact vanished/torn since open: behave like a miss and
            # drop the index entry so the result is recomputed, not 500'd
            with self._lock:
                self._index.pop(h, None)
                self._hot.pop(h)
                self.misses += 1
            return None
        arr = arr.view()
        arr.flags.writeable = False   # hot entries are shared across hits
        with self._lock:
            self.hits += 1
            self.disk_hits += 1
            self._hot.put(h, (data, arr), len(data))
            # the payload bytes ride the memo so its spot check can
            # re-hash against the journal sha (the decoded array alone
            # cannot reproduce the artifact's .npy bytes)
            self._last_read = (h, st.st_ino, st.st_size, arr, data)
        return arr

    def _claim(self, h):
        """Become THE writer for ``h``, or return the record another
        writer committed while we waited.  The claim marker is
        ``O_CREAT|O_EXCL`` — atomic across processes; a marker older
        than ``claim_timeout_s`` whose journal record never arrived is a
        dead writer's (killed between artifact rename and journal
        append) and is broken under the flock."""
        path = self._claim_path(h)
        while True:
            # check the journal BEFORE attempting the claim, every
            # iteration: once a commit exists, taking a claim is never
            # correct.  (Previously a waiter that watched the winner's
            # marker vanish re-claimed without this check, becoming a
            # duplicate writer whose LIVE marker a third waiter — seeing
            # the committed record — would "clean up" as an orphan,
            # letting a fourth writer run concurrently: two same-PID
            # threads then raced on one artifact tmp name.)
            with self._lock:
                self._refresh_locked()
                rec = self._index.get(h)
            if rec is not None:
                # committed; a marker here can only be an orphan from a
                # writer killed after its journal append (live writers
                # hold their claim from pre-commit to post-append, and
                # with the check-first discipline none starts after the
                # commit) — clean it up
                with contextlib.suppress(OSError):
                    os.unlink(path)
                return rec
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                pass
            else:
                os.write(fd, f"{os.getpid()}\n".encode())
                os.close(fd)
                return None
            # lost the race: wait for the winner's journal record
            try:
                age = time.time() - os.stat(path).st_mtime
            except FileNotFoundError:
                continue  # winner finished or died; loop re-checks first
            if age > self.claim_timeout_s:
                with self._lock, self._flocked():
                    self._refresh_locked()
                    rec = self._index.get(h)
                    if rec is not None:
                        return rec
                    with contextlib.suppress(OSError):
                        os.unlink(path)
                    self.claim_breaks += 1
                continue
            time.sleep(0.005)

    def put(self, h, array, meta=None):
        """Commit one artifact: claim the hash, atomic file write, then
        the flock-guarded fsync'd journal line that makes it durable.
        Idempotent per hash across threads AND processes (a concurrent
        duplicate put waits out the winner and returns its record).
        Returns the journal record."""
        array = np.ascontiguousarray(array)
        buf = io.BytesIO()
        np.save(buf, array)
        payload = buf.getvalue()
        sha = hashlib.sha256(payload).hexdigest()
        rec = {"e": "put", "hash": h, "sha256": sha,
               "nbytes": len(payload), "shape": list(array.shape),
               "dtype": str(array.dtype)}
        if meta:
            rec["meta"] = dict(meta)
        with self._lock:
            if h in self._index:
                return self._index[h]
            self._refresh_locked()
            if h in self._index:
                return self._index[h]
        won = self._claim(h)
        if won is not None:      # a peer committed while we waited
            with self._lock:
                self._index.setdefault(h, won)
            return won
        # artifact first (temp + fsync + atomic rename), journal
        # second: an artifact is durable before it is indexable
        path = self._artifact_path(h)
        # pid + thread id: the tmp name must be unique across the
        # PROCESS's threads too (N in-process caches over one dir is
        # the fleet test topology), belt-and-braces under the claim
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(payload)
                # cache.enospc at="artifact": the disk filled under the
                # tmp write — the cleanup below must unlink the partial
                # tmp and (via the outer finally) release the claim
                self._maybe_enospc("artifact", h)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            # cache.contend: dwell inside the claim-held/journal-absent
            # window so multi-process stress reliably overlaps commits
            if self._faults is not None:
                cfg = self._faults.config("cache.contend")
                if cfg is not None and should_fire(
                        self._faults, "cache.contend", token=h):
                    time.sleep(float(cfg.get("hold_s", 0.05)))
            # cache.enospc at="journal": the artifact is durably renamed
            # but its journal line cannot be written — the same benign
            # unindexed-artifact state a SIGKILL between rename and
            # append leaves (invisible to readers, re-renamed over by
            # the next writer); the journal itself is never torn because
            # nothing was appended
            self._maybe_enospc("journal", h)
            with self._lock:
                with self._flocked():
                    self._refresh_locked()
                    if h not in self._index:
                        self._append_record_locked(rec)
                        self._index[h] = rec
                        self._puts += 1
                        # hot-populate ONLY once the journal record is
                        # durable: a writer killed (or ENOSPC'd) before
                        # this point leaves no hot entry for an
                        # unjournaled artifact
                        ro = array.view()
                        ro.flags.writeable = False
                        self._hot.put(h, (payload, ro), len(payload))
                rec = self._index[h]
                puts = self._puts
            # disk.bitrot arm (tests): decay the artifact right after
            # its sha256 became the journal's record — found by the
            # incremental scrub (verify-drop + recommit-on-next-
            # request), never served as good bytes
            if self._faults is not None:
                from ..runtime.integrity import maybe_bitrot

                maybe_bitrot(self._faults, path, token=h)
            # serve.kill: die AFTER the durable commit but BEFORE the
            # claim release — the relaunch must find exactly
            # `after_puts` artifacts, verified and servable, and peers
            # must treat the orphan marker as the no-op it is
            if self._faults is not None:
                cfg = self._faults.config("serve.kill")
                if cfg is not None and puts >= int(cfg.get("after_puts", 1)):
                    if should_fire(self._faults, "serve.kill", token=h):
                        crash_process()
        except OSError:
            # write-failure cleanup (ENOSPC, EIO, a vanished mount): a
            # failed writer must not wedge the per-hash single-writer
            # claim until claim_timeout_s, and must not leave a partial
            # tmp for audits to flag — unlink the tmp here, release the
            # claim in the shared finally, and re-raise so the caller
            # (the serving engine degrades to pass-through) decides
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            with self._lock:
                self.write_errors += 1
            raise
        finally:
            with contextlib.suppress(OSError):
                os.unlink(self._claim_path(h))
        return rec

    def _maybe_enospc(self, at, h):
        """Injected disk-full (``cache.enospc`` fault point): raises
        OSError(ENOSPC) when armed for stage ``at`` ("artifact" before
        the tmp fsync/rename, "journal" before the journal append)."""
        if self._faults is None:
            return
        cfg = self._faults.config("cache.enospc")
        if cfg is None or cfg.get("at", "artifact") != at:
            return
        if should_fire(self._faults, "cache.enospc", token=h):
            raise OSError(errno.ENOSPC,
                          f"injected ENOSPC (cache.enospc at={at})")

    def stats(self):
        """JSON-ready counters for ``/metrics``."""
        with self._lock:
            return {"entries": len(self._index), "hits": self.hits,
                    "misses": self.misses, "verified": self.verified,
                    "dropped": self.dropped, "puts": self._puts,
                    "compacted": self.compacted,
                    "claim_breaks": self.claim_breaks,
                    "write_errors": self.write_errors,
                    # tier counters: the c10k smoke gates "a hot hit
                    # performs zero disk reads" on exactly these
                    "hot_hits": self.hot_hits,
                    "disk_hits": self.disk_hits,
                    "memo_hits": self.memo_hits,
                    "hot_entries": len(self._hot),
                    "hot_bytes": self._hot.bytes,
                    "hot_max_bytes": self._hot.max_bytes,
                    "hot_evictions": self._hot.evictions,
                    "tmp_sweeps": self.tmp_sweeps,
                    # integrity layer 3: incremental scrub + hot-tier
                    # spot checks (runtime/integrity.py)
                    "scrubbed": self.scrubbed,
                    "scrub_errors": self.scrub_errors,
                    "hot_spot_checks": self.hot_spot_checks,
                    "hot_spot_errors": self.hot_spot_errors}

    def close(self):
        with self._lock:
            if self._journal_f is not None:
                self._journal_f.close()
                self._journal_f = None
            if self._lock_f is not None:
                self._lock_f.close()
                self._lock_f = None
