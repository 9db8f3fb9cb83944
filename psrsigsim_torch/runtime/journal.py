"""The durable record of every chunked producer: crash-safe JSON writes,
the manifest, file hashes, and the append-only chunk journal with its
atomic cursor (counterpart: the journal plumbing the JAX package repeats
in runtime/supervisor.py, mc/study.py and datasets/factory.py).

The supervised export, the Monte-Carlo study and the dataset factory each
make a chunk durable in the same order: the chunk's own payload first
(files, ``trials.f32`` rows or shard records, each fsync'd by its
producer), THEN one fsync'd sorted-key journal line, THEN the atomic
cursor ``{"commits", "journal_bytes"}``.  A SIGKILL at any point leaves
either a committed record or none; :func:`load_journal_records` is the
one torn-tail rule every reader replays through.

Host-only: imports no torch (the export's spawn writers import it).
"""

from __future__ import annotations

import hashlib
import json
import os

from .faults import crash_process

__all__ = ["ChunkJournal", "atomic_write_json", "file_sha", "load_manifest",
           "write_manifest", "stamp_manifest", "remove_files",
           "load_journal_records", "load_chunk_journal",
           "load_resume_hashes", "EXPORT_MANIFEST_NAME", "RUN_JOURNAL_NAME"]

EXPORT_MANIFEST_NAME = "export_manifest.json"
RUN_JOURNAL_NAME = "run_journal.jsonl"


def atomic_write_json(path, obj, indent=None):
    """THE crash-safe JSON write: temp + fsync + rename, Orbax-style —
    a crash leaves either the old file or the new one, never a truncated
    hybrid.  Manifests, indexes and cursors all write through here so
    the durability contract lives in one place."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=indent)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def file_sha(path):
    """Streaming sha256 of a finished output file (the manifest/verify
    fingerprint of crash-safe resume, and what the scrub re-hashes)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def load_manifest(out_dir):
    """The export manifest dict, or None when absent/unreadable (a
    truncated manifest from a crash mid-rewrite must not kill the resume
    — the journal and file hashes are the durable record)."""
    path = os.path.join(out_dir, EXPORT_MANIFEST_NAME)
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None


def write_manifest(out_dir, manifest):
    atomic_write_json(os.path.join(out_dir, EXPORT_MANIFEST_NAME), manifest,
                      indent=1)


def stamp_manifest(path, **fields):
    """Set ``fields`` in the JSON manifest at ``path`` (atomic rewrite);
    a manifest that is missing or unreadable is left alone."""
    try:
        with open(path) as f:
            man = json.load(f)
    except (OSError, json.JSONDecodeError):
        return
    man.update(fields)
    atomic_write_json(path, man, indent=1)


def remove_files(*paths):
    """Unlink each path; one already gone is fine."""
    for p in paths:
        try:
            os.unlink(p)
        except FileNotFoundError:
            pass


def load_journal_records(path, truncate=True):
    """Every valid complete record of an append-only fsync'd journal,
    in order, plus the byte length of the journal's valid prefix.

    THE shared torn-tail rule of every journal (the export's, the
    study's, the factory's and the serving cache's): a crash can leave at
    most one torn final line, which is skipped AND — when ``truncate`` —
    truncated away: appending a later run's records after a
    newline-less fragment would weld two records into one permanently
    unparseable line, silently discarding every later commit on the
    NEXT load.  Truncating costs at most one chunk's recompute.

    Returns ``(records, valid_end)``; a missing journal is ``([], 0)``.
    Callers doing open-time replay must hold whatever cross-process
    lock guards their journal (no writer may be mid-append while the
    tail is truncated) — the run journal is single-writer by
    construction.
    """
    records = []
    valid_end = 0
    try:
        with open(path, "rb") as f:
            for line in f:
                if not line.endswith(b"\n"):
                    break  # torn mid-write: unsafe to append after
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    break
                valid_end += len(line)
                records.append(rec)
    except FileNotFoundError:
        return records, 0
    if truncate and valid_end < os.path.getsize(path):
        with open(path, "rb+") as f:
            f.truncate(valid_end)
    return records, valid_end


def load_chunk_journal(path, event="chunk", key="start", truncate=True):
    """Valid committed-chunk records of an append-only fsync'd journal,
    keyed by ``int(rec[key])`` for records whose ``"e"`` equals
    ``event`` — the chunked-run view over
    :func:`load_journal_records` (one torn-tail rule in the repo).  A pod
    follower passes ``truncate=False``: the live leader owns the file."""
    records, _ = load_journal_records(path, truncate=truncate)
    return {int(rec[key]): rec for rec in records if rec.get("e") == event}


def load_resume_hashes(out_dir, journal_path=None, truncate=True):
    """The basename -> sha256 map hash-verified resume checks committed
    export files against, rebuilt from the manifest plus the journal's
    commit records.  Returns ``(hashes, records)`` (the raw records so
    the supervisor can replay its extra events).

    THE one hash source for resume: the leader's supervisor and the pod
    follower mirror (:func:`psrsigsim_torch.io.export.pod_export_follower`)
    both load through here, so their skip decisions derive from the same
    bytes.  Followers pass ``truncate=False``: the live leader owns the
    journal file."""
    hashes = {}
    man = load_manifest(out_dir)
    if man is not None:
        hashes.update(man.get("files", {}))
    records, _ = load_journal_records(
        journal_path or os.path.join(out_dir, RUN_JOURNAL_NAME),
        truncate=truncate)
    for rec in records:
        if rec.get("e") == "commit":
            hashes.update(rec.get("files", {}))
    return hashes, records


class ChunkJournal:
    """One run's append-only fsync'd journal and its atomic cursor.

    The file opens (append mode) at the first record.  :meth:`commit`
    counts a chunk's record and rewrites the cursor
    ``{"commits", "journal_bytes"}`` (the commits of THIS process, the
    journal's byte length after the line), so the cursor names a prefix
    of the journal that is durable.  A pod follower or an in-memory
    study holds no journal at all: the leader owns the durable record.
    """

    def __init__(self, path, cursor_path, faults=None):
        self.path = path
        self.cursor_path = cursor_path
        self.faults = faults
        self.commits = 0
        self._f = None

    def append(self, *recs):
        """Write each record as one sorted-key JSON line, then flush and
        fsync them together."""
        if self._f is None:
            self._f = open(self.path, "a")
        for rec in recs:
            self._f.write(json.dumps(rec, sort_keys=True) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def commit(self, rec):
        """A chunk's durable record: its fsync'd line, then the cursor."""
        self.append(rec)
        self.commits += 1
        atomic_write_json(self.cursor_path, {
            "commits": self.commits, "journal_bytes": self._f.tell()})

    def maybe_kill(self, point, ident, targetable=True):
        """The ``<producer>.kill`` fault point: SIGKILL right after the
        commit of ``ident`` (a chunk start, or a list of group indices)
        when it holds the point's ``after_start``; unset, every commit
        is a candidate (the plan's ``match``/``times`` decide).  A commit
        that is not ``targetable`` is a candidate only for an unset
        ``after_start``.  Marker-file once-semantics keep the resume run
        alive."""
        if self.faults is None:
            return
        cfg = self.faults.config(point)
        if cfg is None:
            return
        idents = list(ident) if isinstance(ident, (list, tuple)) else [ident]
        after = cfg.get("after_start")
        if after is not None and not (targetable and after in idents):
            return
        if self.faults.fire(point, token=f"start={idents[0]}"):
            crash_process()

    def close(self):
        """Release the file (idempotent); every record is already
        durable."""
        if self._f is not None:
            self._f.close()
            self._f = None
