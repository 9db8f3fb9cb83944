"""The streaming dataset factory: spec -> sharded labeled corpus on disk
(counterpart: psrsigsim_tpu/datasets/factory.py, on one device).

Orchestrates the three pieces around the export engine's journal/commit
discipline (shared loader
:func:`~psrsigsim_torch.runtime.journal.load_chunk_journal`):

1. **dispatch/fetch** — chunks of records run on the device through the
   :class:`~psrsigsim_torch.datasets.sampler.RecordSampler` with one
   chunk of dispatch-ahead (the host draws chunk N+1's keys, priors and
   scenario factors and queues its launches before it fetches chunk N);
2. **encode** — each fetched record becomes its exact on-disk bytes
   (:func:`~psrsigsim_torch.datasets.writer.encode_record`) straight from
   the fetched buffers — no PSRFITS round-trip, no intermediate files;
3. **commit** — positional ``pwrite`` into the record shards, ``fsync``
   of exactly the touched shards, THEN one fsync'd journal line
   (``{"e": "chunk", "start", "count", "sha"}`` — sha256 of the chunk's
   record bytes), THEN the atomic cursor.  A SIGKILL at any point loses
   at most one uncommitted chunk; because slots are positional and
   records are pure functions of ``(seed, index)``, a resumed run —
   even with a DIFFERENT chunk size — lands byte-identical shards (the
   ``dataset.kill`` fault point proves it).

The corpus identity is the spec fingerprint
(:func:`~psrsigsim_torch.datasets.spec.fingerprint_hash`); the manifest
guard refuses to resume a directory written under a different one, the
same contract as the export/study manifests.  On a pod mesh
(:mod:`psrsigsim_torch.runtime.dist`) every process computes every chunk
and the leader alone writes shards, indexes, journal and manifest.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from .sampler import RecordSampler
from .spec import (RECORD_FORMAT_VERSION, canonicalize, fingerprint_hash)
from .writer import (DatasetReader, ShardWriter, encode_record, shard_of,
                     shard_path, slot_of)

__all__ = ["DatasetFactory", "DatasetManifestError"]

_MANIFEST_NAME = "dataset_manifest.json"
_JOURNAL_NAME = "dataset_journal.jsonl"
_CURSOR_NAME = "dataset_cursor.json"


class DatasetManifestError(RuntimeError):
    """``resume=True`` against an out_dir written by a DIFFERENT corpus.

    Carries the per-field disagreement (mirrors
    :class:`~psrsigsim_torch.mc.StudyManifestError` /
    :class:`~psrsigsim_torch.io.export.ExportManifestError`)."""

    def __init__(self, out_dir, mismatches):
        self.out_dir = out_dir
        self.mismatches = dict(mismatches)
        lines = [f"  - {k}: out_dir has {v[0]!r}, this run has {v[1]!r}"
                 for k, v in sorted(self.mismatches.items())]
        super().__init__(
            f"out_dir {out_dir} holds a dataset with different parameters; "
            "resuming would silently mix two corpora.  Differing fields:\n"
            + "\n".join(lines)
            + "\nUse a fresh out_dir, or resume=False to overwrite.")


class DatasetFactory:
    """One corpus run: validate the spec, stage the sampler, stream
    labeled records into sharded files with crash-safe commits.

    Parameters
    ----------
    spec : dict
        A dataset spec (:func:`datasets.spec.canonicalize` rules).
    mesh : an ``(obs, chan)`` :class:`~psrsigsim_torch.parallel.Mesh`,
        optional: forwarded to the record sampler (records over ``obs``,
        channels over ``chan``); the corpus is the mesh-free one, byte for
        byte.
    device : str or torch.device, optional
        Where the records are simulated: the CUDA card by default (raises
        without one); ``"cpu"`` runs them on the host.
    """

    def __init__(self, spec, mesh=None, device=None):
        self.canonical = canonicalize(spec)
        self.fingerprint = fingerprint_hash(self.canonical)
        self.sampler = RecordSampler(self.canonical, mesh=mesh, device=device)
        self.n_records = self.sampler.n_records
        self.n_shards = int(self.canonical["shards"])

    # -- manifest -----------------------------------------------------------

    def manifest_fields(self):
        """The resume-guarded manifest body: the fingerprint plus the
        human-auditable summary (spec, schema, shard layout)."""
        return {
            "kind": "dataset",
            "fingerprint": self.fingerprint,
            "record_format": RECORD_FORMAT_VERSION,
            "spec": self.canonical,
            "n_records": self.n_records,
            "shards": self.n_shards,
            "fields": [{"name": n, "dtype": d, "shape": list(s)}
                       for n, d, s in self.sampler.field_layout()],
        }

    def _check_manifest(self, out_dir, resume):
        from ..runtime.journal import atomic_write_json

        fp = self.manifest_fields()
        path = os.path.join(out_dir, _MANIFEST_NAME)
        old = None
        if os.path.exists(path):
            try:
                with open(path) as f:
                    old = json.load(f)
            except json.JSONDecodeError:
                if resume:
                    raise RuntimeError(
                        f"manifest {path} exists but is unreadable; cannot "
                        "prove the out_dir holds this corpus. Use "
                        "resume=False to overwrite, or a fresh out_dir.")
        if old is not None and resume:
            mismatches = {k: (old.get(k), fp[k])
                          for k in fp if old.get(k) != fp[k]}
            if mismatches:
                raise DatasetManifestError(out_dir, mismatches)
            merged = {**{k: v for k, v in old.items() if k not in fp}, **fp}
        else:
            merged = dict(fp)
        atomic_write_json(path, merged, indent=1)

    # -- the run ------------------------------------------------------------

    def run(self, out_dir, chunk_size=256, resume=True, telemetry=None,
            progress=None, faults=None, integrity=None,
            _stop_after_chunks=None):
        """Write (or resume) the corpus; returns a summary dict.

        Args:
            out_dir: corpus directory (shards + indexes + manifest +
                journal live here).
            chunk_size: records per dispatch (every value yields
                byte-identical shards — pinned by tests).
            resume: skip chunks the journal records as committed
                (verified by sha256 against the shard bytes); ``False``
                starts clean.
            telemetry: optional
                :class:`~psrsigsim_torch.runtime.StageTimers` (canonical
                dispatch/fetch/encode/write stages + a ``records``
                counter and per-stage byte totals).
            progress: optional callable ``progress(done, total)``.
            faults: optional
                :class:`~psrsigsim_torch.runtime.FaultPlan` (tests only;
                arms the ``dataset.kill`` point — SIGKILL right after a
                chunk's journal commit — and, with ``integrity``,
                ``device.sdc`` / ``host.corrupt`` / ``disk.bitrot``).
            integrity: the silent-corruption defense
                (:mod:`psrsigsim_torch.runtime.integrity`): ``None``
                consults ``PSS_INTEGRITY`` (unset = off); when armed,
                each chunk's device field buffers carry a combined
                device-computed per-record digest re-checked on host
                before encode (closing the fetch->encode window), a
                deterministic ``audit_frac`` of chunks duplicate-
                executes (a second launch of the same work),
                disagreements heal by verified re-execution
                (byte-identical corpora — healing never re-draws), and
                journal commit lines carry the device-attested ``dig``
                claim.
            _stop_after_chunks: TESTING hook — stop cleanly after N
                fresh chunk commits (an interrupted run without a
                subprocess); returns None.

        Returns: ``{"fingerprint", "n_records", "shards", "stride",
        "commits", "resumed_chunks", "telemetry"}``.
        """
        import time as _time

        from ..runtime.dist import is_leader
        from ..runtime.integrity import (device_fields_digest_rows,
                                         fields_digest_rows_host,
                                         maybe_bitrot, refuse_on_pod,
                                         resolve_integrity)
        from ..runtime.journal import (ChunkJournal, load_chunk_journal,
                                       remove_files, stamp_manifest)
        from ..runtime.telemetry import StageTimers

        if telemetry is None:
            telemetry = StageTimers()
        sampler = self.sampler
        layout = sampler.field_layout()
        names = [n for n, _, _ in layout]
        width = sampler.chunk_width(chunk_size)

        checker = resolve_integrity(integrity, fingerprint=self.fingerprint,
                                    faults=faults)
        refuse_on_pod(checker is not None, "corpora")
        # pod: every process computes every chunk (the exchange gives each
        # the whole chunk), ONE owns the shards/journal/manifest; followers
        # read the same journal and shards, so skip decisions stay in
        # lockstep
        lead = is_leader()

        os.makedirs(out_dir, exist_ok=True)
        if lead:
            self._check_manifest(out_dir, resume)
        journal_path = os.path.join(out_dir, _JOURNAL_NAME)
        cursor_path = os.path.join(out_dir, _CURSOR_NAME)
        if not resume and not lead:
            # a follower never reads the journal the leader is wiping
            done = {}
        elif not resume:
            # the overwrite path removes EVERY previous corpus byte, not
            # just the journal: a prior corpus with more records or more
            # shards would otherwise leave stale tail bytes inside (and
            # stale shard/index files beside) the new one, breaking the
            # equal-fingerprints-mean-byte-identical-corpora contract
            import glob as _glob

            done = {}
            remove_files(
                journal_path, cursor_path,
                *_glob.glob(os.path.join(out_dir, "shard-*.records")),
                *_glob.glob(os.path.join(out_dir, "shard-*.index.json")))
        else:
            done = load_chunk_journal(journal_path, truncate=lead)

        # a follower's writer only reads (the resume check re-hashes the
        # leader's records)
        writer = ShardWriter(out_dir, self.n_records, self.n_shards,
                             layout, RECORD_FORMAT_VERSION)
        journal = None
        if lead:
            # indexes are a pure function of the spec: write them first
            # (and on every resume — idempotent, atomic), so even a corpus
            # killed mid-run has self-describing shards
            writer.write_indexes(self.fingerprint, self.canonical["seed"])
            journal = ChunkJournal(journal_path, cursor_path, faults=faults)

        commits = 0
        resumed = 0
        done_records = 0

        def _report(count):
            nonlocal done_records
            done_records += count
            if progress is not None:
                progress(done_records, self.n_records)

        def _chunk_sha_on_disk(start, count):
            """Re-hash a journaled chunk's record bytes from the shards
            (resume verification — never trust existence alone)."""
            h = hashlib.sha256()
            for i in range(start, start + count):
                buf = writer.read_record_bytes(i)
                if len(buf) != writer.stride:
                    return None
                h.update(buf)
            return h.hexdigest()

        def _dispatch(start):
            t0 = _time.perf_counter()
            dev = sampler.dispatch(start, width)
            if checker is not None:
                # device.sdc arm perturbs the FIRST field buffer before
                # the combined digest attests the chunk; the digest
                # rides the fetch as one extra tiny array
                dev = (checker.apply_sdc(dev[0], ident=start),) \
                    + tuple(dev[1:])
                dev = dev + (device_fields_digest_rows(dev),)
            telemetry.add("dispatch", _time.perf_counter() - t0)
            telemetry.track_live(dev)
            return dev

        def _fetch(dev):
            t0 = _time.perf_counter()
            host = tuple(t.cpu().numpy() for t in dev)
            telemetry.untrack_live(dev)
            telemetry.add("fetch", _time.perf_counter() - t0,
                          nbytes=sum(a.nbytes for a in host))
            return host

        def _encode(start, count, host):
            t0 = _time.perf_counter()
            recs = []
            for j in range(count):
                arrays = {n: host[f][j] for f, n in enumerate(names)}
                recs.append(encode_record(start + j, arrays, layout,
                                          RECORD_FORMAT_VERSION))
            telemetry.add("encode", _time.perf_counter() - t0)
            return recs

        def _integrity_verify(s0, c0, host):
            """The verdict on one fetched chunk's field buffers, before
            encode (the window a host flip would otherwise reach the
            shards through); returns the (possibly healed) field tuple and
            the trusted device digest."""
            fields = tuple(host[:-1])
            fields = (checker.corrupt_host(fields[0], ident=s0),) \
                + fields[1:]

            def _reexec(audit):
                dev = sampler.dispatch(s0, width, audit=audit)
                return (lambda: tuple(t.cpu().numpy() for t in dev),
                        device_fields_digest_rows(dev).cpu().numpy())

            fields, dig, event = checker.verify_chunk(
                host[-1], fields, fields_digest_rows_host, _reexec,
                producer="dataset", ident=s0, rows=c0,
                evidence={"start": int(s0)})
            if event is not None:
                journal.append({"e": "integrity", "kind": event[0],
                                "start": int(s0), "healed": True,
                                "rows": event[1]})
            return fields, dig

        def _commit(start, recs, dig=None):
            """Durable record of one fresh chunk: record bytes land
            positionally in their shards (pwrite), the touched shards
            fsync, THEN the journal line, THEN the atomic cursor — a
            SIGKILL leaves either a committed record or none."""
            nonlocal commits
            commits += 1
            if journal is None:
                # a pod follower: the leader owns the durable record
                return
            t0 = _time.perf_counter()
            touched = set()
            h = hashlib.sha256()
            for j, rb in enumerate(recs):
                touched.add(writer.write_record(start + j, rb))
                h.update(rb)
            writer.fsync(touched)
            rec = {"e": "chunk", "start": int(start),
                   "count": len(recs), "sha": h.hexdigest()}
            if dig is not None:
                # the device-attested claim riding the durable record
                # (checked equal to the host bytes before this commit)
                rec["dig"] = int(np.bitwise_xor.reduce(
                    np.asarray(dig, np.uint32)[:len(recs)]))
            journal.commit(rec)
            telemetry.add("write", _time.perf_counter() - t0,
                          nbytes=len(recs) * writer.stride)
            telemetry.count("records", len(recs))
            # disk.bitrot: decay record `start`'s freshly committed slot
            # (tests) — found by scrub_dataset_dir / the sha-verifying
            # resume, which recomputes the chunk
            maybe_bitrot(
                faults, shard_path(out_dir, shard_of(start, self.n_shards)),
                token=f"start={start}",
                offset=slot_of(start, self.n_shards) * writer.stride)
            journal.maybe_kill("dataset.kill", start)

        stopped = False
        try:
            inflight = []  # [(start, count, device futures)]

            def _drain_one():
                nonlocal stopped
                s0, c0, dev = inflight.pop(0)
                host = _fetch(dev)
                dig = None
                if checker is not None:
                    host, dig = _integrity_verify(s0, c0, host)
                # a pod follower drops the bytes in _commit: it pays no
                # encode for them
                recs = [] if journal is None else _encode(s0, c0, host)
                _commit(s0, recs, dig=dig)
                _report(c0)
                if (_stop_after_chunks is not None
                        and commits >= _stop_after_chunks):
                    stopped = True

            for start in range(0, self.n_records, width):
                count = min(width, self.n_records - start)
                rec = done.get(start)
                if (rec is not None and int(rec.get("count", -1)) == count
                        and _chunk_sha_on_disk(start, count)
                        == rec.get("sha")):
                    resumed += 1
                    _report(count)
                    continue
                inflight.append((start, count, _dispatch(start)))
                if len(inflight) > 1:
                    _drain_one()
                    if stopped:
                        return None
            while inflight:
                _drain_one()
                if stopped:
                    return None
        finally:
            if journal is not None:
                journal.close()
            writer.close()

        out = {
            "fingerprint": self.fingerprint,
            "n_records": self.n_records,
            "shards": self.n_shards,
            "stride": writer.stride,
            "commits": commits,
            "resumed_chunks": resumed,
            "telemetry": telemetry.snapshot(),
        }
        if checker is not None:
            # the corpus run's integrity verdict, in the summary AND
            # the durable manifest
            out["integrity"] = checker.stats()
            stamp_manifest(os.path.join(out_dir, _MANIFEST_NAME),
                           integrity=out["integrity"])
        return out

    def reader(self, out_dir):
        """A :class:`~psrsigsim_torch.datasets.writer.DatasetReader` over a
        finished corpus, fingerprint-checked against this factory."""
        r = DatasetReader(out_dir)
        if r.fingerprint != self.fingerprint:
            raise DatasetManifestError(
                out_dir, {"fingerprint": (r.fingerprint, self.fingerprint)})
        return r
