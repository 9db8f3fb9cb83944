"""Sharded record files: a dependency-free length-prefixed layout (a copy
of psrsigsim_tpu/datasets/writer.py: record bytes, shard layout, index
JSON and ``shuffled_order`` are the JAX package's, byte for byte; host
only, it imports no torch).

**Record format** (version :data:`~psrsigsim_torch.datasets.spec.
RECORD_FORMAT_VERSION`, everything little-endian)::

    u32 magic "PSDR" | u32 version | u64 payload_len | payload
    payload = u64 global_record_index | field bytes...

with the fields (names, dtypes, shapes) fixed per corpus by the
sampler's :meth:`~psrsigsim_torch.datasets.sampler.RecordSampler.
field_layout` — ``params`` (sampled prior values), ``scenario_params``
(the resolved injection vector), then the enabled labels (``energies``,
``rfi_mask`` as uint8) and the raw SEARCH ``tile``.  All shapes are
static, so every record of a corpus has ONE byte stride: slot ``k`` of
a shard starts at byte ``k * stride``, which is what makes positional
``pwrite`` commits idempotent and resume byte-identical across changed
chunk sizes.  A reader needs nothing beyond this file's parser (or the
documented layout and ``struct`` — no FITS, no framework).

**Shard layout**: record ``i`` lands in shard ``i % n_shards`` at slot
``i // n_shards`` — a pure function of the spec, independent of chunk
size and write order.  Each shard carries a JSON **index**
(``shard-NNNNN.index.json``): stride, slot count, the field layout with
byte offsets, and the corpus fingerprint, so shards are self-describing
and randomly addressable without the spec in hand.

**Within-shard shuffling** is a READ-time permutation,
:func:`shuffled_order` — a pure function of ``(seed, shard, epoch)``
built from a sha256-streamed Fisher-Yates, so every consumer of a
corpus sees the same epoch orderings forever, on any platform, with no
RNG-library version in the loop.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct

import numpy as np

__all__ = ["RECORD_MAGIC", "record_stride", "payload_nbytes",
           "encode_record", "parse_record", "shard_of", "slot_of",
           "shard_slots", "shard_path", "index_path", "shuffled_order",
           "ShardWriter", "DatasetReader", "field_offsets"]

RECORD_MAGIC = 0x52445350  # "PSDR" little-endian


def _field_nbytes(dtype, shape):
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    return n * np.dtype(dtype).itemsize


def field_offsets(layout):
    """``[(name, dtype, shape, payload_offset)]`` — byte offsets inside
    the payload, after the leading ``u64`` record index."""
    out = []
    off = 8
    for name, dtype, shape in layout:
        out.append((name, dtype, tuple(shape), off))
        off += _field_nbytes(dtype, shape)
    return out


def payload_nbytes(layout):
    """Payload bytes of one record (index word + all fields)."""
    return 8 + sum(_field_nbytes(d, s) for _, d, s in layout)


def record_stride(layout):
    """Total on-disk bytes of one record (16-byte prefix + payload)."""
    return 16 + payload_nbytes(layout)


def encode_record(index, arrays, layout, version):
    """One record's exact on-disk bytes.

    ``arrays``: ``{name: np.ndarray}`` matching ``layout`` dtypes/shapes
    (device-fetched host arrays; cast/contiguity is enforced here so the
    bytes are canonical regardless of fetch layout)."""
    parts = [struct.pack("<IIQ", RECORD_MAGIC, int(version),
                         payload_nbytes(layout)),
             struct.pack("<Q", int(index))]
    for name, dtype, shape in layout:
        a = np.ascontiguousarray(arrays[name], dtype=np.dtype(dtype))
        if a.shape != tuple(shape):
            raise ValueError(
                f"record field {name}: shape {a.shape} != layout {shape}")
        parts.append(a.tobytes())
    return b"".join(parts)


def parse_record(buf, layout, version):
    """Inverse of :func:`encode_record`; validates magic/version/length
    and returns ``{"index": int, name: array, ...}``."""
    if len(buf) < 16:
        raise ValueError(f"record buffer too short ({len(buf)} bytes)")
    magic, ver, plen = struct.unpack_from("<IIQ", buf, 0)
    if magic != RECORD_MAGIC:
        raise ValueError(f"bad record magic 0x{magic:08x}")
    if ver != int(version):
        raise ValueError(f"record format version {ver}, expected {version}")
    if len(buf) < 16 + plen:
        raise ValueError(
            f"record truncated: {len(buf)} bytes, need {16 + plen}")
    out = {"index": struct.unpack_from("<Q", buf, 16)[0]}
    for name, dtype, shape, off in field_offsets(layout):
        dt = np.dtype(dtype)
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        a = np.frombuffer(buf, dt, count=n, offset=16 + off)
        out[name] = a.reshape(shape).copy()
    return out


# -- shard layout ------------------------------------------------------------


def shard_of(index, n_shards):
    return int(index) % int(n_shards)


def slot_of(index, n_shards):
    return int(index) // int(n_shards)


def shard_slots(n_records, shard, n_shards):
    """How many records shard ``shard`` holds."""
    n, s = int(n_records), int(shard)
    return (n - s + int(n_shards) - 1) // int(n_shards)


def shard_path(out_dir, shard):
    return os.path.join(out_dir, f"shard-{int(shard):05d}.records")


def index_path(out_dir, shard):
    return os.path.join(out_dir, f"shard-{int(shard):05d}.index.json")


# -- deterministic within-shard shuffling ------------------------------------


def shuffled_order(n, seed, shard, epoch):
    """The epoch's within-shard read order: a permutation of
    ``range(n)`` that is a PURE FUNCTION of ``(seed, shard, epoch)``.

    Fisher-Yates driven by a sha256 counter stream over the literal
    ``"seed:shard:epoch"`` material — deliberately no RNG library, so
    the ordering can never drift with a dependency upgrade: a training
    run's epoch schedule is reproducible from these four integers alone,
    forever.  (The 64-bit modulo swap-index has bias ~ n/2^64 —
    irrelevant at any real shard size.)"""
    n = int(n)
    order = list(range(n))
    material = f"{int(seed)}:{int(shard)}:{int(epoch)}".encode()
    for i in range(n - 1, 0, -1):
        ctr = (n - 1 - i).to_bytes(8, "little")
        word = hashlib.sha256(material + ctr).digest()[:8]
        j = int.from_bytes(word, "little") % (i + 1)
        order[i], order[j] = order[j], order[i]
    return order


# -- the sharded writer ------------------------------------------------------


class ShardWriter:
    """Positional record writes over one corpus's shard files.

    Commit discipline is the caller's (the factory journals); this class
    owns the byte mechanics: slot-addressed ``pwrite`` (idempotent —
    recommitting a chunk after a crash lands the identical bytes in the
    identical place), ``fsync`` of exactly the shards a chunk touched,
    and ``pread`` for resume verification.
    """

    def __init__(self, out_dir, n_records, n_shards, layout, version):
        self.out_dir = str(out_dir)
        self.n_records = int(n_records)
        self.n_shards = int(n_shards)
        self.layout = [(n, d, tuple(s)) for n, d, s in layout]
        self.version = int(version)
        self.stride = record_stride(self.layout)
        self._fds = {}

    def _fd(self, shard):
        fd = self._fds.get(shard)
        if fd is None:
            fd = os.open(shard_path(self.out_dir, shard),
                         os.O_RDWR | os.O_CREAT, 0o644)
            self._fds[shard] = fd
        return fd

    def write_record(self, index, rec_bytes):
        """pwrite one encoded record at its slot; returns the shard id
        (for the caller's fsync set)."""
        if len(rec_bytes) != self.stride:
            raise ValueError(
                f"record {index}: {len(rec_bytes)} bytes != stride "
                f"{self.stride}")
        s = shard_of(index, self.n_shards)
        path = shard_path(self.out_dir, s)
        wrote = os.pwrite(self._fd(s), rec_bytes,
                          slot_of(index, self.n_shards) * self.stride)
        if wrote != self.stride:
            # a short pwrite (ENOSPC about to land, RLIMIT_FSIZE) does
            # not raise — committing past it would journal a sha over
            # in-memory bytes the shard doesn't hold (the export
            # writer's short-write rule, io/export.py)
            raise OSError(
                f"short write to {path}: {wrote} of {self.stride} bytes "
                f"for record {index}")
        return s

    def fsync(self, shards):
        for s in sorted(set(shards)):
            os.fsync(self._fd(s))

    def read_record_bytes(self, index):
        """pread one record's bytes (resume verification); short reads
        return what the file holds."""
        s = shard_of(index, self.n_shards)
        return os.pread(self._fd(s), self.stride,
                        slot_of(index, self.n_shards) * self.stride)

    def write_indexes(self, fingerprint, seed, extra=None):
        """The per-shard JSON indexes (atomic write; idempotent — the
        content is a pure function of the spec)."""
        from ..runtime.journal import atomic_write_json

        for s in range(self.n_shards):
            body = {
                "format": "psrsigsim-dataset-records",
                "record_format": self.version,
                "shard": s,
                "n_shards": self.n_shards,
                "n_records_total": self.n_records,
                "records": shard_slots(self.n_records, s, self.n_shards),
                "stride": self.stride,
                "seed": int(seed),
                "fingerprint": fingerprint,
                "payload": [
                    {"name": n, "dtype": d, "shape": list(sh),
                     "payload_offset": off}
                    for n, d, sh, off in field_offsets(self.layout)],
            }
            if extra:
                body.update(extra)
            atomic_write_json(index_path(self.out_dir, s), body, indent=1)

    def close(self):
        for fd in self._fds.values():
            os.close(fd)
        self._fds.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- the reader --------------------------------------------------------------


class DatasetReader:
    """Random and epoch-shuffled access to a written corpus.

    Self-describing: everything comes from the shard index files — no
    spec, no framework.  ``iter_epoch(epoch)`` yields records in the
    deterministic :func:`shuffled_order` permutation per shard, so two
    consumers (or one consumer across restarts) walk identical epoch
    schedules.
    """

    def __init__(self, out_dir):
        self.out_dir = str(out_dir)
        with open(index_path(out_dir, 0)) as f:
            idx0 = json.load(f)
        self.n_shards = int(idx0["n_shards"])
        self.n_records = int(idx0["n_records_total"])
        self.stride = int(idx0["stride"])
        self.version = int(idx0["record_format"])
        self.seed = int(idx0["seed"])
        self.fingerprint = idx0["fingerprint"]
        self.layout = [(f["name"], f["dtype"], tuple(f["shape"]))
                       for f in idx0["payload"]]
        self._fds = {}  # shard -> fd, opened once (epoch loops read
        # millions of records from at most n_shards files; an open/close
        # pair per record would dominate on networked filesystems)

    def shard_records(self, shard):
        return shard_slots(self.n_records, shard, self.n_shards)

    def _fd(self, shard):
        fd = self._fds.get(shard)
        if fd is None:
            fd = os.open(shard_path(self.out_dir, shard), os.O_RDONLY)
            self._fds[shard] = fd
        return fd

    def close(self):
        for fd in self._fds.values():
            os.close(fd)
        self._fds.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def read(self, shard, slot):
        """One parsed record by (shard, slot)."""
        if not (0 <= slot < self.shard_records(shard)):
            raise IndexError(
                f"slot {slot} outside shard {shard} "
                f"({self.shard_records(shard)} records)")
        buf = os.pread(self._fd(shard), self.stride, slot * self.stride)
        rec = parse_record(buf, self.layout, self.version)
        want = slot * self.n_shards + shard
        if rec["index"] != want:
            raise ValueError(
                f"shard {shard} slot {slot}: holds record {rec['index']}, "
                f"expected {want} — wrong file for this layout?")
        return rec

    def read_index(self, index):
        """One parsed record by global index."""
        return self.read(shard_of(index, self.n_shards),
                         slot_of(index, self.n_shards))

    def record_bytes(self, index):
        """One record's RAW on-disk bytes by global index (no parsing) —
        what the integrity scrub layer re-hashes against the journal's
        per-chunk sha256 (:func:`psrsigsim_torch.runtime.integrity.
        scrub_dataset_dir`).  May be short when the record was never
        committed."""
        shard = shard_of(index, self.n_shards)
        return os.pread(self._fd(shard), self.stride,
                        slot_of(index, self.n_shards) * self.stride)

    def iter_epoch(self, epoch, shards=None):
        """Yield every record of the chosen shards (default: all) in
        the epoch's deterministic shuffled order, shard-major."""
        for s in (range(self.n_shards) if shards is None else shards):
            n = self.shard_records(s)
            for slot in shuffled_order(n, self.seed, s, epoch):
                yield self.read(s, slot)
