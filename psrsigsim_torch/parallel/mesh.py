"""Device meshes and sharding helpers (counterpart:
psrsigsim_tpu/parallel/mesh.py).

The structural parallelism of this workload is (1) independent
observations and (2) independent frequency channels; both map onto a 2-D
mesh with axes ``("obs", "chan")``.  The JAX package builds a
``jax.sharding.Mesh`` and runs one ``shard_map`` program over it from one
controller.  The port keeps the single controller: a :class:`Mesh` is a
numpy array of ``torch.device`` entries with axis names, and a meshed entry
point runs its body once per mesh position on that position's device, one
position after the other on the host thread, then assembles the result on
the mesh's first device (psrsigsim_torch/DIVERGENCES.md P22).

An explicit device list may repeat a device: each entry is one shard.  That
is how one card (or the host, in the tests) holds any shard count.

Under a pod (:mod:`psrsigsim_torch.runtime.dist`, :func:`distributed_init`)
every mesh position also carries the index of the process that runs it:
:func:`make_mesh` builds the global position list, each process's devices
in process order (the counterpart of ``jax.devices()`` turning global), and
:meth:`MeshSlabs.run` runs this process's positions only, then exchanges
the parts so that every process holds the whole result.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ._collectives import gather_grid, on_device

__all__ = [
    "Mesh",
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "distributed_init",
    "visible_devices",
    "mesh_devices",
    "check_chan_groups",
    "MeshSlabs",
    "cut_rows",
    "OBS_AXIS",
    "CHAN_AXIS",
]

OBS_AXIS = "obs"
CHAN_AXIS = "chan"


def _as_device(d):
    """A ``torch.device`` with its index filled in for CUDA (``"cuda"`` is
    the current card), so equal devices compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        idx = torch.cuda.current_device() if torch.cuda.is_available() else 0
        d = torch.device("cuda", idx)
    return d


class Mesh:
    """A named grid of devices: ``devices`` is a numpy object array of
    ``torch.device`` entries, ``axis_names`` one name per axis, and
    ``mesh.shape[axis]`` the size of an axis (jax's lookup).  Entries may
    repeat; each is one shard.  ``processes`` (same shape; default: this
    process for every position) names the pod process that runs each
    position."""

    def __init__(self, devices, axis_names, processes=None):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a {arr.ndim}-D device array needs "
                             f"{arr.ndim} axis names, got {axis_names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [_as_device(d) for d in arr.reshape(-1)]
        types = sorted({d.type for d in flat})
        if len(types) > 1:
            # every position runs the same route (kernel or plain), chosen
            # by the device type, as jax's mesh holds one platform
            raise ValueError(f"a mesh's devices must be of one type, got "
                             f"{types}")
        self.devices = flat.reshape(arr.shape)
        self.axis_names = axis_names
        if processes is None:
            processes = np.full(arr.shape, _process_id())
        self.processes = np.asarray(processes, dtype=np.int64)
        if self.processes.shape != arr.shape:
            raise ValueError(f"processes {self.processes.shape} must match "
                             f"the device grid {arr.shape}")
        local = self.processes == _process_id()
        if not local.any():
            raise ValueError("a mesh needs at least one position of this "
                             "process")
        self._local = local

    @property
    def shape(self):
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def padded(self, n):
        """``n`` observations rounded up to the obs shards: the width a
        batch of ``n`` pads to (the reference's rule)."""
        n = int(n)
        return n + (-n) % self.shape[OBS_AXIS]

    @property
    def first_device(self):
        """Where a meshed entry point assembles its results: the first
        position of this process."""
        return self.devices[self._local][0]

    def is_local(self, pos):
        """Whether this process runs mesh position ``pos``."""
        return bool(self._local[pos])

    @property
    def spans_processes(self):
        """True when another process runs some of the positions (a pod
        mesh)."""
        return not self._local.all()

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.reshape(-1)),
                tuple(self.processes.reshape(-1).tolist()))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        tail = ""
        if self.spans_processes:
            tail = f", processes={self.processes.reshape(-1).tolist()}"
        return (f"Mesh({dict(self.shape)}, "
                f"devices={[str(d) for d in self.devices.reshape(-1)]}"
                f"{tail})")


def _process_id():
    from ..runtime.dist import pod_info

    return pod_info().process_id


def visible_devices():
    """Every visible CUDA device; raises without one, as the entry points
    do (``utils/device.py``): a mesh never falls back to the host on its
    own — pass ``devices=["cpu", ...]`` for that."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass devices=['cpu', ...] to "
            "build a mesh on the host")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape=None, devices=None):
    """Build an ``(obs, chan)`` mesh.

    Args:
        shape: ``(n_obs_shards, n_chan_shards)``; default puts every device
            on the observation axis.
        devices: explicit device list (default: every visible CUDA device).
            Entries may repeat (each is one shard).

    Under a pod ``devices`` are this process's; every process passes as
    many, and the mesh's positions are process 0's devices, then process
    1's, and so on (row-major over ``shape``).  A shape that does not tile
    the (global) positions raises ``ValueError``.
    """
    from ..runtime.dist import pod_info

    devices = visible_devices() if devices is None else list(devices)
    nproc = pod_info().num_processes if pod_info().is_pod else 1
    procs = np.repeat(np.arange(nproc), len(devices))
    if nproc > 1:
        devices = devices * nproc
    if shape is None:
        shape = (len(devices), 1)
    if len(shape) != 2 or shape[0] * shape[1] != len(devices):
        raise ValueError(
            f"mesh shape {tuple(shape)} does not tile {len(devices)} devices")
    dev_array = np.empty(len(devices), dtype=object)
    dev_array[:] = devices
    return Mesh(dev_array.reshape(tuple(shape)), (OBS_AXIS, CHAN_AXIS),
                processes=procs.reshape(tuple(shape)))


def mesh_devices(mesh, device):
    """An entry point's ``(mesh, device)``: the mesh it runs over and the
    device its results land on.  No mesh is a ``(1, 1)`` mesh on
    ``device`` resolved as the entry points do (None = the card); a mesh
    names the devices, so a ``device`` other than its first raises."""
    from ..utils.device import resolve_device

    if mesh is None:
        mesh = make_mesh((1, 1), [resolve_device(device)])
        return mesh, mesh.first_device
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a psrsigsim_torch.parallel.Mesh "
                        f"(make_mesh), got {type(mesh).__name__}")
    if mesh.axis_names != (OBS_AXIS, CHAN_AXIS):
        raise ValueError(f"expected a mesh with axes {(OBS_AXIS, CHAN_AXIS)}"
                         f", got {mesh.axis_names}")
    first = mesh.first_device
    if device is not None and _as_device(device) != first:
        raise ValueError(
            f"device={device!r} conflicts with the mesh, whose results land "
            f"on its first device {first}; pass one or the other")
    return mesh, first


def check_chan_groups(nchan, n_chan_shards, backend):
    """The channel split's rule on the kernel path: the sampler kernel (and
    the fused kernel that draws its samples) keys a stream by (key, GLOBAL
    8-channel group, block), so a channel shard must start on a group
    boundary to draw the samples the whole band draws.  The threefry path
    keys each channel and needs no rule."""
    from ..ops.rng_hw import CHAN_GROUP

    if nchan % n_chan_shards:
        raise ValueError(f"Nchan={nchan} must be divisible by the chan mesh "
                         f"axis ({n_chan_shards})")
    per = nchan // n_chan_shards
    if backend == "hw" and n_chan_shards > 1 and per % CHAN_GROUP:
        raise ValueError(
            f"a chan shard of {per} channels starts inside an "
            f"{CHAN_GROUP}-channel group: the sampler kernel keys its stream "
            f"by (key, channel // {CHAN_GROUP}, block), so every chan shard "
            f"must hold a multiple of {CHAN_GROUP} channels (or draw with "
            "PSS_SAMPLER=threefry, keyed per channel)")


def cut_rows(rows, obs, chans, device):
    """One mesh position's part of a batch's scenario factors: its
    observations and (for the per-channel ones) its channels, on its
    device."""
    if rows is None:
        return None

    def cut(t, per_chan):
        if t is None:
            return None
        t = t[obs][:, chans] if per_chan else t[obs]
        return t.to(device)

    return type(rows)(cut(rows.gain, True), cut(rows.energy, False),
                      cut(rows.level, True), cut(rows.mask, True))


class MeshSlabs:
    """An entry point's per-channel inputs cut into its mesh's chan slabs,
    each staged once on each device that runs it: ``(profiles, freqs,
    chan_ids)`` of chan shard ``j`` on ``device``.  ``profiles`` and
    ``freqs`` are tensors whose channel axis follows ``lead`` leading axes
    (per-observation inputs when ``lead`` is 1, cut to each position's
    observations as well)."""

    def __init__(self, mesh, profiles, freqs, lead=0):
        self.mesh = mesh
        self._profiles = profiles
        self._freqs = freqs
        self._lead = lead
        self._staged = {}
        nchan = freqs.shape[lead]
        self.n_chan = mesh.shape[CHAN_AXIS]
        self.per = nchan // self.n_chan

    def chans(self, j):
        return slice(j * self.per, (j + 1) * self.per)

    def get(self, device, j):
        if (device, j) not in self._staged:
            c = (slice(None),) * self._lead + (self.chans(j),)
            self._staged[(device, j)] = (
                self._profiles[c].contiguous().to(device),
                self._freqs[c].contiguous().to(device),
                torch.arange(j * self.per, (j + 1) * self.per))
        return self._staged[(device, j)]

    def run(self, fn, keys, cols, rows, dims, device):
        """``fn(keys, cols, rows, profiles, freqs, chan_ids)`` at every mesh
        position of this process, one after the other, on its device: its
        part of the (padded) batch — ``keys`` cut where they lie, each of
        the per-observation ``cols`` cut and moved to its device (a numpy
        column only cut), the scenario ``rows`` (or None) cut to its
        observations and channels — and its slab of channels.  The outputs
        are assembled on ``device`` along ``dims`` (per output: the
        observation axis, the channel axis; :func:`gather_grid`); on a pod
        mesh the other processes' parts arrive through the pod exchange,
        checked against a digest of ``keys``."""
        n_obs, n_chan = self.mesh.devices.shape
        per = keys.shape[0] // n_obs
        grid = []
        for i in range(n_obs):
            obs = slice(i * per, (i + 1) * per)
            row = []
            for j in range(n_chan):
                if not self.mesh.is_local((i, j)):
                    row.append(None)
                    continue
                dev = self.mesh.devices[i, j]
                prof, freqs, chan_ids = self.get(dev, j)
                if self._lead:
                    prof, freqs = prof[obs], freqs[obs]
                with on_device(dev):
                    part = tuple(c[obs] if isinstance(c, np.ndarray)
                                 else c[obs].to(dev) for c in cols)
                    row.append(fn(keys[obs], part,
                                  cut_rows(rows, obs, self.chans(j), dev),
                                  prof, freqs, chan_ids))
            grid.append(row)
        tag = None
        if self.mesh.spans_processes:
            import hashlib

            tag = hashlib.sha256(
                keys.cpu().numpy().tobytes()).hexdigest()[:16]
        return gather_grid(grid, dims, device, tag=tag)


class Sharding(collections.namedtuple("Sharding", "mesh spec")):
    """How a tensor lies on a mesh: ``spec`` names the mesh axis each
    tensor axis is split over (None = whole), jax's ``PartitionSpec``."""


def batch_sharding(mesh, batch_ndim=1):
    """Sharding for ``(B, Nchan, Nsamp)`` ensemble blocks: observations
    over the obs axis, channels over the chan axis, time whole."""
    spec = [OBS_AXIS] + [None] * (batch_ndim - 1) + [CHAN_AXIS, None]
    return Sharding(mesh, tuple(spec[: batch_ndim + 2]))


def replicated_sharding(mesh):
    """Whole on every position (shared profiles and configurations)."""
    return Sharding(mesh, ())


def shard_batch(arr, mesh):
    """A host batch on the mesh, its leading axis split over ``obs``: one
    tensor per mesh position (row-major over the mesh), each on that
    position's device; a 0-d value is replicated."""
    t = torch.as_tensor(np.asarray(arr))
    n_obs = mesh.devices.shape[0]
    if t.dim() and t.shape[0] % n_obs:
        raise ValueError(f"batch {t.shape[0]} must be divisible by the obs "
                         f"axis ({n_obs})")
    out = []
    for pos in np.ndindex(mesh.devices.shape):
        part = t
        if t.dim():
            per = t.shape[0] // n_obs
            part = t[pos[0] * per:(pos[0] + 1) * per]
        out.append(part.to(mesh.devices[pos]))
    return out


def distributed_init(coordinator_address=None, num_processes=None,
                     process_id=None, **kw):
    """Multi-process setup (reference: ``jax.distributed.initialize``).  One
    process — the single-controller mesh — needs none, so this is a no-op
    for ``num_processes`` None or 1; more processes join the pod
    (:func:`psrsigsim_torch.runtime.dist.init_pod`, which takes the
    remaining keywords: ``channel_port``, ``timeout_s``), after which
    :func:`make_mesh` builds pod-wide meshes."""
    if num_processes in (None, 1):
        return None
    from ..runtime.dist import init_pod

    return init_pod(coordinator=coordinator_address,
                    num_processes=num_processes, process_id=process_id, **kw)
