"""Collectives over the shards of a single-controller mesh (no JAX
counterpart module: ``lax.all_to_all``, ``lax.ppermute`` and the gather a
jitted ``shard_map`` does on return).

A sharded tensor here is a Python list of per-shard tensors, in the order
of a mesh axis, each on its shard's device.  Every exchange is a
device-to-device copy, ``.to(dst, non_blocking=True)`` between cards:
PyTorch runs such a copy on the source's current stream and makes the
destination's current stream wait for it, so the consumer on the
destination is ordered after the producer on the source without a host
synchronisation (a copy to the host blocks); on a repeated device it is a
plain slice and ``cat``.
Nothing here special-cases "all shards on one device".
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["on_device", "all_to_all", "ppermute", "gather_grid"]


def on_device(device):
    """A context that makes ``device`` current for the launches inside it
    (CUDA); a no-op elsewhere."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _move(t, device):
    if t.device == device:
        return t
    # asynchronous only card to card: a copy to the host must have landed
    # when it returns
    return t.to(device, non_blocking=(t.device.type == device.type == "cuda"))


def all_to_all(parts, split_axis, concat_axis, devices):
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``
    over the shards ``parts`` (one per position of the axis, on
    ``devices``): shard ``j`` receives block ``j`` of every shard's
    ``split_axis`` (cut into ``len(parts)`` equal blocks), concatenated
    along ``concat_axis`` in shard order, on ``devices[j]``."""
    n = len(parts)
    if len(devices) != n:
        raise ValueError(f"{n} shards over {len(devices)} devices")
    size = parts[0].shape[split_axis]
    if size % n:
        raise ValueError(f"axis {split_axis} of size {size} does not split "
                         f"over {n} shards")
    blocks = [p.chunk(n, dim=split_axis) for p in parts]
    return [torch.cat([_move(blocks[i][j], devices[j]) for i in range(n)],
                      dim=concat_axis)
            for j in range(n)]


def ppermute(parts, perm, devices):
    """``lax.ppermute``: shard ``dst`` receives shard ``src``'s tensor for
    every ``(src, dst)`` pair of ``perm``, on ``devices[dst]``; a shard no
    pair sends to receives zeros."""
    out = [None] * len(parts)
    for src, dst in perm:
        out[dst] = _move(parts[src], devices[dst])
    for dst, t in enumerate(out):
        if t is None:
            out[dst] = torch.zeros_like(parts[dst], device=devices[dst])
    return out


def _pod_fill(grid, device, tag):
    """The cells of ``grid`` another pod process computed (None here),
    received through the pod exchange
    (:func:`psrsigsim_torch.runtime.dist.exchange`, the machinery of its
    ``device_get``): this process sends its own cells and every process
    ends with every cell, on ``device``."""
    from ..runtime.dist import exchange

    single = None
    local = {}
    for i, row in enumerate(grid):
        for j, cell in enumerate(row):
            if cell is None:
                continue
            single = isinstance(cell, torch.Tensor)
            local[(i, j)] = (cell,) if single else tuple(cell)
    full = exchange(local, tag=tag)
    out = []
    for i, row in enumerate(grid):
        new = []
        for j, cell in enumerate(row):
            if cell is None:
                got = tuple(torch.as_tensor(a).to(device)
                            for a in full[(i, j)])
                cell = got[0] if single else got
            new.append(cell)
        out.append(new)
    return out


def gather_grid(grid, dims, device, tag=None):
    """One tensor on ``device`` from a grid of shard outputs: ``grid[i][j]``
    is the output of mesh position ``(i, j)``, a tensor or a tuple of
    tensors; ``dims`` gives, per output, the axis the first mesh axis
    concatenates along and the axis the second does (None: the output is
    the same on every position of that axis, and the first is kept).  A
    None cell is another pod process's position: every process's cells
    are exchanged first (``tag`` checks the processes' lockstep)."""
    if any(cell is None for row in grid for cell in row):
        grid = _pod_fill(grid, device, tag)
    single = isinstance(grid[0][0], torch.Tensor)
    if single:
        grid = [[(t,) for t in row] for row in grid]
        dims = (dims,)
    out = []
    for k, (d0, d1) in enumerate(dims):
        rows = []
        for row in grid:
            pieces = [_move(cell[k], device) for cell in row]
            rows.append(pieces[0] if d1 is None or len(pieces) == 1
                        else torch.cat(pieces, dim=d1))
        out.append(rows[0] if d0 is None or len(rows) == 1
                   else torch.cat(rows, dim=d0))
    return out[0] if single else tuple(out)
