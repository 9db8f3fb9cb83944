"""Explicit PRNG key plumbing: jax's threefry2x32 keys, bit for bit.

The JAX package threads ``jax.random`` keys through every pipeline so an
ensemble is reproducible and sharding-invariant (counterpart:
psrsigsim_tpu/utils/rng.py).  The port keeps the same keys and the same
streams, so a seed draws the same realization in both packages:

* a key is the pair of 32-bit key-data words ``jax.random.key_data`` shows,
  held as an int64 tensor of shape ``(..., 2)`` whose values lie in
  ``[0, 2**32)``;
* :func:`key`, :func:`fold_in` and :func:`random_bits` follow jax's
  threefry implementation (``key`` = ``threefry_seed``, ``fold_in`` =
  ``threefry_2x32(key, threefry_seed(data))``, and the partitionable
  ``random_bits``: counts are the flat index split into (hi, lo) words and
  the bits are the XOR of the two output words);
* :func:`split` is jax's partitionable ``split`` (key ``i`` is the pair of
  threefry words of counter ``i``) and :func:`permutation` jax's
  ``random.permutation`` of ``arange(n)``: rounds of stable key-value sorts
  on fresh 32-bit sort keys;
* :func:`threefry2x32` runs where its operands lie: on the host in numpy
  ``uint32`` arrays, whose own wraparound does the modular arithmetic
  (about a hundred ufuncs a call, each a microsecond or two on a batch of
  keys), and on the card in int64 tensors with every 32-bit operation
  masked back to 32 bits.  Both give the same words; inside an open
  telemetry span each call is counted as ``rng.host_calls`` or
  ``rng.torch_calls``.

Two layers, as in the JAX package: :func:`stage_key` for the pipelines,
and :class:`KeySequence`, the stateful dispenser of the object-oriented
flow (``Pulsar.make_pulses``, ``Receiver.radiometer_noise``).  Its keys
live on the host; a draw moves the one key it needs to the data's device.
The only global state is :data:`default_keys`, the JAX package's
process-global sequence of the object-oriented flow.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.telemetry import count
from .device import resolve_device

__all__ = ["STAGES", "key", "as_key", "fold_in", "stage_key", "threefry2x32",
           "random_bits", "split", "randint", "permutation", "KeySequence",
           "default_keys", "set_seed", "next_key"]

MASK32 = 0xFFFFFFFF

# Stable stage identifiers, the same numbers as the JAX package's, so each
# pipeline stage draws the same independent stream in both packages.
STAGES = {
    "pulse": 0,
    "noise": 1,
    "null_select": 2,
    "null_noise": 3,
    "scint": 4,
    "user": 5,
    "prior": 6,
    "serve": 7,
    "rfi": 8,
    "transient": 9,
    "dataset": 10,
}

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

#: words a block of the host's rounds holds (four arrays of them stay in a
#: core's cache)
_HOST_BLOCK = 1 << 14


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & MASK32


def _threefry_torch(k0, k1, x0, x1):
    """The 20 rounds on uint32 words held in int64 tensors, masked after
    every add and rotate (the form that runs on the card)."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def _threefry_host(k0, k1, x0, x1):
    """The 20 rounds in numpy ``uint32`` arrays, in place: the operands are
    broadcast once and flattened, so every operation is an array's (a
    numpy scalar would warn where it wraps) and wraps by itself.  A long
    draw runs in blocks of :data:`_HOST_BLOCK` words that stay in the
    core's cache through all the rounds."""
    words = [v.numpy() if isinstance(v, torch.Tensor) else v
             for v in (k0, k1, x0, x1)]
    shape = np.broadcast(*words).shape
    k0, k1, x0, x1 = (_host_words(w, shape) for w in words)
    k2 = k0 ^ k1
    k2 ^= 0x1BD11BDA
    n = x0.size
    t = np.empty(min(n, _HOST_BLOCK), np.uint32)
    for lo in range(0, n, _HOST_BLOCK):
        b = slice(lo, lo + _HOST_BLOCK)
        _rounds_host(k0[b], k1[b], k2[b], x0[b], x1[b],
                     t[:min(n - lo, _HOST_BLOCK)])
    return (torch.from_numpy(x0.astype(np.int64).reshape(shape)),
            torch.from_numpy(x1.astype(np.int64).reshape(shape)))


def _host_words(w, shape):
    """``w`` broadcast to ``shape`` as a flat ``uint32`` array of its own
    (the values taken modulo 2**32)."""
    out = np.empty(shape, np.uint32)
    np.copyto(out, w, casting="unsafe")
    return out.reshape(-1)


def _rounds_host(k0, k1, k2, x0, x1, t):
    """Threefry's rounds on one block of words, in place in ``x0`` and
    ``x1`` (``t`` is scratch of the same size)."""
    ks = (k0, k1, k2)
    x0 += k0
    x1 += k1
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            np.right_shift(x1, 32 - r, out=t)
            x1 <<= r
            x1 |= t
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3]
        x1 += i + 1


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on uint32 words held in int64 tensors
    (broadcasting).  Returns the two output words, int64 tensors on the
    operands' device: operands on the host run in numpy ``uint32``
    arrays, operands on the card in int64 tensor operations."""
    if all(v.device.type == "cpu" for v in (k0, k1, x0, x1)
           if isinstance(v, torch.Tensor)):
        count("rng.host_calls")
        return _threefry_host(k0, k1, x0, x1)
    count("rng.torch_calls")
    return _threefry_torch(k0, k1, x0, x1)


def key(seed, device=None):
    """The key of an integer seed: ``jax.random.key(seed)``'s key data.

    The JAX package runs with 64-bit types off, so a seed is an int32 and
    its high word is 0.
    """
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise OverflowError(f"seed {seed} does not fit in int32")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64,
                        device=resolve_device(device))


def as_key(k, device=None):
    """A key from key-data words (a ``(..., 2)`` uint32 numpy array, as
    ``jax.random.key_data`` returns them, or a tensor already in the port's
    form)."""
    if isinstance(k, torch.Tensor):
        if k.shape[-1] != 2:
            raise ValueError(f"key data must end in 2 words, got {tuple(k.shape)}")
        return k.to(torch.int64) & MASK32
    arr = np.asarray(k)
    if arr.shape[-1:] != (2,):
        raise ValueError(f"key data must end in 2 words, got {arr.shape}")
    return torch.as_tensor(arr.astype(np.uint32).astype(np.int64),
                           device=resolve_device(device))


def fold_in(k, data):
    """``jax.random.fold_in``: a new key from ``k`` (``(..., 2)``) and an
    integer (or an integer tensor broadcastable against ``k[..., 0]``)."""
    if not isinstance(data, torch.Tensor):
        data = torch.full((), int(data), dtype=torch.int64, device=k.device)
    data = data.to(torch.int64) & MASK32
    o0, o1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def stage_key(root, stage, index=0):
    """The key for (stage, index) derived from ``root``: ``fold_in`` by the
    stage number, then by the index (the JAX package's ``stage_key``)."""
    sid = STAGES[stage] if isinstance(stage, str) else int(stage)
    return fold_in(fold_in(root, sid), index)


def random_bits(k, n, start=0):
    """``n`` 32-bit random words per key (``jax.random.bits`` in
    partitionable mode, flattened): ``(..., n)`` int64 for a ``(..., 2)``
    key.  ``start`` gives words ``start .. start+n-1`` of the same stream
    (the stream is the flat index, so a long draw can be made in spans)."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device=k.device)
    o0, o1 = threefry2x32(k[..., 0, None], k[..., 1, None],
                          idx >> 32, idx & MASK32)
    return o0 ^ o1


def split(k, num=2):
    """``jax.random.split(k, num)`` (partitionable threefry): ``(..., num,
    2)`` keys, key ``i`` being both threefry words of counter ``i``."""
    idx = torch.arange(num, dtype=torch.int64, device=k.device)
    o0, o1 = threefry2x32(k[..., 0, None], k[..., 1, None],
                          idx >> 32, idx & MASK32)
    return torch.stack((o0, o1), dim=-1)


def randint(k, n):
    """``jax.random.randint(k, (), 0, n)`` (int32, as the JAX package runs
    with 64-bit types off) for keys ``(..., 2)`` -> ``(...)`` int64 in
    ``[0, n)``.  jax splits the key, draws one 32-bit word from each half
    and reduces the 64-bit pair modulo ``n`` through ``2**32 mod n``."""
    n = int(n)
    if not 0 < n < 2**31:
        raise ValueError(f"randint needs 0 < n < 2**31, got {n}")
    halves = split(k)
    hi = random_bits(halves[..., 0, :], 1)[..., 0]
    lo = random_bits(halves[..., 1, :], 1)[..., 0]
    # jax's uint32 arithmetic, each product and sum wrapped to 32 bits
    mult = ((2**16 % n) ** 2 & MASK32) % n
    return ((((hi % n) * mult) & MASK32) + lo % n & MASK32) % n


def permutation(k, n):
    """``jax.random.permutation(k, n)``: a random order of ``arange(n)``
    (int64, on ``k``'s device), ``(..., n)`` for keys ``(..., 2)``.  jax's
    ``_shuffle``: ``ceil(3 ln n / ln(2**32 - 1))`` rounds, each splitting
    the key, drawing one 32-bit sort key per element and sorting stably by
    it."""
    n = int(n)
    x = torch.arange(n, dtype=torch.int64, device=k.device).expand(
        k.shape[:-1] + (n,))
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        k, sub = split(k).unbind(-2)
        order = torch.sort(random_bits(sub, n), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x


class KeySequence:
    """Stateful key dispenser for the object-oriented flow (the JAX
    package's ``KeySequence``): ``next`` splits the running key and derives
    the stage key from the new half, so casual users get fresh randomness
    per call and a seed reproduces the JAX package's draws.  Keys are
    created lazily and live on the host."""

    def __init__(self, seed=0):
        self._seed = seed
        self._key = None

    def seed(self, seed):
        self._seed = seed
        self._key = None

    def next(self, stage="user", index=0):
        if self._key is None:
            self._key = key(self._seed, device="cpu")
        self._key, sub = split(self._key)
        return stage_key(sub, stage, index)


default_keys = KeySequence(0)


def set_seed(seed):
    """Seed the global key sequence of the object-oriented flow (the role
    of ``numpy.random.seed`` in the reference's workflow)."""
    default_keys.seed(seed)


def next_key(stage="user", index=0):
    """The next key of the global sequence."""
    return default_keys.next(stage, index)
