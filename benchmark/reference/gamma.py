"""Exact chi-square fields in plain PyTorch: ``2 * jax.random.gamma(key,
df / 2)`` over the blocked keys, as the JAX package draws a fold-mode
field whose df lies below 50 (other than 1).

Written from Marsaglia and Tsang, "A simple method for generating gamma
variables" (ACM TOMS 26(3), 2000), as ``jax.random.gamma`` runs it
(``jax/_src/random.py``, ``_gamma_impl`` and ``_gamma_one``):

* the row key is split into one key per element: element ``i``'s key is
  both words of ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``;
* ``key, subkey = split(key)`` (subkey only for alpha < 1, never here),
  then rejection passes of ``key, kx, ku = split(key, 3)``; an inner loop
  ``kx, k = split(kx)``, ``x = normal(k)``, ``v = 1 + x * c`` while
  ``v <= 0``; ``X = x * x``, ``V = v * v * v``, ``U = uniform(ku)``;
  accepted when ``U < 1 - 0.0331 * X * X`` or ``log U < X / 2 + d * ((1 -
  V) + log V)``; the draw is ``d * V``;
* ``d = alpha - 1/3`` and ``c = (1/3) / sqrt(d)`` are float32 constants of
  a static alpha, correctly rounded;
* ``normal(k)`` is ``sqrt(2) * erfinv(u)`` of jax's uniform on
  ``(nextafter(-1, 0), 1)`` from the 32 bits ``o0 ^ o1`` of
  ``threefry2x32(k, (0, 0))``; ``uniform(k)`` the same bits on ``[0, 1)``.

A field's keys are one per (global channel, global 4096-sample block),
``fold_in(fold_in(stage key, channel), block)`` (``keys.py``); whole
blocks are drawn and the span cut from them.

Departures from that description, each a rounding:

* ``torch.erfinv`` and ``torch.log`` in place of XLA's single-precision
  polynomials (tens of float32 ulps apart in the normal);
* no fused multiply-adds, where XLA contracts ``v = fma(x, c, 1)`` and the
  squeeze bound;
* so a decision that lies within rounding of its threshold can go the
  other way in the program, and the element's draw is then another one.
  Every decision is marginal when its two sides differ by less than
  :data:`MARGIN` of the terms' size; for each element whose first such
  decision would flip, :func:`field` gives the other draw too (the draw
  with that decision flipped and every later one the reference's own),
  so a comparison can take the outcome the program took there and only
  there (:func:`closest`).

Arithmetic after the bits runs in ``dtype`` (float32 for the reference;
the control passes a lower precision).  Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import fold as F
from . import keys as K

# plain float32 wherever a product could take TF32 on the card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BLOCK = 4096
# decisions whose sides differ by less than this share of the terms' size
# are marginal (rounding flipped decisions at shares up to 1.02e-7 over 21
# million draws against the program's arithmetic; a hundredfold room)
MARGIN = 1e-5
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))
_SQUEEZE = 0.0331


def constants(alpha):
    """``(d, c)`` as float32 numbers for a static ``alpha >= 1``."""
    a = np.float32(alpha)
    if not a >= 1.0:
        raise ValueError("the reference draws alpha >= 1 only (no boost)")
    d = np.float32(a - np.float32(1.0 / 3.0))
    c = np.float32(np.float32(1.0 / 3.0) / np.float32(np.sqrt(np.float64(d))))
    return float(d), float(c)


def _below_one(dtype):
    one = torch.ones((), dtype=dtype)
    return float(torch.nextafter(one, torch.zeros((), dtype=dtype)))


def _split(k0, k1, i):
    """Key ``i`` of ``split(key)``: both words of counter ``i``."""
    z = torch.zeros_like(k0)
    return K.threefry2x32(k0, k1, z, z + i)


def _bits(k0, k1):
    o0, o1 = _split(k0, k1, 0)
    return o0 ^ o1


def _unit(bits):
    """The top 23 bits as a float32 in [0, 1)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _trials(k0, k1, d, c, dtype, margins):
    """Marsaglia-Tsang passes from keys ``(k0, k1)`` (the key after the
    element split's ``split``) until every element accepts: ``V``
    (float32), and with ``margins`` the first marginal pass of each
    element: ``(marginal, accepted there, V there, key there)``."""
    n = k0.numel()
    dev = k0.device
    V = torch.empty(n, dtype=torch.float32, device=dev)
    marg = torch.zeros(n, dtype=torch.bool, device=dev)
    m_acc = torch.zeros(n, dtype=torch.bool, device=dev)
    m_V = torch.zeros(n, dtype=torch.float32, device=dev)
    m_k = torch.zeros((n, 2), dtype=torch.int64, device=dev)
    act = torch.arange(n, device=dev)
    k0, k1 = k0.clone(), k1.clone()
    while act.numel():
        a0, a1 = k0[act], k1[act]
        x0, x1 = _split(a0, a1, 1)
        x = torch.zeros(act.shape, dtype=dtype, device=dev)
        v = torch.full(act.shape, -1.0, dtype=dtype, device=dev)
        inner = torch.arange(act.numel(), device=dev)
        while inner.numel():
            b0, b1 = x0[inner], x1[inner]
            w0, w1 = _split(b0, b1, 1)
            u = _unit(_bits(w0, w1)) * 2.0 + _NORMAL_LO
            u = torch.clamp_min(u, _NORMAL_LO).to(dtype)
            # inside (-1, 1) in ``dtype`` too (a no-op in float32)
            u = torch.clamp(u, -_below_one(dtype), _below_one(dtype))
            xi = _SQRT2 * torch.erfinv(u)
            vi = 1.0 + xi * c
            x[inner], v[inner] = xi, vi
            again = vi <= 0.0
            inner = inner[again]
            x0[inner], x1[inner] = _split(b0[again], b1[again], 0)
        X = x * x
        Vn = (v * v) * v
        U = _unit(_bits(*_split(a0, a1, 2))).to(dtype)
        bound = 1.0 - _SQUEEZE * (X * X)
        logU = torch.log(U)
        logV = torch.log(Vn)
        rhs = X * 0.5 + d * ((1.0 - Vn) + logV)
        reject = (U >= bound) & (logU >= rhs)
        V[act] = Vn.to(torch.float32)
        if margins:
            size1 = 1.0 + _SQUEEZE * (X * X)
            size2 = (logU.abs() + X * 0.5
                     + d * ((1.0 - Vn).abs() + logV.abs()))
            near = (((U - bound).abs() < MARGIN * size1)
                    | ((logU - rhs).abs() < MARGIN * size2))
            first = near & ~marg[act]
            at = act[first]
            marg[at] = True
            m_acc[at] = ~reject[first]
            m_V[at] = Vn[first].to(torch.float32)
            m_k[at, 0], m_k[at, 1] = a0[first], a1[first]
        act = act[reject]
        k0[act], k1[act] = _split(a0[reject], a1[reject], 0)
    return V, (marg, m_acc, m_V, m_k)


@dataclasses.dataclass
class Field:
    """A chi-square field ``values`` ``(nchan, length)`` float32 and, for
    each element whose first marginal decision could flip, its flat index
    ``alt_at`` and the draw ``alt`` it has then."""

    values: torch.Tensor
    alt_at: torch.Tensor
    alt: torch.Tensor


def gamma_rows(keys, alpha, n, dtype=torch.float32):
    """``2 * jax.random.gamma(key, alpha, (n,))`` for keys ``(R, 2)``: a
    :class:`Field` of ``(R, n)``."""
    d, c = constants(alpha)
    R = keys.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    e0, e1 = K.threefry2x32(keys[:, 0, None], keys[:, 1, None], idx >> 32,
                            idx & K.MASK32)
    k0, k1 = _split(e0.reshape(-1), e1.reshape(-1), 0)
    V, (marg, m_acc, m_V, m_k) = _trials(k0, k1, d, c, dtype, True)
    # the other outcome of each element's first marginal decision: a
    # rejection taken as an acceptance keeps that pass's V; an acceptance
    # taken as a rejection goes on from the pass's next key
    at = marg.nonzero().reshape(-1)
    alt_V = m_V[at].clone()
    acc = m_acc[at]
    if bool(acc.any()):
        nk0, nk1 = _split(m_k[at[acc], 0], m_k[at[acc], 1], 0)
        alt_V[acc], _ = _trials(nk0, nk1, d, c, dtype, False)
    d_t = torch.full((), d, dtype=dtype, device=keys.device)

    def chi2(v):
        return ((d_t * v.to(dtype)) * 2.0).to(torch.float32)

    return Field(chi2(V).reshape(R, n), at, chi2(alt_V))


def field(stage_key, nchan, nsamp, df, dtype=torch.float32):
    """One observation's exact chi-square field ``(nchan, nsamp)`` of a
    stage key ``(2,)``: the blocked keys' rows, cut to the span."""
    nblk = -(-nsamp // BLOCK)
    ck = K.fold_in(stage_key[None, :], torch.arange(nchan,
                                                     device=stage_key.device))
    kb = K.fold_in(ck[:, None, :], torch.arange(nblk,
                                                 device=stage_key.device))
    g = gamma_rows(kb.reshape(-1, 2), np.float32(df) / np.float32(2.0),
                   BLOCK, dtype)
    flat = g.values.reshape(nchan, nblk * BLOCK)
    # flat index in the (nchan, nblk * BLOCK) draw -> in the cut span
    ch, t = g.alt_at // (nblk * BLOCK), g.alt_at % (nblk * BLOCK)
    keep = t < nsamp
    return Field(flat[:, :nsamp].contiguous(), (ch * nsamp + t)[keep],
                 g.alt[keep])


@dataclasses.dataclass
class Observation:
    """An observation's float block ``x`` ``(nchan, nsamp)`` and, per
    sample whose draws could flip, the other values it can take:
    ``alt_at`` (flat sample indices, repeated where a sample has several)
    and ``alt``."""

    x: torch.Tensor
    alt_at: torch.Tensor
    alt: torch.Tensor


def _fold_at(pulse, noise, prof, norm, nsamp, at, dtype):
    """``F.fold``'s arithmetic at flat samples ``at`` of an ``(nchan,
    nsamp)`` block, for the pulse and noise values there."""
    nph = prof.shape[-1]
    p = torch.as_tensor(prof, device=pulse.device).to(dtype)
    p = p[at // nsamp, (at % nsamp) % nph]
    n = torch.full((), float(np.float32(norm)), dtype=torch.float32,
                   device=pulse.device).to(dtype)
    return ((pulse.to(dtype) * p) + (noise.to(dtype) * n)).to(torch.float32)


def observation(geom, obs_key, device, dtype=torch.float32):
    """One observation's :class:`Observation`: the portrait shifted by the
    DM delays, times the exact pulse field, plus the exact noise field
    times the noise scale (``observations.observation`` with the fields
    of this module)."""
    delays = F.delays_ms(np.float32(geom.dm), geom.freqs, "cpu")
    prof = F.shift_portrait(geom.portrait, delays, geom.period_ms)
    df = float(np.float32(geom.nfold))
    obs_key = obs_key.to(device)
    pulse, noise = (field(K.stage_key(obs_key, s), geom.nchan, geom.nsamp,
                          df, dtype) for s in ("pulse", "noise"))
    x = F.fold(pulse.values, noise.values, prof, geom.norm, geom.nsub,
               geom.nph, dtype=dtype)
    pv, nv = pulse.values.reshape(-1), noise.values.reshape(-1)
    # a sample's other values: the pulse's other draw, the noise's, both
    ats, alts = [], []
    for at, p, n in ((pulse.alt_at, pulse.alt, nv[pulse.alt_at]),
                     (noise.alt_at, pv[noise.alt_at], noise.alt)):
        ats.append(at)
        alts.append(_fold_at(p, n, prof, geom.norm, geom.nsamp, at, dtype))
    both, pi, ni = np.intersect1d(pulse.alt_at.cpu().numpy(),
                                  noise.alt_at.cpu().numpy(),
                                  return_indices=True)
    if len(both):
        at = torch.as_tensor(both, device=x.device)
        ats.append(at)
        alts.append(_fold_at(pulse.alt[torch.as_tensor(pi, device=x.device)],
                             noise.alt[torch.as_tensor(ni, device=x.device)],
                             prof, geom.norm, geom.nsamp, at, dtype))
    return Observation(x, torch.cat(ats), torch.cat(alts))


def closest(obs, x_program, step):
    """``obs.x`` with each sample that has other values set to whichever
    of its values lies nearest ``x_program`` (the program's dequantized
    block, ``(nchan, nsamp)``), and the count of samples so set to a value
    more than ``step`` (one code step of the program's quantizer, the
    block's shape) from their own: the decisions the program took the
    other way."""
    x = obs.x.reshape(-1).cpu().clone()
    if not obs.alt_at.numel():
        return x.reshape(obs.x.shape), 0
    xp = x_program.reshape(-1).cpu().numpy()
    at = obs.alt_at.cpu().numpy()
    alt = obs.alt.cpu().numpy()
    mine = x.numpy()[at]
    own = np.abs(xp[at] - mine)
    gap = np.abs(xp[at] - alt)
    # per sample its nearest alternative, taken where it is nearer than
    # the sample's own value
    order = np.lexsort((gap, at))
    first = np.ones(len(order), bool)
    first[1:] = at[order][1:] != at[order][:-1]
    pick = order[first]
    pick = pick[gap[pick] < own[pick]]
    x[torch.as_tensor(at[pick])] = torch.as_tensor(alt[pick])
    far = np.abs(alt[pick] - mine[pick]) > step.reshape(-1).cpu().numpy()[
        at[pick]]
    return x.reshape(obs.x.shape), int(far.sum())
