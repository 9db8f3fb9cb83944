"""Monte-Carlo fold-mode ensembles on one device (counterpart:
psrsigsim_tpu/parallel/ensemble.py, ``FoldEnsemble``).

The BASELINE workload: thousands of fold-mode observations of one pulsar,
run a batch at a time, quantized to PSRFITS int16 with real DAT_SCL /
DAT_OFFS columns and packed into one buffer per chunk.  Where the reference
shards a vmapped program over an (obs, chan) mesh, the port runs a written-
out batch on one device.  Every random draw is keyed by (seed, global
observation index, stage, global channel), so results do not depend on the
chunking.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.quantize import quantize_packed
from ..simulate.pipeline import (build_fold_config, fold_pipeline,
                                 fold_pipeline_quantized, fused_route)
from ..utils.device import resolve_device, to_device
from ..utils.rng import key, stage_key

__all__ = ["FoldEnsemble"]


def _split_packed_chunk(packed, nbin):
    """Host-side inverse of the packing: one fetched ``(count, nsub, C,
    nbin+4)`` int16 buffer back into the ``(data, scl, offs)`` triple.
    ``data`` is a view into the buffer; the 8 tail bytes per (subint,
    channel) are made contiguous and reinterpreted as the two float32
    columns, bit-exactly as the device produced them."""
    packed = np.asarray(packed)
    data = packed[..., :nbin]
    tail = np.ascontiguousarray(packed[..., nbin:]).view(np.float32)
    return data, tail[..., 0], tail[..., 1]


def _fetch(t):
    """A device tensor as a host numpy array.  From the card the copy lands
    in pinned memory (PyTorch caches the pinned blocks between chunks),
    which crosses the link several times faster than a pageable copy."""
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.numpy()


class FoldEnsemble:
    """A fold-mode Monte-Carlo ensemble on one device.

    Build from configured signal/pulsar/telescope objects, then ``run``
    batches of observations with per-observation DMs and noise scales.

    Example
    -------
    >>> ens = FoldEnsemble(signal, pulsar, telescope, "Lband_GUPPI")
    >>> data, scl, offs = ens.run_quantized(128, seed=0)  # on the card
    """

    def __init__(self, signal, pulsar, telescope, system, Tsys=None,
                 device=None):
        self.device = resolve_device(device)
        cfg, profiles_np, noise_norm = build_fold_config(
            signal, pulsar, telescope, system, Tsys=Tsys)
        dm = float(signal.dm.value) if signal.dm is not None else 0.0
        self._stage(cfg, profiles_np, noise_norm, dm)

    @classmethod
    def from_config(cls, cfg, profiles, noise_norm, dm=0.0, device=None):
        """An ensemble over an already staged geometry (``cfg``, the
        ``(Nchan, Nph)`` portrait and the noise scale), e.g. one carried
        across from the JAX package by
        :func:`psrsigsim_torch.compat.config_from_reference`."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        if isinstance(profiles, torch.Tensor):
            profiles = profiles.detach().cpu().numpy()
        self._stage(cfg, profiles, noise_norm, dm)
        return self

    def _stage(self, cfg, profiles_np, noise_norm, dm):
        self.cfg = cfg
        self.noise_norm = float(noise_norm)
        self.dm = float(dm)
        dev = self.device
        self._profiles_np = np.ascontiguousarray(profiles_np, np.float32)
        self._profiles = torch.as_tensor(self._profiles_np, device=dev)
        self._freqs = torch.as_tensor(
            np.asarray(cfg.meta.dat_freq_mhz(), np.float32), device=dev)
        # global channel ids stay on the host: the sampler reads the first
        # one, and the threefry path copies them where its keys are
        self._chan_ids = torch.arange(cfg.meta.nchan)

    @staticmethod
    def _validate_per_obs(n_obs, dms, noise_norms):
        if dms is not None and np.shape(dms) != (n_obs,):
            raise ValueError(f"dms must have shape ({n_obs},)")
        if noise_norms is not None and np.shape(noise_norms) != (n_obs,):
            raise ValueError(f"noise_norms must have shape ({n_obs},)")

    def _prep_chunk(self, idx, seed, dms_full, norms_full):
        """Keys, DMs and noise scales for the global observation indices
        ``idx`` (reference: ``FoldEnsemble._prep_chunk``): key ``i`` is
        ``stage_key(key(seed), "user", i)``.  The keys are derived on the
        host (see :func:`~psrsigsim_torch.simulate.fold_pipeline`); DMs and
        noise scales go to the device."""
        dev = self.device
        idx = np.asarray(idx)
        keys = stage_key(key(seed, "cpu"), "user",
                         torch.as_tensor(idx, dtype=torch.int64))
        f32 = torch.float32
        dms = (torch.full(idx.shape, self.dm, dtype=f32, device=dev)
               if dms_full is None
               else to_device(torch.as_tensor(
                   np.asarray(dms_full, np.float32)[idx]), dev))
        norms = (torch.full(idx.shape, self.noise_norm, dtype=f32, device=dev)
                 if norms_full is None
                 else to_device(torch.as_tensor(
                     np.asarray(norms_full, np.float32)[idx]), dev))
        return keys, dms, norms

    def _blocks(self, keys, dms, norms):
        return fold_pipeline(keys, dms, norms, self._profiles, self.cfg,
                             freqs=self._freqs, chan_ids=self._chan_ids)

    def _quantized_packed(self, keys, dms, norms, byte_order):
        """One batch through the pipeline, the finite guard and the
        quantizer: ``(packed, finite)`` with ``packed`` ``(B, nsub, C,
        nbin+4)`` int16 and ``finite`` ``(B, C)`` bool (True where every
        sample was finite BEFORE quantization).

        On the card with the ``hw`` sampler in envelope mode this is one
        fused kernel (:func:`~psrsigsim_torch.simulate.fold_pipeline_quantized`);
        the threefry parity sampler, ``PSS_EXACT_SHIFT=1`` and the CPU run
        the unfused float body, quantizer and packing.  The route follows
        the configuration (:func:`~psrsigsim_torch.simulate.pipeline.fused_route`)."""
        if fused_route(self.cfg, self.device):
            return fold_pipeline_quantized(
                keys, dms, norms, self._profiles, self.cfg, freqs=self._freqs,
                chan_ids=self._chan_ids, byte_order=byte_order)
        return self._unfused_packed(keys, dms, norms, byte_order)

    def _unfused_packed(self, keys, dms, norms, byte_order):
        """The unfused body: float blocks, then the finite guard, the
        quantizer and the packing (:func:`.quantize.quantize_packed`)."""
        return quantize_packed(self._blocks(keys, dms, norms), self.cfg.nsub,
                               self.cfg.nph, byte_order)

    def _split_packed_device(self, packed):
        """Device-side inverse of :func:`.quantize.pack_triple` (slice +
        bitcast)."""
        nbin = self.cfg.nph
        data = packed[..., :nbin]
        scl = packed[..., nbin:nbin + 2].contiguous().view(torch.float32)[..., 0]
        offs = packed[..., nbin + 2:nbin + 4].contiguous().view(torch.float32)[..., 0]
        return data, scl, offs

    def run(self, n_obs, seed=0, dms=None, noise_norms=None):
        """Simulate ``n_obs`` observations: ``(n_obs, Nchan, Nsamp)``
        float32 on the ensemble's device."""
        self._validate_per_obs(n_obs, dms, noise_norms)
        keys, dms_t, norms_t = self._prep_chunk(np.arange(n_obs), seed, dms,
                                                noise_norms)
        return self._blocks(keys, dms_t, norms_t)

    def run_quantized(self, n_obs, seed=0, dms=None, noise_norms=None,
                      return_finite=False):
        """Simulate ``n_obs`` observations and quantize on the device to
        PSRFITS int16 subints.

        Returns ``(data, scl, offs)``: ``(n_obs, nsub, Nchan, nbin)`` int16
        (native byte order) plus ``(n_obs, nsub, Nchan)`` float32 scale and
        offset, with ``physical ≈ data * scl + offs``; with
        ``return_finite=True`` also the ``(n_obs, Nchan)`` finite guard.
        The triple is split from the same packed buffer :meth:`iter_chunks`
        transports, so both entry points give the same bytes.
        """
        self._validate_per_obs(n_obs, dms, noise_norms)
        keys, dms_t, norms_t = self._prep_chunk(np.arange(n_obs), seed, dms,
                                                noise_norms)
        packed, finite = self._quantized_packed(keys, dms_t, norms_t, "little")
        result = self._split_packed_device(packed)
        if return_finite:
            result = result + (finite,)
        return result

    def iter_chunks(self, n_obs, chunk_size=256, seed=0, dms=None,
                    noise_norms=None, quantized=False, byte_order="little",
                    finite_mask=False):
        """Stream a large ensemble in fixed-size chunks.

        Yields ``(start, block)`` with host numpy arrays for observations
        ``start..start+count``: ``block`` is ``(count, Nchan, Nsamp)``
        float32, or with ``quantized=True`` the ``(data, scl, offs)``
        triple (plus the ``(count, Nchan)`` finite mask when
        ``finite_mask``).  Every chunk runs at the full ``chunk_size``
        width (the tail wraps indices and is trimmed) and keys derive from
        GLOBAL observation indices, so draws equal :meth:`run`'s.

        ``byte_order="big"`` (quantized only) byte-swaps the codes on the
        device: ``data.view('>i2')`` then reads the true values, as the
        PSRFITS writer wants them.  Quantized chunks cross to the host as
        one packed buffer and are split there.
        """
        if byte_order not in ("little", "big"):
            raise ValueError("byte_order must be 'little' or 'big'")
        if finite_mask and not quantized:
            raise ValueError("finite_mask requires quantized=True")
        self._validate_per_obs(n_obs, dms, noise_norms)
        if chunk_size <= 0:
            raise ValueError("chunk_size must be positive")
        if n_obs <= 0:
            return
        chunk_size = min(chunk_size, n_obs)
        nbin = self.cfg.nph
        for start in range(0, n_obs, chunk_size):
            count = min(chunk_size, n_obs - start)
            idx = (start + np.arange(chunk_size)) % n_obs
            keys, dms_c, norms_c = self._prep_chunk(idx, seed, dms,
                                                    noise_norms)
            if quantized:
                packed, finite = self._quantized_packed(keys, dms_c, norms_c,
                                                        byte_order)
                data, scl, offs = _split_packed_chunk(_fetch(packed[:count]),
                                                      nbin)
                block = (data, scl, offs)
                if finite_mask:
                    block = block + (_fetch(finite[:count]),)
                # the device buffer is on the host now: free it before the
                # next chunk allocates its own
                del packed, finite
            else:
                block = _fetch(self._blocks(keys, dms_c, norms_c)[:count])
            yield start, block
