"""Monte-Carlo fold-mode ensembles on one device or over an ``(obs,
chan)`` mesh (counterpart: psrsigsim_tpu/parallel/ensemble.py,
``FoldEnsemble`` and ``MultiPulsarFoldEnsemble``).

The BASELINE workload: thousands of fold-mode observations of one pulsar,
run a batch at a time, quantized to PSRFITS int16 with real DAT_SCL /
DAT_OFFS columns and packed into one buffer per chunk.  Where the reference
shards a vmapped program over an (obs, chan) mesh, the port runs a written-
out batch once per position of its mesh (``mesh=``, :func:`.mesh.make_mesh`;
None is a ``(1, 1)`` mesh on ``device``) — a sub-batch of observations × a
slab of channels on that position's device — assembled on the mesh's first
device.
Every random draw is keyed by (seed, global observation index, stage,
global channel), so results do not depend on the chunking or the mesh.
A scenario stack (``scenario=``, :mod:`psrsigsim_torch.scenarios`) adds
scintillation, RFI with its ground-truth mask and single-pulse energies,
drawn once per chunk on the host and carried into the fused kernel as
per-row factors.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops.quantize import quantize_packed
from ..ops.stats import CHI2_WH_MIN_DF, sampler_backend
from ..runtime.integrity import refuse_on_pod
from ..runtime.telemetry import span
from ..scenarios.registry import _param, parse_stack, scenario_rows
from ..simulate.pipeline import (_dispersion_delays, _fold_pipeline_hetero,
                                 _shifted_portrait, build_fold_config,
                                 fold_pipeline, fold_pipeline_quantized,
                                 fold_subints, fused_route, natural_nbin,
                                 noise_level)
from ..utils.device import resolve_device, to_device
from ..utils.rng import fold_in, key, stage_key
from .mesh import CHAN_AXIS, MeshSlabs, check_chan_groups, mesh_devices

__all__ = ["FoldEnsemble", "MultiPulsarFoldEnsemble", "build_width_bucket_fn"]


def build_width_bucket_fn(cfg, profiles, scenario=None, device=None):
    """The serving layer's width-bucketed batch entry (reference:
    ``build_width_bucket_fn``): a function

        fn(keys, dms, norms, null_fracs) -> (B, Nchan, Nph) float32

    that runs a batch of per-request inputs through :func:`fold_pipeline`
    (with each request's own ``null_frac``) and folds each observation to
    its pulse profile with :func:`fold_subints` — the sum over
    subintegrations added one subint after the other, so a row's bits never
    depend on the batch it was served in (the reference's ``.sum(axis=2)``
    is a reduction whose order may follow the batch size).

    ``keys``: ``(B, 2)`` uint32 key data (numpy) or a key tensor; the stage
    keys are derived where they lie.  ``dms``, ``norms``, ``null_fracs``:
    ``(B,)`` float32.  With a ``scenario`` stack
    (:class:`~psrsigsim_torch.scenarios.ScenarioStack`, the serving
    layer's ``"scenarios"`` geometry field) the function takes one more
    input,

        fn(keys, dms, norms, null_fracs, sc) -> (B, Nchan, Nph)

    the ``(B, n_params)`` parameter matrix ordered by
    ``scenario.param_names()``; its columns become the
    ``{name: (B,) tensor}`` parameters of :func:`fold_pipeline` (the
    factors are drawn on the host from the request keys, P13).

    The portrait and the channel frequencies are staged on ``device``
    (default: the CUDA card) once, here; the global channel ids stay on
    the host, where the sampler reads the first one.  Returns the tensor
    on that device.
    """
    if isinstance(profiles, torch.Tensor):
        prof = profiles.to(torch.float32)
    else:
        prof = torch.as_tensor(np.asarray(profiles, np.float32),
                               device=resolve_device(device))
    dev = prof.device
    freqs = torch.as_tensor(np.asarray(cfg.meta.dat_freq_mhz(), np.float32),
                            device=dev)
    chan_ids = torch.arange(cfg.meta.nchan)
    stack = parse_stack(scenario)
    names = stack.param_names() if stack is not None else ()

    def per_request(v):
        return to_device(torch.as_tensor(np.asarray(v, np.float32)), dev)

    def _batch(keys, dms, norms, null_fracs, sc=None):
        if (sc is None) != (stack is None):
            raise ValueError(
                "a scenario geometry takes the (B, n_params) parameter "
                "matrix sc; a scenario-free one takes none")
        params = None
        if stack is not None:
            sc = np.asarray(sc, np.float32)
            if sc.ndim != 2 or sc.shape[1] != len(names):
                raise ValueError(f"sc must be (B, {len(names)}) ordered by "
                                 f"{list(names)}, got shape {sc.shape}")
            params = {n: torch.from_numpy(np.ascontiguousarray(sc[:, i]))
                      for i, n in enumerate(names)}
        out = fold_pipeline(keys, per_request(dms), per_request(norms), prof,
                            cfg, freqs=freqs, chan_ids=chan_ids,
                            null_frac=per_request(null_fracs),
                            scenario=stack, scenario_params=params)
        return fold_subints(out, cfg.nsub, cfg.nph)

    return _batch


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


def _check_hetero_nfolds(nfolds):
    """The heterogeneous pipeline draws its χ² df (= Nfold per pulsar) per
    observation, through Wilson–Hilferty: refuse a population outside its
    validity domain when it is staged, unless ``PSS_EXACT_CHI2=1`` draws
    the exact gamma (reference: ``_check_hetero_nfolds``)."""
    import os

    if not os.environ.get("PSS_EXACT_CHI2") and np.min(nfolds) < CHI2_WH_MIN_DF:
        raise ValueError(
            f"heterogeneous ensemble has Nfold={float(np.min(nfolds)):.1f} "
            f"< {CHI2_WH_MIN_DF:.0f}: the traced-df chi2 draws use the "
            "Wilson-Hilferty approximation, only valid for large df. Use "
            "longer subintegrations, or export PSS_EXACT_CHI2=1 for the "
            "exact (slower) gamma sampler.")
    return nfolds


def _padded(idx, mesh):
    """``idx`` padded to the obs shards by tiling it modulo its length (the
    reference's rule: any pad works, even one longer than ``idx``)."""
    idx = np.asarray(idx)
    return idx[np.arange(mesh.padded(idx.shape[0])) % idx.shape[0]]


class FoldEnsemble:
    """A fold-mode Monte-Carlo ensemble on one device or over a mesh.

    Build from configured signal/pulsar/telescope objects, then ``run``
    batches of observations with per-observation DMs and noise scales.

    ``scenario``: optional list of scenario-effect labels (or a
    :class:`~psrsigsim_torch.scenarios.ScenarioStack`), e.g.
    ``["scintillation", "rfi", "single_pulse:frb"]``; every run then takes
    ``scenario_params={knob: scalar or (n_obs,) array}`` (registry
    defaults fill unset knobs).  ``None`` runs the scenario-free body,
    byte for byte as without the engine.

    ``mesh``: an ``(obs, chan)`` :class:`~psrsigsim_torch.parallel.Mesh`
    (:func:`~psrsigsim_torch.parallel.make_mesh`; devices may repeat).
    Observations split over ``obs`` (a batch pads to the obs shards by
    tiling its indices and is trimmed after), channels over ``chan``
    (``Nchan`` must divide; on the sampler kernel's path a chan shard must
    hold a multiple of 8 channels, the kernel's channel group).  Each
    position runs the one-device body on its device, one position after
    the other; results are assembled on the mesh's first device, which is
    the ensemble's ``device`` (a different ``device=`` raises).  The bytes
    equal the mesh-free run's.

    Example
    -------
    >>> ens = FoldEnsemble(signal, pulsar, telescope, "Lband_GUPPI")
    >>> data, scl, offs = ens.run_quantized(128, seed=0)  # on the card
    """

    def __init__(self, signal, pulsar, telescope, system, Tsys=None,
                 device=None, scenario=None, mesh=None):
        self.mesh, self.device = mesh_devices(mesh, device)
        cfg, profiles_np, noise_norm = build_fold_config(
            signal, pulsar, telescope, system, Tsys=Tsys)
        dm = float(signal.dm.value) if signal.dm is not None else 0.0
        self._stage(cfg, profiles_np, noise_norm, dm, scenario)
        # kept for metadata-only consumers (PSRFITS export);
        # build_fold_config above has already stamped nsub/nsamp/draw_norm
        # onto it
        self._signal = signal
        self._pulsar = pulsar

    @classmethod
    def from_config(cls, cfg, profiles, noise_norm, dm=0.0, device=None,
                    scenario=None, mesh=None):
        """An ensemble over an already staged geometry (``cfg``, the
        ``(Nchan, Nph)`` portrait and the noise scale), e.g. one carried
        across from the JAX package by
        :func:`psrsigsim_torch.compat.config_from_reference`."""
        self = cls.__new__(cls)
        self.mesh, self.device = mesh_devices(mesh, device)
        if isinstance(profiles, torch.Tensor):
            profiles = profiles.detach().cpu().numpy()
        self._stage(cfg, profiles, noise_norm, dm, scenario)
        self._signal = self._pulsar = None
        return self

    def _stage(self, cfg, profiles_np, noise_norm, dm, scenario):
        self.cfg = cfg
        self.scenario = parse_stack(scenario)
        self._has_rfi = (self.scenario is not None
                         and "rfi" in self.scenario.names())
        # SPK source the exporter barycenters with (None = the process-
        # global switch: analytic, or PSS_EPHEM); the Simulation slice
        # stamps it
        self.ephemeris_source = None
        self.noise_norm = float(noise_norm)
        self.dm = float(dm)
        dev = self.device
        self._profiles_np = np.ascontiguousarray(profiles_np, np.float32)
        self._profiles = torch.as_tensor(self._profiles_np, device=dev)
        self._freqs_np = np.asarray(cfg.meta.dat_freq_mhz(), np.float32)
        self._freqs = torch.as_tensor(self._freqs_np, device=dev)
        # global channel ids stay on the host: the sampler reads the first
        # one, and the threefry path copies them where its keys are
        self._chan_ids = torch.arange(cfg.meta.nchan)
        self._check_mesh()
        self._slabs = MeshSlabs(self.mesh, self._profiles, self._freqs)

    def _check_mesh(self):
        """``Nchan`` divides over the chan axis and, on the sampler kernel's
        path, every chan shard starts on an 8-channel group (checked when
        staged and before every meshed run: the sampler is chosen then)."""
        check_chan_groups(self.cfg.meta.nchan, self.mesh.shape[CHAN_AXIS],
                          sampler_backend(self.device))

    def _on_mesh(self, fn, keys, dms, norms, rows, dims):
        """``fn(keys, dms, norms, rows, profiles, freqs, chan_ids)`` at every
        mesh position (:meth:`.mesh.MeshSlabs.run`), assembled on the
        ensemble's device."""
        self._check_mesh()
        return self._slabs.run(
            lambda k, dn, r, p, f, c: fn(k, *dn, r, p, f, c),
            keys, (dms, norms), rows, dims, self.device)

    @staticmethod
    def _validate_per_obs(n_obs, dms, noise_norms):
        if dms is not None and np.shape(dms) != (n_obs,):
            raise ValueError(f"dms must have shape ({n_obs},)")
        if noise_norms is not None and np.shape(noise_norms) != (n_obs,):
            raise ValueError(f"noise_norms must have shape ({n_obs},)")

    def _validate_scenario_params(self, n_obs, scenario_params):
        """Every key must belong to the staged stack; per-observation
        arrays must be ``(n_obs,)`` (scalars broadcast)."""
        if self.scenario is None:
            if scenario_params:
                raise ValueError(
                    "scenario_params given but this ensemble was built "
                    "without a scenario stack; pass scenario=[...] to "
                    "FoldEnsemble")
            return
        self._check_scenario_names(scenario_params)
        for k, v in (scenario_params or {}).items():
            if np.ndim(v) not in (0, 1):
                raise ValueError(f"scenario parameter {k} must be a "
                                 "scalar or a (n_obs,) array")
            if np.ndim(v) == 1 and np.shape(v) != (n_obs,):
                raise ValueError(
                    f"scenario parameter {k} must have shape ({n_obs},), "
                    f"got {np.shape(v)}")

    def _check_scenario_names(self, scenario_params):
        names = self.scenario.param_names()
        unknown = sorted(set(scenario_params or {}) - set(names))
        if unknown:
            raise ValueError(
                f"unknown scenario parameter(s) {unknown}; stack "
                f"{self.scenario.labels()} takes {list(names)}")

    def _require_rfi(self, wanted, name):
        if wanted and not self._has_rfi:
            raise ValueError(
                f"{name} requires an ensemble built with an RFI scenario "
                "(FoldEnsemble(scenario=['rfi', ...]))")

    def _prep_scenario(self, idx, scenario_params):
        """The stack's parameters for the global observation indices
        ``idx``: ``{name: (len(idx),) float32 host tensor}``, registry
        defaults filling unset knobs; None for scenario-free builds."""
        if self.scenario is None:
            return None
        sp = dict(scenario_params or {})
        out = {}
        for name in self.scenario.param_names():
            v = sp.get(name, _param(name).default)
            if np.ndim(v) == 0:
                col = np.full(len(idx), float(v), np.float32)
            else:
                col = np.asarray(v, np.float32)[idx]
            out[name] = torch.from_numpy(col)
        return out

    def _rows(self, keys, norms, scp):
        """The batch's scenario factors (drawn once from its keys, where
        they land: the ensemble's device); None without a scenario."""
        if self.scenario is None:
            return None
        with span("scenario"):
            return scenario_rows(keys, self.scenario, scp, self.cfg,
                                 noise_level(self.cfg, norms),
                                 freqs=self._freqs_np,
                                 chan_ids=self._chan_ids)

    def _prep_chunk(self, idx, seed, dms_full, norms_full, fold_salt=None):
        """Keys, DMs and noise scales for the global observation indices
        ``idx`` (reference: ``FoldEnsemble._prep_chunk``): key ``i`` is
        ``stage_key(key(seed), "user", i)``.  The keys are derived on the
        host (see :func:`~psrsigsim_torch.simulate.fold_pipeline`); DMs and
        noise scales go to the device.

        ``fold_salt``: optional int folded into every observation's key
        AFTER that derivation, ``fold_in(stage_key(key(seed), "user", i),
        salt)`` — the fresh fold the run supervisor re-draws a
        NaN-quarantined observation with, leaving every other
        observation's stream alone (None is the main pass)."""
        dev = self.device
        idx = np.asarray(idx)
        with span("keys"):
            keys = stage_key(key(seed, "cpu"), "user",
                             torch.as_tensor(idx, dtype=torch.int64))
            if fold_salt is not None:
                keys = fold_in(keys, int(fold_salt))
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

    def _blocks(self, keys, dms, norms, rows=None):
        return self._on_mesh(
            lambda k, d, n, r, p, f, c: fold_pipeline(
                k, d, n, p, self.cfg, freqs=f, chan_ids=c, rows=r),
            keys, dms, norms, rows, (0, 1))

    def _quantized_packed(self, keys, dms, norms, byte_order, rows=None):
        """One batch through the pipeline, the finite guard and the
        quantizer: ``(packed, finite)`` with ``packed`` ``(B, nsub, C,
        nbin+4)`` int16 and ``finite`` ``(B, C)`` bool (True where every
        sample was finite BEFORE quantization).

        On the card with the ``hw`` sampler in envelope mode this is one
        fused kernel (:func:`~psrsigsim_torch.simulate.fold_pipeline_quantized`);
        the threefry parity sampler, ``PSS_EXACT_SHIFT=1`` and the CPU run
        the unfused float body, quantizer and packing.  The route follows
        the configuration (:func:`~psrsigsim_torch.simulate.pipeline.fused_route`);
        ``rows`` (:meth:`_rows`) carries a scenario's factors to either.
        Every mesh position runs its part so (the fused kernel with its
        first global channel, ``chan0``)."""
        if not fused_route(self.cfg, self.device):
            return self._unfused_packed(keys, dms, norms, byte_order, rows)
        return self._on_mesh(
            lambda k, d, n, r, p, f, c: fold_pipeline_quantized(
                k, d, n, p, self.cfg, freqs=f, chan_ids=c,
                byte_order=byte_order, rows=r),
            keys, dms, norms, rows, ((0, 2), (0, 1)))

    def _unfused_packed(self, keys, dms, norms, byte_order, rows=None):
        """The unfused body: float blocks, then the finite guard, the
        quantizer and the packing (:func:`.quantize.quantize_packed`),
        whose launches are timed as a child ``quantize`` of the span open
        on this thread (``dispatch.quantize`` under :meth:`iter_chunks`)."""
        blocks = self._blocks(keys, dms, norms, rows)
        with span("quantize"):
            return quantize_packed(blocks, self.cfg.nsub, self.cfg.nph,
                                   byte_order)

    def _split_packed_device(self, packed):
        """Device-side inverse of :func:`.quantize.pack_triple` (slice +
        bitcast)."""
        nbin = self.cfg.nph
        data = packed[..., :nbin]
        scl = packed[..., nbin:nbin + 2].contiguous().view(torch.float32)[..., 0]
        offs = packed[..., nbin + 2:nbin + 4].contiguous().view(torch.float32)[..., 0]
        return data, scl, offs

    def _prep_inputs(self, n_obs, seed, dms, noise_norms, scenario_params):
        """Keys, DMs, noise scales and scenario rows of observations
        ``0..n_obs-1``, padded to the mesh's obs shards (the caller trims
        to ``n_obs``)."""
        self._validate_per_obs(n_obs, dms, noise_norms)
        self._validate_scenario_params(n_obs, scenario_params)
        idx = _padded(np.arange(n_obs), self.mesh)
        keys, dms_t, norms_t = self._prep_chunk(idx, seed, dms, noise_norms)
        rows = self._rows(keys, norms_t,
                          self._prep_scenario(idx, scenario_params))
        return keys, dms_t, norms_t, rows

    def run(self, n_obs, seed=0, dms=None, noise_norms=None,
            scenario_params=None):
        """Simulate ``n_obs`` observations: ``(n_obs, Nchan, Nsamp)``
        float32 on the ensemble's device.  ``scenario_params`` (scenario
        builds only): ``{knob: scalar or (n_obs,) array}`` for the stack's
        parameters; unset knobs take registry defaults."""
        keys, dms_t, norms_t, rows = self._prep_inputs(
            n_obs, seed, dms, noise_norms, scenario_params)
        return self._blocks(keys, dms_t, norms_t, rows)[:n_obs]

    def run_quantized(self, n_obs, seed=0, dms=None, noise_norms=None,
                      return_finite=False, return_rfi=False,
                      scenario_params=None):
        """Simulate ``n_obs`` observations and quantize on the device to
        PSRFITS int16 subints.

        Returns ``(data, scl, offs)``: ``(n_obs, nsub, Nchan, nbin)`` int16
        (native byte order) plus ``(n_obs, nsub, Nchan)`` float32 scale and
        offset, with ``physical ≈ data * scl + offs``; with
        ``return_finite=True`` also the ``(n_obs, Nchan)`` finite guard.
        ``return_rfi=True`` (RFI scenario builds only) appends the
        ``(n_obs, Nchan, nsub)`` bool ground-truth contamination mask, from
        the same draws as the injection.  ``scenario_params`` as
        :meth:`run`.  The triple is split from the same packed buffer
        :meth:`iter_chunks` transports, so both entry points give the same
        bytes.
        """
        self._require_rfi(return_rfi, "return_rfi")
        keys, dms_t, norms_t, rows = self._prep_inputs(
            n_obs, seed, dms, noise_norms, scenario_params)
        packed, finite = self._quantized_packed(keys, dms_t, norms_t, "little",
                                                rows)
        result = self._split_packed_device(packed[:n_obs])
        if return_finite:
            result = result + (finite[:n_obs],)
        if return_rfi:
            result = result + (rows.mask[:n_obs],)
        return result

    def run_quantized_at(self, indices, seed=0, dms=None, noise_norms=None,
                         byte_order="little", fold_salt=None,
                         scenario_params=None, return_rfi=False, audit=False,
                         return_digest=False):
        """Quantize exactly the observations ``indices`` (global ids) in one
        launch — the run supervisor's quarantine/retry primitive and the
        integrity layer's re-execution.

        ``dms`` / ``noise_norms`` (and, on scenario builds, any
        per-observation ``scenario_params`` arrays) are the FULL
        per-observation arrays of the parent run (or None), indexed by the
        global ids, so a re-run observation sees exactly the inputs the main
        pass gave it.  ``fold_salt`` (see :meth:`_prep_chunk`): None
        reproduces the main pass bit for bit; an int folds a fresh stream
        for every listed observation — its scenario draws too, which key off
        the salted observation key as the JAX package's do.  ``byte_order``
        as :meth:`iter_chunks`.

        Returns ``(data, scl, offs, finite)`` on the ensemble's device,
        trimmed to ``len(indices)``, in the order given;
        ``return_rfi=True`` (RFI scenario builds only) appends the
        ground-truth mask of THIS run's realization (under ``fold_salt`` the
        fresh fold's); ``return_digest=True`` appends the ``(len(indices),)``
        per-observation digests of the packed buffer, computed on the
        device before any byte crosses the link (the packed-digest kernel,
        :func:`~psrsigsim_torch.runtime.integrity.device_packed_digest_rows`;
        int32 holding the uint32 bits).

        ``audit=True`` marks the integrity layer's duplicate execution.  The
        JAX package runs it through a freshly compiled instance of its
        program; the port has no compiled programs, and every call is an
        independent launch of the same deterministic kernel on the same
        inputs, so the audit takes the same path (DIVERGENCES.md P7).
        """
        if byte_order not in ("little", "big"):
            raise ValueError("byte_order must be 'little' or 'big'")
        self._require_rfi(return_rfi, "return_rfi")
        refuse_on_pod(audit or return_digest, "work",
                      pod=self.mesh.spans_processes)
        # names only: per-observation arrays here are the PARENT run's
        # full arrays (indexed by global ids), so their length is not
        # ours to check
        if scenario_params:
            if self.scenario is None:
                raise ValueError(
                    "scenario_params passed without a scenario stack "
                    "(build the ensemble with FoldEnsemble(scenario=[...]))")
            self._check_scenario_names(scenario_params)
        indices = np.asarray(indices, np.int64).reshape(-1)
        if indices.size == 0:
            raise ValueError("indices must be non-empty")
        n = indices.size
        # padded to the mesh's observation shards by tiling the indices
        # modulo their count, trimmed after (the reference's rule)
        idx = _padded(indices, self.mesh)
        keys, dms_c, norms_c = self._prep_chunk(idx, seed, dms, noise_norms,
                                                fold_salt=fold_salt)
        rows = self._rows(keys, norms_c,
                          self._prep_scenario(idx, scenario_params))
        packed, finite = self._quantized_packed(keys, dms_c, norms_c,
                                                byte_order, rows)
        packed = packed[:n]
        result = self._split_packed_device(packed) + (finite[:n],)
        if return_rfi:
            result = result + (rows.mask[:n],)
        if return_digest:
            from ..runtime.integrity import device_packed_digest_rows

            result = result + (device_packed_digest_rows(packed,
                                                         self.cfg.nph),)
        return result

    def iter_chunks(self, n_obs, chunk_size=256, seed=0, dms=None,
                    noise_norms=None, quantized=False, progress=None,
                    skip_chunk=None, prefetch=1, byte_order="little",
                    finite_mask=False, fetch_ahead=0, timers=None,
                    rfi_mask=False, scenario_params=None, integrity=None):
        """Stream a large ensemble in fixed-size chunks.

        Yields ``(start, block)`` with host numpy arrays for observations
        ``start..start+count``: ``block`` is ``(count, Nchan, Nsamp)``
        float32, or with ``quantized=True`` the ``(data, scl, offs)``
        triple (plus the ``(count, Nchan)`` finite mask when
        ``finite_mask``).  Every chunk runs at the full ``chunk_size``
        width (the tail wraps indices and is trimmed) and keys derive from
        GLOBAL observation indices, so draws equal :meth:`run`'s.  None of
        the options below changes a yielded byte.

        ``byte_order="big"`` (quantized only) byte-swaps the codes on the
        device: ``data.view('>i2')`` then reads the true values, as the
        PSRFITS writer wants them.  Quantized chunks cross to the host as
        one packed buffer and are split there.

        ``progress``: optional callable ``progress(done, total)`` invoked
        after each chunk, skipped ones included, with a monotonic ``done``
        (e.g. :class:`psrsigsim_torch.utils.progress.ConsoleProgress`).

        ``skip_chunk``: optional predicate ``skip_chunk(start, count)``;
        when it returns True the chunk's device work is skipped entirely
        and nothing is yielded for it.  This is how a resuming exporter
        avoids re-simulating finished work.

        ``prefetch``: how many chunks the device may run ahead of the one
        being fetched (default 1).  Launches are asynchronous, so with
        ``prefetch >= 1`` the card computes chunk N+1 while chunk N
        crosses the link and while the consumer writes files.  Each chunk
        in flight holds its output buffer on the device; ``prefetch=0``
        with ``fetch_ahead=0`` is strictly serial.

        ``fetch_ahead``: with ``fetch_ahead >= 1`` the device→host copies
        move to a dedicated fetch thread feeding a bounded queue of at
        most ``fetch_ahead`` fetched chunks, so the link and the card stay
        busy while the consumer encodes and writes the previous chunk.  Host memory
        is bounded by ``fetch_ahead + 2`` chunks; the order is unchanged
        (one thread, FIFO).  An error in the thread is raised in the
        consumer; abandoning the generator stops the thread.
        ``fetch_ahead=0`` fetches inline.

        ``timers``: optional
        :class:`~psrsigsim_torch.runtime.telemetry.StageTimers` — per
        chunk ``dispatch`` and ``fetch`` times, fetched bytes, the
        fetch-queue depth and the live device bytes accumulate there.

        ``rfi_mask`` (RFI scenario builds only): append the ``(count,
        Nchan, nsub)`` ground-truth RFI mask to each yielded tuple (after
        the finite mask when both are requested; a float chunk is then
        ``(block, mask)``), from the same draws as the injection — what
        the supervised exporter journals as scenario provenance.
        ``scenario_params`` as :meth:`run`.

        ``integrity`` (quantized only): an armed
        :class:`~psrsigsim_torch.runtime.IntegrityChecker` — each chunk's
        yielded tuple grows a LAST element, the ``(count,)`` uint32
        per-observation digests of the packed buffer, computed on the
        device by the packed-digest kernel before the copy
        (:func:`~psrsigsim_torch.runtime.integrity.device_packed_digest_rows`),
        so the consumer can re-check the fetched bytes against a
        device-attested claim.  The checker's ``device.sdc`` arm perturbs
        the device buffer here, BEFORE the digest — corruption the lattice
        cannot see and only the duplicate-execution audit catches.  None
        (the default) changes nothing: the digest kernel never runs.

        On the card every copy runs on a copy stream of its own, after an
        event recorded behind the chunk's launches on the compute stream
        (else chunk N's copy would queue behind chunk N+1's kernel), into
        pinned host memory; the yielded arrays are views of it and stay
        valid while the consumer holds them.
        """
        import time as _time

        if byte_order not in ("little", "big"):
            raise ValueError("byte_order must be 'little' or 'big'")
        if finite_mask and not quantized:
            raise ValueError("finite_mask requires quantized=True")
        if integrity is not None and not quantized:
            raise ValueError("integrity requires quantized=True (the "
                             "checksum lattice rides the packed transport)")
        refuse_on_pod(integrity is not None, "work",
                      pod=self.mesh.spans_processes)
        self._require_rfi(rfi_mask, "rfi_mask")
        self._validate_per_obs(n_obs, dms, noise_norms)
        self._validate_scenario_params(n_obs, scenario_params)
        if chunk_size <= 0:
            raise ValueError("chunk_size must be positive")
        if prefetch < 0:
            raise ValueError("prefetch must be >= 0")
        if fetch_ahead < 0:
            raise ValueError("fetch_ahead must be >= 0")
        if n_obs <= 0:
            return
        chunk_size = min(chunk_size, n_obs)
        # every chunk pads to the mesh's obs shards (the reference's rule)
        chunk_size = self.mesh.padded(chunk_size)
        nbin = self.cfg.nph
        cuda = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if cuda else None

        def _span(stage, start):
            return (timers.span(stage, chunk=start) if timers is not None
                    else contextlib.nullcontext())

        def _dispatch(start, count):
            """Launch one chunk: its device tensors, trimmed to ``count``
            observations, and the event that marks them complete.  A
            quantized chunk also gathers its DAT_SCL/DAT_OFFS halves into
            one small contiguous tensor on the device, so the host split is
            a view instead of a gather over the whole buffer."""
            with _span("dispatch", start):
                idx = (start + np.arange(chunk_size)) % n_obs
                keys, dms_c, norms_c = self._prep_chunk(idx, seed, dms,
                                                        noise_norms)
                rows = self._rows(keys, norms_c,
                                  self._prep_scenario(idx, scenario_params))
                if quantized:
                    packed, finite = self._quantized_packed(
                        keys, dms_c, norms_c, byte_order, rows)
                    if integrity is not None:
                        # device.sdc arm: perturb the device buffer BEFORE
                        # the digest attests it (tests only; a None plan is
                        # a no-op) — silent device corruption carries a
                        # self-consistent digest
                        packed = integrity.apply_sdc(packed, ident=start)
                    dev = (packed[:count],
                           packed[:count, ..., nbin:].contiguous())
                    if finite_mask:
                        dev = dev + (finite[:count],)
                    if rfi_mask:
                        dev = dev + (rows.mask[:count],)
                    if integrity is not None:
                        from ..runtime.integrity import \
                            device_packed_digest_rows

                        # launched on the compute stream before the ready
                        # event below is recorded, so the copy stream waits
                        # for it
                        dev = dev + (device_packed_digest_rows(
                            packed, nbin, count=count),)
                else:
                    dev = (self._blocks(keys, dms_c, norms_c, rows)[:count],)
                    if rfi_mask:
                        dev = dev + (rows.mask[:count],)
                ready = None
                if cuda:
                    ready = torch.cuda.Event()
                    ready.record()
            if timers is not None:
                timers.track_live(dev)
            return {"start": start, "dev": dev, "ready": ready, "copy": None,
                    "s": 0.0}

        def _start_fetch(chunk):
            """Queue the chunk's device→host copies on the copy stream,
            behind its ready event, into pinned memory; idempotent."""
            if not cuda or chunk["copy"] is not None:
                return
            t0 = _time.perf_counter()
            # the current stream is per thread: the copy stream is entered
            # here, whichever thread fetches
            with torch.cuda.stream(copy_stream):
                copy_stream.wait_event(chunk["ready"])
                pinned, pin_ns = [], 0
                for t in chunk["dev"]:
                    p0 = _time.perf_counter_ns()
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    pin_ns += _time.perf_counter_ns() - p0
                    # the allocator must not hand this memory to a later
                    # chunk while the copy still reads it
                    t.record_stream(copy_stream)
                    h.copy_(t, non_blocking=True)
                    pinned.append(h)
                done = torch.cuda.Event()
                done.record(copy_stream)
            chunk["copy"] = (pinned, done)
            chunk["s"] += _time.perf_counter() - t0
            if timers is not None:
                timers.add("fetch.pin", pin_ns / 1e9)

        def _fetch(chunk):
            """The chunk as host numpy arrays (the copies started if they
            were not)."""
            _start_fetch(chunk)
            t0 = _time.perf_counter()
            if cuda:
                pinned, done = chunk["copy"]
                with _span("fetch.wait", chunk["start"]):
                    done.synchronize()
                host = [h.numpy() for h in pinned]
            else:
                host = [t.numpy() for t in chunk["dev"]]
            if quantized:
                tail = host[1].view(np.float32)
                block = (host[0][..., :nbin], tail[..., 0],
                         tail[..., 1]) + tuple(host[2:])
                if integrity is not None:
                    block = block[:-1] + (block[-1].view(np.uint32),)
            else:
                block = host[0] if len(host) == 1 else tuple(host)
            if timers is not None:
                timers.untrack_live(chunk["dev"])
                timers.add("fetch", chunk["s"] + _time.perf_counter() - t0,
                           nbytes=sum(a.nbytes for a in host))
            return block

        done_max = 0

        def _report(done):
            # skipped chunks can run ahead of in-flight ones; keep the
            # user-visible counter monotonic
            nonlocal done_max
            done_max = max(done_max, min(done, n_obs))
            if progress is not None:
                progress(done_max, n_obs)

        if fetch_ahead <= 0:
            # inline fetch: dispatch-ahead overlap only.  The oldest
            # chunk's copy is queued before the next chunk is launched, so
            # it crosses the link while the host stages the next one
            inflight = []  # [(start, dispatched chunk)]
            for start in range(0, n_obs, chunk_size):
                count = min(chunk_size, n_obs - start)
                if skip_chunk is not None and skip_chunk(start, count):
                    _report(start + count)
                    continue
                if inflight and len(inflight) >= prefetch:
                    _start_fetch(inflight[0][1])
                inflight.append((start, _dispatch(start, count)))
                if len(inflight) > prefetch:
                    s0, item = inflight.pop(0)
                    block = _fetch(item)
                    del item
                    _report(s0 + chunk_size)
                    yield s0, block
            while inflight:
                s0, item = inflight.pop(0)
                block = _fetch(item)
                del item
                _report(s0 + chunk_size)
                yield s0, block
            return

        # -- threaded fetch -------------------------------------------------
        # main thread: dispatch + yield; fetch thread: the copies + host
        # split.  ``slots`` bounds the chunks on the device whose copy has
        # not finished (the one being fetched plus ``prefetch``); the main
        # thread launches whenever one is free, before it waits for the
        # next fetched chunk, so chunk N+1's host staging and kernel run
        # while chunk N crosses the link.  Teardown (the end, an error, or
        # the consumer abandoning us mid-stream) sets ``stop`` and puts a
        # ``None`` into the unbounded ``in_q``, which wakes the thread at
        # once; the bounded ``out_q`` is polled with a short timeout, so a
        # thread blocked on a full queue also sees ``stop``.
        import queue as _queue
        import threading as _threading
        from collections import deque as _deque

        in_q = _queue.Queue()                         # dispatched
        out_q = _queue.Queue(maxsize=fetch_ahead)     # fetched
        slots = _threading.Semaphore(prefetch + 1)
        stop = _threading.Event()

        def _fetcher():
            while True:
                got = in_q.get()
                if got is None or stop.is_set():
                    return
                start, item = got
                try:
                    res = ("ok", start, _fetch(item))
                except BaseException as err:  # noqa: BLE001 — re-raised
                    res = ("error", err, None)  # in the consumer thread
                # the copy is done and the device buffer dropped: a slot
                # frees before the chunk is handed over
                del item
                slots.release()
                while not stop.is_set():
                    try:
                        out_q.put(res, timeout=0.05)
                        break
                    except _queue.Full:
                        continue
                if res[0] == "error":
                    return

        thread = _threading.Thread(target=_fetcher, daemon=True,
                                   name="pss-chunk-fetch")
        thread.start()
        pending = _deque((start, min(chunk_size, n_obs - start))
                         for start in range(0, n_obs, chunk_size))
        dispatched = received = 0
        try:
            while pending or received < dispatched:
                # every received chunk released its slot, so with nothing
                # outstanding a slot is always free and this never stalls
                while pending and slots.acquire(blocking=False):
                    s0, count = pending.popleft()
                    if skip_chunk is not None and skip_chunk(s0, count):
                        slots.release()
                        _report(s0 + count)
                        continue
                    in_q.put((s0, _dispatch(s0, count)))
                    dispatched += 1
                if received >= dispatched:
                    continue  # everything so far was skipped
                if timers is not None:
                    timers.depth("fetch_queue", out_q.qsize())
                kind, a, b = out_q.get()
                if kind == "error":
                    raise a
                received += 1
                _report(a + chunk_size)
                yield a, b
        finally:
            stop.set()
            in_q.put(None)
            thread.join(timeout=10.0)

    def to_mc_study(self, priors, seed=0, **kw):
        """Bridge to the Monte-Carlo study engine: a
        :class:`~psrsigsim_torch.mc.MonteCarloStudy` over THIS ensemble's
        configuration (same cfg/portrait/noise norm, same device).

        Trial keys equal this ensemble's observation keys — study trial
        ``i`` with priors over dm/noise draws the same pulse and noise
        streams as ``run(n_obs, seed)``'s observation ``i`` — so a study
        and a dataset export of the same seed describe the same
        observations (``priors``: :data:`psrsigsim_torch.mc.KNOBS`).
        """
        from ..mc import MonteCarloStudy

        kw.setdefault("device", self.device)
        kw.setdefault("mesh", self.mesh)
        return MonteCarloStudy(self.cfg, self._profiles_np, self.noise_norm,
                               priors, seed=seed, dm=self.dm, **kw)

    def folded_profiles(self, data):
        """Per-observation folded pulse profiles ``(B, Nchan, Nph)`` of an
        ensemble block ``(B, Nchan, Nsamp)`` (the sum over subints, in a
        fixed order: the study's fold) — the standard data product."""
        return fold_subints(data, self.cfg.nsub, self.cfg.nph)

    def signal_shell(self):
        """The configured signal object (metadata only — no ensemble data
        lives on it), or None for an ensemble made with
        :meth:`from_config`.  The PSRFITS bulk exporter
        (:func:`psrsigsim_torch.io.export_ensemble_psrfits`) takes its
        file metadata from it."""
        return self._signal

    @property
    def pulsar(self):
        return self._pulsar


class MultiPulsarFoldEnsemble:
    """A fold-mode Monte-Carlo ensemble over MANY pulsars with different
    portraits, periods, DMs and noise levels, on one device — BASELINE
    config 5 (reference: ``MultiPulsarFoldEnsemble``; per-observation
    semantics pulsar/pulsar.py:196-221).

    Pulsars are bucketed by the static geometry ``(Nchan, Nph, nsub)``;
    within a bucket every pulsar-specific quantity (portrait, DM, χ² df
    ``nfold``, draw norm, noise norm, channel frequencies, sample spacing)
    is a per-observation input of
    :func:`~psrsigsim_torch.simulate.fold_pipeline_hetero`, so one body
    runs the whole bucket: per bucket and epoch chunk, one sampler launch
    draws the pulse field and one the noise field of all its pulsars
    (``chi2_sel`` mode, a df per row).  With ``pad_nbin`` in
    :meth:`from_simulations`, distinct periods land on a common phase
    resolution and differ only in the sample spacing.

    Keys are ``fold_in(stage_key(key(seed), "user", p), e)`` for the
    global pulsar index ``p`` and the global epoch ``e``, so a pulsar's
    rows do not depend on its bucket, the epoch chunking or how a run is
    split over ``epoch_start``.

    Parameters
    ----------
    workloads : list of (cfg, profiles, noise_norm, dm)
        One entry per pulsar, as :func:`~psrsigsim_torch.simulate.
        build_fold_config` gives them plus that pulsar's DM
        (:meth:`from_simulations` builds them from ``Simulation`` objects).
    mesh : an ``(obs, chan)`` :class:`~psrsigsim_torch.parallel.Mesh`,
        optional: pulsars split over ``obs`` (a bucket pads to the obs
        shards by tiling its pulsars), channels over ``chan`` (as
        :class:`FoldEnsemble`'s; the results live on the mesh's first
        device, a different ``device`` raises).  Changes no draw.
    epoch_chunk : epochs per pass through the pipeline (bounds the working
        set; None = all epochs of a run at once).  Changes no draw.
    device : where the ensemble runs (default: the CUDA card).
    """

    def __init__(self, workloads, mesh=None, epoch_chunk=None, device=None):
        self.mesh, self.device = mesh_devices(mesh, device)
        self.workloads = list(workloads)
        self.epoch_chunk = epoch_chunk
        n_chan = self.mesh.shape[CHAN_AXIS]
        self._buckets = {}  # static geometry -> list of pulsar indices
        for idx, (cfg, _, _, _) in enumerate(self.workloads):
            if cfg.meta.nchan % n_chan:
                raise ValueError(
                    f"pulsar {idx}: Nchan={cfg.meta.nchan} must be divisible "
                    f"by the chan mesh axis ({n_chan})")
            bkey = (cfg.meta.nchan, cfg.nph, cfg.nsub)
            self._buckets.setdefault(bkey, []).append(idx)
        self._bucket_data = {}  # bucket key -> staged device inputs

    @staticmethod
    def choose_nbin(nph_natural, pad_nbin):
        """A pulsar's padded phase resolution (reference:
        ``choose_nbin``): ``"pow2"`` (the next power of two >= the natural
        ``int(samprate * period)``), an int (one common NBIN), or a grid of
        ceilings (the smallest >= natural; the largest when the natural
        resolution exceeds them all)."""
        if isinstance(pad_nbin, str):
            if pad_nbin == "pow2":
                return 1 << max(0, int(np.ceil(np.log2(max(1, nph_natural)))))
            raise ValueError(
                f"pad_nbin={pad_nbin!r}: the only string mode is 'pow2' "
                "(pass an int or a grid of ceilings otherwise)")
        if isinstance(pad_nbin, (int, np.integer)):
            return int(pad_nbin)
        grid = sorted(int(g) for g in pad_nbin)
        if not grid:
            raise ValueError("pad_nbin grid is empty")
        for g in grid:
            if g >= nph_natural:
                return g
        return grid[-1]

    @classmethod
    def from_simulations(cls, sims, mesh=None, pad_nbin=None,
                         epoch_chunk=None, device=None):
        """Build from configured ``Simulation`` objects (one per pulsar):
        ``init_all`` + ``build_fold_config`` on each.  ``pad_nbin``: see
        :meth:`choose_nbin` (None keeps every natural resolution).
        ``device``: default the first simulation's."""
        workloads = []
        for s in sims:
            s.init_all()
            nbin = None
            if pad_nbin is not None:
                nbin = cls.choose_nbin(natural_nbin(s.signal, s.pulsar),
                                       pad_nbin)
            cfg, profiles, noise_norm = build_fold_config(
                s.signal, s.pulsar, s.tscope, s.system_name, nbin=nbin)
            dm = float(s.signal.dm.value) if s.signal.dm is not None else 0.0
            workloads.append((cfg, profiles, noise_norm, dm))
        if device is None and sims:
            device = sims[0]._device
        return cls(workloads, mesh=mesh, epoch_chunk=epoch_chunk,
                   device=device)

    @property
    def n_buckets(self):
        return len(self._buckets)

    def _staged(self, bkey, members):
        """A bucket's per-pulsar inputs on the device, staged once and
        reused by every run (only the keys change): its pulsar list padded
        to the obs shards (tiled), in envelope mode each portrait shifted
        by its pulsar's delays (``shifted``; ``profiles`` keeps the
        portraits as given), the per-channel inputs cut into the mesh's
        chan slabs."""
        if bkey in self._bucket_data:
            return self._bucket_data[bkey]
        dev = self.device
        members = list(_padded(members, self.mesh))
        w = [self.workloads[i] for i in members]

        def col(values):
            return torch.as_tensor(np.asarray(values, np.float32), device=dev)

        nfolds = _check_hetero_nfolds(
            np.asarray([c.nfold for c, _, _, _ in w], np.float32))
        staged = dict(
            members=torch.as_tensor(members, dtype=torch.int64),
            dms=col([d for _, _, _, d in w])[:, None],
            norms=col([n for _, _, n, _ in w])[:, None],
            nfolds=col(nfolds)[:, None],
            draw_norms=col([c.draw_norm for c, _, _, _ in w])[:, None],
            dts=col([c.dt_ms for c, _, _, _ in w])[:, None],
            profiles=col(np.stack([np.asarray(p, np.float32)
                                   for _, p, _, _ in w]))[:, None],
            freqs=col(np.stack([np.asarray(c.meta.dat_freq_mhz(), np.float32)
                                for c, _, _, _ in w]))[:, None],
            shifted=None,
        )
        portraits = staged["profiles"]
        if w[0][0].shift_mode == "envelope":
            # a pulsar's shifted portrait depends on nothing a run draws:
            # shifted here once, for every run, as the front would shift it
            staged["shifted"] = portraits = _shifted_portrait(
                portraits,
                _dispersion_delays(staged["dms"], staged["freqs"], None),
                staged["dts"][..., None, None])
        staged["slabs"] = MeshSlabs(self.mesh, portraits[:, 0],
                                    staged["freqs"][:, 0], lead=1)
        self._bucket_data[bkey] = staged
        return staged

    def _run_mesh(self, st, keys, cfg0):
        """One bucket's epoch chunk: each mesh position runs its pulsars ×
        its channels on its device; ``(P, E, Nchan, Nsamp)`` on the
        ensemble's device."""
        check_chan_groups(cfg0.meta.nchan, self.mesh.shape[CHAN_AXIS],
                          sampler_backend(self.device))

        def one(k, cols, r, prof, freqs, chan_ids):
            dms, norms, nfolds, draw_norms, dts = cols
            return _fold_pipeline_hetero(
                k, dms, norms, nfolds, draw_norms, prof[:, None], cfg0,
                freqs[:, None], chan_ids, None, dts, prof.device,
                shifted=st["shifted"] is not None)

        cols = tuple(st[k] for k in ("dms", "norms", "nfolds", "draw_norms",
                                     "dts"))
        return st["slabs"].run(one, keys, cols, None, (0, 2), self.device)

    def run(self, epochs, seed=0, epoch_start=0):
        """Simulate ``epochs`` observations of every pulsar.

        Returns a list (indexed like ``workloads``) of ``(epochs, Nchan,
        nsub*Nph)`` float32 tensors on the ensemble's device (views into one
        block per bucket).  ``run(E1, seed)`` then ``run(E2, seed,
        epoch_start=E1)`` draws exactly what ``run(E1 + E2, seed)`` does.
        """
        epochs = int(epochs)
        if epochs <= 0:
            raise ValueError(f"epochs={epochs} must be positive")
        root = key(seed, "cpu")
        results = [None] * len(self.workloads)
        step = epochs if self.epoch_chunk is None else min(self.epoch_chunk,
                                                            epochs)
        ep = torch.arange(epoch_start, epoch_start + epochs, dtype=torch.int64)
        for bkey, members in self._buckets.items():
            cfg0 = self.workloads[members[0]][0]
            st = self._staged(bkey, members)
            # key[p, e] = fold_in(stage_key(root, "user", p), global e)
            keys = fold_in(stage_key(root, "user", st["members"])[:, None, :],
                           ep[None, :])
            out = torch.empty((len(members), epochs, bkey[0],
                               cfg0.nsub * cfg0.nph), dtype=torch.float32,
                              device=self.device)
            for e0 in range(0, epochs, step):
                e1 = min(e0 + step, epochs)
                out[:, e0:e1] = self._run_mesh(
                    st, keys[:, e0:e1], cfg0)[:len(members)]
            for slot, idx in enumerate(members):
                results[idx] = out[slot]
        return results
