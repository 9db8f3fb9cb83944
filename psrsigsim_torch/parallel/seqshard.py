"""Sequence (time-axis) sharding of SEARCH and baseband streams
(counterpart: psrsigsim_tpu/parallel/seqshard.py).

A stream too long for one device is cut into ``n`` time slabs over a
``("seq",)`` mesh, each slab ``(Nchan, nsamp/n)`` on its shard's device:

* **Time-sharded stages** — pulse synthesis, nulling masks and radiometer
  noise are elementwise in time, and every draw is keyed by global time
  (the flat stream's offsets ``c·nsamp + t``, the per-channel fields'
  global RNG blocks), so a slab draws exactly the samples the whole stream
  draws there, for any shard count.
* **The one sequence-global op** — the exact (``"fft"`` mode) dispersion
  shift needs the whole time axis: an ``all_to_all`` re-shards channels
  and gathers time (``(Nchan, T/n) -> (Nchan/n, T)``), the shift runs on
  each channel slab, and a second ``all_to_all`` transposes back.  The
  envelope mode shifts the periodic portrait instead and needs no
  exchange.
* **Baseband** — coherent dedispersion by overlap-save blocks, each slab
  extended by halos fetched from both ring neighbours (``ppermute``).

Where the JAX package runs one ``shard_map`` program, the port runs the
body once per mesh position, one position after the other on the host
thread, with the exchanges of :mod:`._collectives` between the stages, and
assembles the whole ``(Nchan, nsamp)`` stream (``(B, Nchan, nsamp)``,
``(Npol, nsamp)``) on the mesh's first device, as the reference's jitted
``run`` returns it.  On one card every shard runs on that card in series:
a mesh there measures what the sharding costs, not a speed-up.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.shift import (coherent_dedisperse, dedispersion_filter,
                         fourier_shift)
from ..ops.stats import (SEQ_RNG_BLOCK, blocked_chan_chi2,
                         blocked_chan_normal, chan_chi2_field, flat_chi2_ok,
                         flat_spans)
from ..simulate.pipeline import (_fold_front, _null_mask_row, _roll_rows,
                                 _tile_periodic)
from ..utils.device import to_device
from ..utils.rng import as_key, stage_key
from ._collectives import all_to_all, gather_grid, on_device, ppermute
from .mesh import OBS_AXIS, Mesh, visible_devices

__all__ = ["SEQ_AXIS", "SEQ_RNG_BLOCK", "make_seq_mesh",
           "seq_sharded_search", "seq_sharded_baseband",
           "seq_sharded_dedisperse", "dispersion_halo_samples",
           "make_obs_seq_mesh", "seq_sharded_search_ensemble",
           "blocked_chan_chi2", "blocked_chan_normal"]

SEQ_AXIS = "seq"


def _device_array(devices, shape):
    arr = np.empty(len(devices), dtype=object)
    arr[:] = list(devices)
    return arr.reshape(shape)


def make_seq_mesh(n_devices=None, devices=None):
    """1-D ``('seq',)`` mesh over ``n_devices`` (default: every visible
    CUDA device), or over the explicit ``devices`` (entries may repeat).

    Raises if fewer than ``n_devices`` devices are visible — a silently
    smaller mesh would change sharding and divisibility behind the
    caller's back (``make_mesh``'s strictness).
    """
    if devices is not None:
        devices = list(devices)
        if n_devices is not None and len(devices) != n_devices:
            raise ValueError(
                f"got {len(devices)} explicit devices but n_devices="
                f"{n_devices}; pass one or the other")
    else:
        devices = visible_devices()
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(
                    f"requested a {n_devices}-device seq mesh but only "
                    f"{len(devices)} devices are visible")
            devices = devices[:n_devices]
    return Mesh(_device_array(devices, (len(devices),)), (SEQ_AXIS,))


def make_obs_seq_mesh(shape, devices=None):
    """2-D ``('obs', 'seq')`` mesh: observations along the first axis, each
    observation's time along the second.  An explicit device list must
    tile ``shape`` exactly; the default list (every visible CUDA device)
    is truncated to the needed count and raises if too few are visible."""
    n = shape[0] * shape[1]
    if devices is None:
        devices = visible_devices()
        if len(devices) < n:
            raise ValueError(
                f"mesh shape {tuple(shape)} needs {n} devices; "
                f"{len(devices)} visible")
        devices = devices[:n]
    elif n != len(devices):
        raise ValueError(f"mesh shape {tuple(shape)} does not tile "
                         f"{len(devices)} explicit devices")
    return Mesh(_device_array(devices, tuple(shape)), (OBS_AXIS, SEQ_AXIS))


def _seq_prologue(cfg, mesh):
    """Shared setup of the seq-sharded entry points: the default mesh, the
    divisibility and int32 guards, the slab length.  ``(mesh, n, L)``."""
    if mesh is None:
        mesh = make_seq_mesh()
    if not isinstance(mesh, Mesh) or SEQ_AXIS not in mesh.axis_names:
        raise TypeError(f"expected a Mesh with a {SEQ_AXIS!r} axis "
                        "(make_seq_mesh / make_obs_seq_mesh), got "
                        f"{mesh!r}")
    n = mesh.shape[SEQ_AXIS]
    nsamp = int(cfg.nsamp)
    if nsamp % n:
        raise ValueError(f"nsamp={nsamp} must be divisible by the seq axis "
                         f"({n})")
    if nsamp >= 2**31:
        # global time indices and RNG block ids are int32 in the kernels
        raise ValueError(
            f"nsamp={nsamp} exceeds int32 indexing; split the observation "
            "into sub-spans (one call per span) instead")
    return mesh, n, nsamp // n


def _staged(value, dtype=torch.float32):
    """``value`` (numpy or a tensor) on a device, staged once per device
    for the call."""
    cache = {}

    def on(dev):
        if dev not in cache:
            cache[dev] = torch.as_tensor(
                value if isinstance(value, torch.Tensor)
                else np.asarray(value), dtype=dtype).to(dev)
        return cache[dev]

    return on


def _search_seq_body(cfg, n, L):
    """The SEARCH body over ``n`` time slabs of ``L`` samples: a function
    ``body(devices, key, dm, noise_norm, profiles, extra_delays_ms) ->
    [(..., Nchan, L) per shard]`` for keys ``(..., 2)`` (``profiles``: a
    per-device stager), the same stages as
    :func:`~psrsigsim_torch.simulate.single_pipeline`:

    * ``"envelope"`` — the portrait shifted by the delays (the same small
      FFT on every shard), the null windows rolled by the integer delays:
      every stage elementwise in time, no exchange;
    * ``"fft"`` — the exact full-stream shift between two ``all_to_all``
      transposes, on each shard's ``Nchan/n`` channels.

    Shared by the 1-D seq pipeline and the ``(obs, seq)`` ensemble."""
    nchan, nsamp, nph = cfg.meta.nchan, int(cfg.nsamp), cfg.nph
    freqs = np.asarray(cfg.meta.dat_freq_mhz(), np.float32)
    chan_ids = torch.arange(nchan)
    envelope = cfg.shift_mode == "envelope"
    # the main fields come from the FLAT stream (one span per channel at
    # c·nsamp + t0) unless the GLOBAL extent or the df rules it out: the
    # same predicate as the unsharded pipeline, so both draw the same
    # realization
    span_end = nchan * nsamp
    flat_pulse = flat_chi2_ok(1.0, span_end=span_end)
    flat_noise = flat_chi2_ok(cfg.noise_df, span_end=span_end)
    # XLA divides by the constant dt as a multiply by its reciprocal
    inv_dt = float(np.float32(1.0) / np.float32(cfg.dt_ms))

    def chi2_span(key, df, t0, use_flat):
        if not use_flat:
            return chan_chi2_field(key, chan_ids, df, t0, L).contiguous()
        return flat_spans(key, [c * nsamp + t0 for c in range(nchan)], L, df)

    def synth(shard, dev, key, dm, noise_norm, profiles, extra):
        t0 = shard * L
        f = _fold_front(key, dm, noise_norm, profiles(dev), cfg, freqs,
                        chan_ids, extra, dev)
        # pulse term: the portrait at each global sample's phase x chi2(1)
        block = chi2_span(to_device(f.kp, dev), 1.0, t0, flat_pulse)
        prof = f.prof if envelope else f.profiles
        _tile_periodic(block, torch.roll(prof, -(t0 % nph), dims=-1), nph)
        if cfg.draw_norm != 1.0:
            block.mul_(cfg.draw_norm)
        if cfg.n_null > 0:
            # one replacement row keyed by the pseudo-channel id Nchan
            knz = to_device(stage_key(f.key, "null_noise"), dev)
            repl = chan_chi2_field(knz, torch.tensor([nchan]), cfg.null_df,
                                   t0, L)[..., 0, :]
            if cfg.draw_norm != 1.0:
                repl = repl * cfg.draw_norm
            repl = repl * cfg.off_pulse_mean
            if envelope:
                # the global mask rolled by each channel's integer delay,
                # this slab's window of it
                row = _null_mask_row(f.key, cfg, 0, nsamp, dev)
                dint = torch.round(f.obs_delays_ms() * inv_dt).to(
                    torch.int64)
                mask = _roll_rows(row.reshape(-1, nsamp),
                                  dint.reshape(-1, nchan), t0, L)
                mask = mask.reshape(block.shape)
            else:
                mask = _null_mask_row(f.key, cfg, t0, L, dev)[..., None, :]
            torch.where(mask, repl[..., None, :], block, out=block)
        return block, f

    def body(devices, key, dm, noise_norm, profiles, extra_delays_ms=None):
        parts, fronts = [], []
        for s, dev in enumerate(devices):
            with on_device(dev):
                b, f = synth(s, dev, key, dm, noise_norm, profiles,
                             extra_delays_ms)
            parts.append(b)
            fronts.append(f)
        if not envelope:
            # (..., Nchan, L) -> (..., Nchan/n, nsamp), shift, and back
            cl = nchan // n
            gathered = all_to_all(parts, -2, -1, devices)
            for j, dev in enumerate(devices):
                with on_device(dev):
                    gathered[j] = fourier_shift(
                        gathered[j], fronts[j].delays_ms[..., j * cl:(j + 1) * cl],
                        dt=cfg.dt_ms)
            parts = all_to_all(gathered, -1, -2, devices)
        for s, dev in enumerate(devices):
            with on_device(dev):
                # radiometer noise, time-sharded
                noise = chi2_span(to_device(fronts[s].kn, dev), cfg.noise_df,
                                  s * L, flat_noise)
                noise.mul_(fronts[s].noise_norm[..., None, None])
                parts[s] = parts[s].add_(noise)
        return parts

    return body


def seq_sharded_search(cfg, mesh=None):
    """The SEARCH pipeline with the time axis sharded over ``mesh``'s
    ``'seq'`` axis (reference: ``seq_sharded_search``).

    The stages and draws are :func:`~psrsigsim_torch.simulate.
    single_pipeline`'s (synthesis, nulling, dispersion, radiometer noise),
    drawn at each slab's global offsets, so the stream is the same for any
    shard count.  Requires ``cfg.nsamp`` divisible by the shard count and,
    in ``"fft"`` mode, ``Nchan`` too.  Returns ``run(key, dm, noise_norm,
    profiles, extra_delays_ms=None) -> (Nchan, nsamp)`` float32 on the
    mesh's first device; ``key`` may carry leading batch axes.
    ``extra_delays_ms``: per-channel delays (FD, scattering) composed into
    the dispersion delays, as in ``single_pipeline``.
    """
    mesh, n, _ = _seq_prologue(cfg, mesh)
    nchan = cfg.meta.nchan
    if cfg.shift_mode != "envelope" and nchan % n:
        # only the fft mode's all_to_all re-shards channels
        raise ValueError(f"Nchan={nchan} must be divisible by the seq axis "
                         f"({n})")
    body = _search_seq_body(cfg, n, int(cfg.nsamp) // n)
    devices = list(mesh.devices.reshape(-1))

    def run(key, dm, noise_norm, profiles, extra_delays_ms=None):
        key = as_key(key) if isinstance(key, torch.Tensor) else as_key(key, "cpu")
        parts = body(devices, key, dm, noise_norm, _staged(profiles),
                     extra_delays_ms)
        return gather_grid([parts], (None, -1), mesh.first_device)

    return run


def seq_sharded_search_ensemble(cfg, mesh):
    """SEARCH observations over a 2-D ``(obs, seq)`` mesh (reference:
    ``seq_sharded_search_ensemble``): the batch splits over ``obs``, each
    observation's time over ``seq`` (the :func:`seq_sharded_search` body on
    each obs shard's batch).  Draws are keyed by (observation key,
    channel, global offset), so the output is the same for any mesh shape.

    Returns ``run(keys, dms, noise_norms, profiles, extra_delays_ms=None)
    -> (B, Nchan, nsamp)`` on the mesh's first device; ``B`` must divide by
    the obs axis.
    """
    _, n_seq, L = _seq_prologue(cfg, mesh)
    nchan = cfg.meta.nchan
    if cfg.shift_mode != "envelope" and nchan % n_seq:
        raise ValueError(f"Nchan={nchan} must be divisible by the seq axis "
                         f"({n_seq})")
    body = _search_seq_body(cfg, n_seq, L)
    n_obs = mesh.shape[OBS_AXIS]

    def per_obs(v, B, dev):
        return torch.as_tensor(v if isinstance(v, torch.Tensor)
                               else np.asarray(v, np.float32),
                               dtype=torch.float32).to(dev).expand(B)

    def run(keys, dms, noise_norms, profiles, extra_delays_ms=None):
        keys = (as_key(keys) if isinstance(keys, torch.Tensor)
                else as_key(keys, "cpu"))
        B = keys.shape[0]
        if B % n_obs:
            raise ValueError(f"batch {B} must be divisible by the obs axis "
                             f"({n_obs})")
        per = B // n_obs
        dms = per_obs(dms, B, keys.device)
        noise_norms = per_obs(noise_norms, B, keys.device)
        stage = _staged(profiles)
        grid = []
        for i in range(n_obs):
            sl = slice(i * per, (i + 1) * per)
            grid.append(body(list(mesh.devices[i]), keys[sl], dms[sl],
                             noise_norms[sl], stage, extra_delays_ms))
        return gather_grid(grid, (0, -1), mesh.first_device)

    return run


# -- baseband: overlap-save coherent dedispersion with ring halo exchange --


def dispersion_halo_samples(dm, fcent_mhz, bw_mhz, dt_us, margin=4.0):
    """Samples of dispersion smearing across the band — the halo the
    overlap-save blocks need on EACH side (reference:
    ``dispersion_halo_samples``, host arithmetic as it is): ``margin``
    DM sweeps across ``[fcent - bw/2, fcent + bw/2]``; a negative DM
    smears as far."""
    dm_k_s = 1.0 / 2.41e-4  # s MHz^2 cm^3 / pc
    f_lo = fcent_mhz - bw_mhz / 2.0
    f_hi = fcent_mhz + bw_mhz / 2.0
    sweep_s = dm_k_s * abs(float(dm)) * (f_lo**-2 - f_hi**-2)
    return int(np.ceil(margin * sweep_s * 1e6 / dt_us)) + 1


def _make_dedisp_local(cfg, dm, n, L, halo):
    """The sharded overlap-save dedispersion (shared by the standalone op
    and the pipeline): ``dedisp(parts, devices) -> parts`` over the
    ``(..., L)`` slabs.

    The extended block is rounded UP to a power of two and the slack goes
    into the right halo — the reference's rule (its TPU lowers other FFT
    lengths as a dense DFT).  cuFFT needs no power of two, but the block
    and halos set the truncation error, so the port keeps them: its error
    is the reference's."""
    dm = float(dm)
    planes = {}   # the host planes of the block length, once per device

    def filt(x):
        if x.device not in planes:
            planes[x.device] = dedispersion_filter(
                x.shape[-1], dm, cfg.fcent_mhz, cfg.bw_mhz, cfg.dt_us,
                x.device)
        return coherent_dedisperse(x, dm, cfg.fcent_mhz, cfg.bw_mhz,
                                   cfg.dt_us, filt=planes[x.device])

    if n == 1:
        # no neighbours: the full-length circular filter, exactly (no halo,
        # so no smearing limit)
        def whole(parts, devices):
            with on_device(devices[0]):
                return [filt(parts[0])]

        return whole
    if halo is None:
        halo = dispersion_halo_samples(dm, cfg.fcent_mhz, cfg.bw_mhz,
                                       cfg.dt_us)
    if halo < 1:
        # hl = 0 would make x[..., -hl:] the whole slab — silently wrong
        raise ValueError(f"halo must be >= 1 (got {halo})")
    if halo > L:
        raise ValueError(
            f"dispersion smearing ({halo} samples) exceeds the local slab "
            f"({L}); use fewer seq shards or the unsharded FFT path")
    block = 1 << int(np.ceil(np.log2(L + 2 * halo)))
    hl = halo
    hr = block - L - hl
    if hr > L:
        # cap the right halo at one neighbour's slab (a single-hop fetch);
        # the remainder goes to the left halo if it fits
        hr = L
        hl = block - L - hr
        if hl > L:
            raise ValueError(
                f"padded overlap-save block ({block}) needs halos beyond "
                f"one slab ({L}); use fewer seq shards")
    perm_fwd = [(i, (i + 1) % n) for i in range(n)]
    perm_bwd = [(i, (i - 1) % n) for i in range(n)]

    def dedisp(parts, devices):
        left = ppermute([x[..., -hl:] for x in parts], perm_fwd, devices)
        right = ppermute([x[..., :hr] for x in parts], perm_bwd, devices)
        out = []
        for x, lft, rgt, dev in zip(parts, left, right, devices):
            with on_device(dev):
                ext = torch.cat([lft, x, rgt], dim=-1)      # (..., block)
                out.append(filt(ext)[..., hl:hl + L])
        return out

    return dedisp


def _slabs(x, n, L, devices):
    return [x[..., s * L:(s + 1) * L].to(dev) for s, dev in enumerate(devices)]


def seq_sharded_dedisperse(cfg, dm, mesh=None, halo=None):
    """Coherent dedispersion of a time-sharded baseband stream by
    overlap-save blocks with a ring halo exchange (reference:
    ``seq_sharded_dedisperse``): each shard filters its slab extended by
    ``halo`` samples fetched cyclically from both ring neighbours, which
    matches the full-length CIRCULAR filter up to the halo's truncation of
    the impulse response.  Requires ``halo <= nsamp/n``.

    Returns ``run(x) -> y`` for ``(..., nsamp)`` float32 data (a tensor
    anywhere, or numpy), ``y`` on the mesh's first device.  ``dm`` is a
    number (it sizes the halo)."""
    mesh, n, L = _seq_prologue(cfg, mesh)
    dedisp = _make_dedisp_local(cfg, dm, n, L, halo)
    devices = list(mesh.devices.reshape(-1))

    def run(x):
        x = torch.as_tensor(x if isinstance(x, torch.Tensor)
                            else np.asarray(x, np.float32))
        return gather_grid([dedisp(_slabs(x, n, L, devices), devices)],
                           (None, -1), mesh.first_device)

    return run


def seq_sharded_baseband(cfg, dm, mesh=None, halo=None):
    """The baseband pipeline with the time axis sharded (reference:
    ``seq_sharded_baseband``): amplitude synthesis (the sqrt-profile × the
    flat normal stream at each slab's offsets ``p·nsamp + t0``, the
    samples :func:`~psrsigsim_torch.simulate.baseband_pipeline` draws
    there), overlap-save dedispersion (:func:`seq_sharded_dedisperse`'s)
    and amplitude noise from the same stream.

    Returns ``run(key, noise_norm, sqrt_profiles) -> (Npol, nsamp)`` on
    the mesh's first device; ``key`` may carry leading batch axes.  ``dm``
    is a number."""
    mesh, n, L = _seq_prologue(cfg, mesh)
    dedisp = _make_dedisp_local(cfg, dm, n, L, halo)
    devices = list(mesh.devices.reshape(-1))
    nsamp, nph = int(cfg.nsamp), cfg.nph

    def run(key, noise_norm, sqrt_profiles):
        key = as_key(key) if isinstance(key, torch.Tensor) else as_key(key, "cpu")
        lead = key.shape[:-1]
        stage = _staged(sqrt_profiles)
        npol = stage(devices[0]).shape[0]

        def spans(k, t0):
            return flat_spans(k, [p * nsamp + t0 for p in range(npol)], L)

        parts = []
        for s, dev in enumerate(devices):
            with on_device(dev):
                block = spans(to_device(stage_key(key, "pulse"), dev), s * L)
                _tile_periodic(block, torch.roll(stage(dev), -(s * L % nph),
                                                 dims=-1), nph)
            parts.append(block)
        parts = dedisp(parts, devices)
        for s, dev in enumerate(devices):
            with on_device(dev):
                noise = spans(to_device(stage_key(key, "noise"), dev), s * L)
                nn = torch.as_tensor(noise_norm, dtype=torch.float32,
                                     device=dev).expand(lead)
                noise.mul_(nn[..., None, None])
                parts[s] = noise.add_(parts[s])
        return gather_grid([parts], (None, -1), mesh.first_device)

    return run
