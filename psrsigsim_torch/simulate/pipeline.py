"""The fold-mode, SEARCH-mode and baseband observation pipelines
(counterpart: psrsigsim_tpu/simulate/pipeline.py).

The reference's call chain ``make_pulses -> disperse -> observe(noise)``
(psrsigsim/simulate/simulate.py:292-326) as one function on tensors,

    fold_pipeline(keys, dms, noise_norms, profiles, cfg) -> (..., Nchan, Nsamp)
    fold_pipeline_hetero(keys, dms, noise_norms, nfolds, draw_norms,
                         profiles, cfg, freqs, dt_ms=) -> (..., Nchan, Nsamp)
    single_pipeline(keys, dms, noise_norms, profiles, cfg) -> (..., Nchan, Nsamp)
    baseband_pipeline(keys, dms, noise_norms, sqrt_profiles, cfg) -> (..., Npol, Nsamp)

with every shape fixed by a static config.  Where the JAX package vmaps a
one-observation function, the port writes the batch dimension out: keys
``(..., 2)`` with one DM and one noise scale per key give one block per
key, on the device the profiles live on.

Everything random threads explicit stage keys, so a block depends only on
its observation key, never on the batch it ran in.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch

from ..ops.fold_quantize import fold_quantize
from ..ops.rng_hw import seed_words
from ..ops.shift import (coherent_dedisperse, coherent_dedisperse_os,
                         fourier_shift, plan_dedisperse_os)
from ..ops.stats import (CHI2_WH_MIN_DF,
                         _hw_chi2_mode, chan_chi2_field, flat_chi2_field,
                         flat_chi2_ok, flat_normal_field, sampler_backend,
                         uniform)
from ..runtime.telemetry import count, span
from ..scenarios.registry import (apply_scenario_additive,
                                  apply_scenario_additive_search,
                                  apply_scenario_pulse,
                                  apply_scenario_pulse_search, scenario_rows)
from ..signal.state import SignalMeta
from ..utils.constants import DM_K_MS_MHZ2
from ..utils.device import resolve_device, to_device
from ..utils.rng import STAGES, as_key, fold_in, permutation, stage_key

__all__ = ["default_shift_mode", "FoldPipelineConfig", "fold_pipeline",
           "fold_pipeline_batch", "fold_pipeline_hetero", "fold_pipeline_quantized", "fused_route",
           "fold_subints", "noise_level", "build_fold_config",
           "natural_nbin", "SinglePipelineConfig", "single_pipeline",
           "build_single_config", "BasebandPipelineConfig",
           "baseband_pipeline", "build_baseband_config"]


def default_shift_mode():
    """The dispersion-shift strategy: ``"envelope"`` (default) shifts the
    periodic ``(Nchan, Nph)`` portrait by ``delay mod period`` before
    tiling (the JAX package's DIVERGENCES #22); ``"fft"``
    (``PSS_EXACT_SHIFT=1``) shifts the full synthesized stream as the
    reference does (psrsigsim/ism/ism.py:40-74)."""
    return "fft" if os.environ.get("PSS_EXACT_SHIFT") else "envelope"


@dataclasses.dataclass(frozen=True)
class FoldPipelineConfig:
    """Static configuration of a fold-mode observation."""

    meta: SignalMeta
    period_s: float
    nsub: int
    nph: int
    nfold: float  # chi2 df of the pulse intensity draws (sublen/period)
    draw_norm: float  # dynamic-range scaling (int8) — fb_signal.py:114-121
    noise_df: float  # chi2 df of the radiometer noise draws
    dt_ms: float  # sample spacing, ms
    clip_max: float  # draw ceiling for the export path (telescope.py:141-144)
    shift_mode: str = "envelope"  # see default_shift_mode

    @property
    def nsamp(self):
        return self.nsub * self.nph


def _chan_chi2(key, chan_ids, df, nsamp):
    """Per-channel χ² fields keyed by (GLOBAL channel, GLOBAL RNG block):
    the CUDA sampler kernel on the card, the blocked threefry draws
    elsewhere (ops/stats.py).  Contiguous, because the pipeline writes into
    it in place through views."""
    return chan_chi2_field(key, chan_ids, df, 0, nsamp).contiguous()


def _dispersion_delays(dm, freqs, extra_delays_ms):
    """DM (+ FD/scatter) delays in ms, ``(..., Nchan)`` for DMs ``(...)``,
    composed additively for the one batched Fourier shift; float32 in the
    reference's order of operations."""
    delays_ms = (DM_K_MS_MHZ2 * dm[..., None]) / (freqs * freqs)
    if extra_delays_ms is not None:
        delays_ms = delays_ms + extra_delays_ms
    return delays_ms


def _shifted_portrait(profiles, delays_ms, dt):
    """Dispersion applied to the PERIODIC envelope: the portrait shifted by
    the delays, one small ``(..., Nchan, Nph)`` FFT instead of the
    full-length pair."""
    return fourier_shift(profiles, delays_ms, dt=dt)


class _FoldFront(NamedTuple):
    """What both fold routes start from (see :func:`_fold_front`)."""

    dev: torch.device
    lead: tuple
    key: torch.Tensor         # observation keys, where ``key`` lies
    kp: torch.Tensor          # pulse stage keys, where ``key`` lies
    kn: torch.Tensor          # noise stage keys, where ``key`` lies
    noise_norm: torch.Tensor  # (...) on dev
    delays_ms: torch.Tensor   # DM's own shape + (Nchan,) on dev
    profiles: torch.Tensor    # (Nchan, Nph) on dev
    chan_ids: torch.Tensor
    dt: object                # sample spacing: cfg.dt_ms, or dt_ms's shape
                              # + (1, 1) on dev
    prof: torch.Tensor | None  # envelope mode: the shifted portrait, the
                               # delays' shape + (Nph,), broadcasting
                               # against lead + (Nchan, Nph)

    def obs_delays_ms(self):
        """``delays_ms`` with one row per observation, ``lead + (Nchan,)``
        (a view)."""
        return self.delays_ms.expand(self.lead + self.delays_ms.shape[-1:])


def _fold_front(key, dm, noise_norm, profiles, cfg, freqs, chan_ids,
                extra_delays_ms, device, dt_ms=None, shifted=False):
    """The front half shared by the fold routes: inputs on the device, the
    pulse and noise stage keys, the DM (+ extra) delays and, in envelope
    mode, the portrait shifted by them (one small ``(..., Nchan, Nph)``
    FFT).  ``dt_ms``: one sample spacing per observation (the
    heterogeneous route), else the static ``cfg.dt_ms``.

    The delays, the sample spacing and the shifted portrait keep the
    broadcast shape of the inputs they come from (DM, ``dt_ms``, the
    portrait and the frequencies), not the keys': where those are shared
    across observations (a pulsar's epochs in the multi-pulsar ensemble,
    ``(P, 1)`` against ``(P, E)`` keys; one DM for a batch) each distinct
    row is shifted once, and the body broadcasts it over the
    observations.  ``shifted``: ``profiles`` already are the envelope-mode
    portrait shifted by these delays (:func:`_shifted_portrait`; the
    multi-pulsar ensemble shifts each bucket's once, when it stages it),
    so the front shifts nothing."""
    if isinstance(profiles, torch.Tensor):
        dev = profiles.device
    else:
        dev = resolve_device(device)
        profiles = torch.as_tensor(np.asarray(profiles, np.float32), device=dev)
    with span("keys"):
        key = (as_key(key) if isinstance(key, torch.Tensor)
               else as_key(key, "cpu"))
    lead = key.shape[:-1]
    f32 = torch.float32

    def broadcastable(v):
        """``v`` as a float32 tensor on the device in its own shape, which
        must broadcast to the observations'."""
        t = torch.as_tensor(v, dtype=f32, device=dev)
        try:   # numpy's: torch.broadcast_shapes imports sympy at first use
            fits = np.broadcast_shapes(t.shape, lead) == tuple(lead)
        except ValueError:
            fits = False
        if not fits:
            raise ValueError(f"shape {tuple(t.shape)} does not broadcast to "
                             f"the keys' {tuple(lead)}")
        return t

    dm = broadcastable(dm)
    noise_norm = torch.as_tensor(noise_norm, dtype=f32, device=dev).expand(lead)
    if freqs is None:
        freqs = np.asarray(cfg.meta.dat_freq_mhz(), np.float32)
    freqs = torch.as_tensor(freqs, dtype=f32, device=dev)
    if chan_ids is None:
        chan_ids = torch.arange(freqs.shape[-1])
    if extra_delays_ms is not None:
        extra_delays_ms = torch.as_tensor(extra_delays_ms, dtype=f32, device=dev)
    delays_ms = _dispersion_delays(dm, freqs, extra_delays_ms)
    dt = cfg.dt_ms
    if dt_ms is not None:
        dt = broadcastable(dt_ms)[..., None, None]
    prof = None
    if cfg.shift_mode == "envelope":
        prof = profiles if shifted else _shifted_portrait(profiles,
                                                          delays_ms, dt)
    if not shifted:
        count("shift.obs_rows", int(np.prod(lead, dtype=np.int64))
              * delays_ms.shape[-1])
    # the stage keys after the launches above, so the card shifts the
    # portrait while the host derives them: both stages in one chain,
    # stage_key(key, "pulse") and stage_key(key, "noise") bit for bit
    with span("keys"):
        sids = torch.tensor((STAGES["pulse"], STAGES["noise"]),
                            device=key.device)
        kp, kn = fold_in(fold_in(key[..., None, :], sids), 0).unbind(-2)
    return _FoldFront(dev, lead, key, kp, kn, noise_norm, delays_ms,
                      profiles, chan_ids, dt, prof)


def fold_pipeline(key, dm, noise_norm, profiles, cfg, freqs=None,
                  chan_ids=None, extra_delays_ms=None, null_frac=None,
                  device=None, scenario=None, scenario_params=None,
                  rows=None):
    """Fold-mode observations: synthesis + dispersion + radiometer noise.

    Args:
        key: observation keys ``(..., 2)`` (a tensor, or uint32 key data as
            ``jax.random.key_data`` gives it).  The per-stage keys are
            derived where ``key`` lies — numpy key data on the host, where
            a threefry call runs in about a hundred numpy ``uint32``
            operations instead of hundreds of small device launches — and
            then copied to the device.
        dm: dispersion measures ``(...)`` (pc/cm^3).
        noise_norm: radiometer noise scales ``(...)``.
        profiles: normalized portrait ``(Nchan, Nph)``, or one per
            observation ``(..., Nchan, Nph)`` (envelope mode; the
            Monte-Carlo study's per-trial Gaussian portraits); a tensor
            fixes the device, numpy goes to ``device``.
        cfg: static :class:`FoldPipelineConfig`.
        freqs: channel frequencies (MHz) matching ``profiles``' channels;
            defaults to the full grid from ``cfg``.
        chan_ids: GLOBAL channel indices of ``profiles``' channels (all
            draws are keyed by them), best as a CPU tensor: the sampler
            reads the first one on the host.
        extra_delays_ms: optional per-channel delays added to the DM delays
            before the one Fourier shift.
        null_frac: optional per-observation nulling probability ``(...)``:
            each subintegration's pulse term is zeroed with this
            probability, drawn on the ``"null_select"`` stage.
        device: where numpy ``profiles`` go (default: the CUDA card).
        scenario: optional scenario stack
            (:class:`~psrsigsim_torch.scenarios.ScenarioStack` or effect
            labels): scintillation gains and single-pulse energies multiply
            the pulse term before nulling, and RFI levels are added after
            the radiometer noise, in units of the mean noise level
            ``noise_df · noise_norm`` — the JAX package's order.  ``None``
            runs the scenario-free body unchanged.
        scenario_params: ``{name: scalar or (...) tensor}`` for the stack's
            parameters (registry defaults fill unset ones).
        rows: the batch's :class:`~psrsigsim_torch.scenarios.ScenarioRows`
            when the caller has already drawn them
            (:func:`~psrsigsim_torch.scenarios.scenario_rows`, e.g. for the
            truth mask); drawn here otherwise.

    Returns:
        ``(..., Nchan, nsub*Nph)`` float32 blocks (unclipped).
    """
    f = _fold_front(key, dm, noise_norm, profiles, cfg, freqs, chan_ids,
                    extra_delays_ms, device)
    return _fold_core(f, cfg, cfg.nfold, cfg.draw_norm, cfg.noise_df,
                      null_frac, scenario, scenario_params, rows)


def fold_pipeline_batch(cfg, shared_profiles=True, device=None):
    """The ensemble form of :func:`fold_pipeline` (reference:
    ``fold_pipeline_batch``, a vmap): a function ``(keys (B, 2), dms (B,),
    noise_norms (B,), profiles) -> (B, Nchan, Nsamp)``, with one shared
    ``(Nchan, Nph)`` portrait or, with ``shared_profiles=False``, one per
    observation ``(B, Nchan, Nph)``.  ``device``: where numpy profiles go
    (default: the CUDA card)."""

    def batched(keys, dms, noise_norms, profiles):
        if not shared_profiles and np.ndim(profiles) != 3:
            raise ValueError("shared_profiles=False takes (B, Nchan, Nph) "
                             f"profiles, got shape {tuple(np.shape(profiles))}")
        return fold_pipeline(keys, dms, noise_norms, profiles, cfg,
                             device=device)

    return batched


def _fold_core(f, cfg, nfold, draw_norm, noise_df, null_frac=None,
               scenario=None, scenario_params=None, rows=None):
    """The fold body after the front half (reference: ``_fold_core``).
    ``nfold``, ``draw_norm`` and ``noise_df`` are Python numbers (the
    homogeneous route) or tensors with one value per observation (the
    heterogeneous one, whose χ² fields then take the sampler's
    ``chi2_sel`` mode)."""
    dev, lead = f.dev, f.lead
    nsub, nph = cfg.nsub, cfg.nph
    nsamp = nsub * nph
    nchan = f.profiles.shape[-2]

    # pulse term: tiled portrait x chi2(nfold) x draw_norm, written into the
    # pulse field in place (the product commutes, so the rounding is the
    # reference's; a static draw_norm of 1.0, as for float32 signals, is
    # exact and skips its pass over the block)
    block = _chan_chi2(to_device(f.kp, dev), f.chan_ids, nfold, nsamp)
    shape = lead + (nchan, nsub, nph)
    if cfg.shift_mode == "envelope":
        block.view(shape).mul_(f.prof[..., None, :])
    else:
        block.view(shape).mul_(f.profiles[..., None, :])
    if isinstance(draw_norm, torch.Tensor):
        block.mul_(draw_norm[..., None, None])
    elif draw_norm != 1.0:
        block.mul_(draw_norm)
    if cfg.shift_mode != "envelope":
        block = fourier_shift(block, f.delays_ms, dt=f.dt)

    if rows is None and scenario is not None:
        rows = _scenario_rows(f, cfg, scenario, scenario_params)
    if rows is not None:
        # multiplicative effects modulate the pulse term only
        apply_scenario_pulse(block, rows, nsub, nph)

    if null_frac is not None:
        # per-subint nulling between synthesis and noise, on its own stage
        u = to_device(uniform(stage_key(f.key, "null_select"), nsub), dev)
        nf = torch.as_tensor(null_frac, dtype=torch.float32,
                             device=dev).expand(lead)
        live = (u >= nf[..., None]).to(torch.float32)
        block.view(shape).mul_(live[..., None, :, None])

    # radiometer noise, added after dispersion (never shifted)
    noise = _chan_chi2(to_device(f.kn, dev), f.chan_ids, noise_df, nsamp)
    noise.mul_(f.noise_norm[..., None, None])
    block.add_(noise)
    if rows is not None:
        # additive effects (RFI) ride on top of the radiometer noise
        apply_scenario_additive(block, rows, nsub, nph)
    return block


def _hetero_df_guard(nfolds):
    """The heterogeneous route draws its χ² fields with a per-observation
    df, i.e. through Wilson–Hilferty (or ``z²`` for df = 1): refuse an
    Nfold outside that domain (reference: the guard of
    ``fold_pipeline_hetero``)."""
    if os.environ.get("PSS_EXACT_CHI2"):
        return
    nf = np.asarray(nfolds, np.float64)
    bad = nf[(nf != 1.0) & (nf < CHI2_WH_MIN_DF)]
    if bad.size:
        raise ValueError(
            f"fold_pipeline_hetero draws its chi2 df per observation, "
            f"through the Wilson-Hilferty approximation — only valid for "
            f"Nfold >= {CHI2_WH_MIN_DF:.0f} (or exactly 1); got "
            f"Nfold={float(bad.min()):g}. Use longer subintegrations "
            f"or export PSS_EXACT_CHI2=1 for the exact gamma sampler.")


def fold_pipeline_hetero(key, dm, noise_norm, nfold, draw_norm, profiles, cfg,
                         freqs=None, chan_ids=None, extra_delays_ms=None,
                         dt_ms=None, device=None):
    """Fold-mode observations with PER-OBSERVATION pulsar parameters
    (reference: ``fold_pipeline_hetero``): portrait, DM, χ² df ``nfold``
    (= sublen/period), draw norm, noise norm, channel frequencies and the
    sample spacing ``dt_ms`` are inputs, so observations of different
    pulsars that share ``(Nchan, Nph, nsub)`` run through one body (the
    padded common-NBIN buckets of
    :class:`~psrsigsim_torch.parallel.MultiPulsarFoldEnsemble`).

    Arguments as :func:`fold_pipeline`, plus ``nfold`` and ``draw_norm``
    ``(...)`` (scalars broadcast) and ``dt_ms`` ``(...)`` (default: the
    static ``cfg.dt_ms``).  ``profiles`` may be ``(..., Nchan, Nph)`` and
    ``freqs`` ``(..., Nchan)``, broadcasting against the keys' leading
    axes (e.g. ``(P, 1, Nchan, Nph)`` for P pulsars × E epochs).  The
    radiometer df is ``nfold`` (receiver.py:163-164).  Both χ² fields take
    the per-observation df: on the card the sampler's ``chi2_sel`` mode.
    Nfold below 50 (other than 1) raises ``ValueError``, unless
    ``PSS_EXACT_CHI2=1`` draws every field through the exact gamma sampler
    (one α per observation).

    Returns ``(..., Nchan, nsub*Nph)`` float32 blocks.
    """
    _hetero_df_guard(torch.as_tensor(nfold).detach().cpu().numpy())
    return _fold_pipeline_hetero(key, dm, noise_norm, nfold, draw_norm,
                                 profiles, cfg, freqs, chan_ids,
                                 extra_delays_ms, dt_ms, device)


def _fold_pipeline_hetero(key, dm, noise_norm, nfold, draw_norm, profiles,
                          cfg, freqs, chan_ids, extra_delays_ms, dt_ms,
                          device, shifted=False):
    """:func:`fold_pipeline_hetero` without the Nfold check (the ensemble
    checks once, when it stages a bucket); ``shifted`` as
    :func:`_fold_front`'s."""
    f = _fold_front(key, dm, noise_norm, profiles, cfg, freqs, chan_ids,
                    extra_delays_ms, device, dt_ms=dt_ms, shifted=shifted)

    def per_obs(v):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=f.dev).expand(f.lead)

    nfold = per_obs(nfold)
    return _fold_core(f, cfg, nfold, per_obs(draw_norm), nfold)


def noise_level(cfg, noise_norm):
    """The mean radiometer level ``noise_df · noise_norm`` in float32, the
    unit of the scenario engine's RFI levels (the JAX package's
    ``cfg.noise_df * noise_norm``)."""
    df = torch.full((), float(np.float32(cfg.noise_df)), dtype=torch.float32,
                    device=noise_norm.device)
    return df * noise_norm


def _scenario_rows(f, cfg, scenario, scenario_params):
    """The batch's scenario factors, drawn from its observation keys on the
    noise scales' device, for the channels ``f`` holds (the configuration's
    frequencies at those GLOBAL channel ids)."""
    chan_ids = f.chan_ids.cpu()
    freqs = np.asarray(cfg.meta.dat_freq_mhz(), np.float32)[chan_ids.numpy()]
    return scenario_rows(f.key, scenario, scenario_params, cfg,
                         noise_level(cfg, f.noise_norm), freqs=freqs,
                         chan_ids=chan_ids)


def fold_subints(block, nsub, nph):
    """Folded profiles ``(..., Nchan, Nph)`` of blocks ``(..., Nchan,
    nsub*Nph)``: the sum over subintegrations, added one subint after the
    other in elementwise passes, so a profile's bits depend on its own
    block only — never on the batch it was folded in (a reduction kernel
    may pick another summation order for another batch size)."""
    v = block.reshape(block.shape[:-1] + (nsub, nph))
    folded = v[..., 0, :]
    for s in range(1, nsub):
        folded = folded + v[..., s, :]
    return folded


def fused_route(cfg, device, null_frac=None):
    """Whether the fold → quantize → pack body runs as the one fused kernel
    (:func:`fold_pipeline_quantized`): on a CUDA device, with the ``hw``
    sampler, in envelope mode, without nulling, and with both χ² dfs (the
    pulse's Nfold and the noise's) in the sampler's modes.  Decided from
    the configuration alone, before anything is launched; the threefry
    parity sampler (``PSS_SAMPLER=threefry``), ``PSS_EXACT_SHIFT=1``, the
    CPU, and a df the reference draws through the exact gamma sampler (a
    static df below 50 other than 1; ``PSS_EXACT_CHI2=1`` selects threefry)
    keep the unfused path, whose fields come from ``chan_chi2_field``.  A
    scenario stack does not change the route: the kernel takes its
    factors."""
    return (torch.device(device).type == "cuda"
            and sampler_backend(device) == "hw"
            and cfg.shift_mode == "envelope" and null_frac is None
            and _hw_chi2_mode(cfg.nfold) is not None
            and _hw_chi2_mode(cfg.noise_df) is not None)


def fold_pipeline_quantized(key, dm, noise_norm, profiles, cfg, freqs=None,
                            chan_ids=None, extra_delays_ms=None,
                            byte_order="little", device=None, scenario=None,
                            scenario_params=None, rows=None):
    """:func:`fold_pipeline` in envelope mode on the ``hw`` sampler's
    stream, quantized per (subint, channel) and packed, in one kernel
    (:func:`~psrsigsim_torch.ops.fold_quantize.fold_quantize`): the float
    block never exists.

    Arguments as for :func:`fold_pipeline`; ``byte_order="big"``
    byte-swaps the codes.  A scenario's gains, energies and RFI levels
    enter the kernel as per-row factors, in the unfused order.  Returns ``(packed, finite)``: ``(..., nsub,
    Nchan, Nph+4)`` int16 (codes, then DAT_SCL and DAT_OFFS as int16
    halves, the layout ``FoldEnsemble.iter_chunks`` transports) and the
    ``(..., Nchan)`` finite guard.  The codes equal the unfused path's
    (hw fields → :func:`fold_pipeline` → ``subint_quantize`` → pack) bit
    for bit.
    """
    if cfg.shift_mode != "envelope":
        raise ValueError("the fused route shifts the periodic envelope; "
                         f"shift_mode={cfg.shift_mode!r} takes fold_pipeline")
    f = _fold_front(key, dm, noise_norm, profiles, cfg, freqs, chan_ids,
                    extra_delays_ms, device)
    modes = (_hw_chi2_mode(cfg.nfold), _hw_chi2_mode(cfg.noise_df))
    for df, mode in zip((cfg.nfold, cfg.noise_df), modes):
        if mode is None:
            raise ValueError(
                f"chi2 df={df}: the fused kernel draws df=1 or df >= "
                f"{CHI2_WH_MIN_DF:.0f}; this df takes the exact gamma "
                "sampler on the unfused path (see fused_route)")
    nchan = f.profiles.shape[0]
    # the seed words of both stages and their dfs cross in one copy each
    with span("keys"):
        words = seed_words(torch.stack([f.kp, f.kn]).reshape(2, -1, 2))
    seeds = to_device(words, f.dev)
    B = seeds.shape[1]
    dfs = torch.tensor([[0.0 if m == "chi2_1" else df] * B
                        for df, m in zip((cfg.nfold, cfg.noise_df), modes)],
                       dtype=torch.float32)
    if rows is None and scenario is not None:
        rows = _scenario_rows(f, cfg, scenario, scenario_params)
    factors = {}
    if rows is not None:
        for name, t, shape in (("gain", rows.gain, (B, nchan, cfg.nsub)),
                               ("energy", rows.energy, (B, cfg.nsub)),
                               ("level", rows.level, (B, nchan, cfg.nsub))):
            if t is not None:
                factors[name] = t.reshape(shape).contiguous()
    packed, finite = fold_quantize(
        seeds, to_device(dfs, f.dev), modes,
        f.prof.expand(f.lead + (nchan, cfg.nph)).reshape(
            B, nchan, cfg.nph).contiguous(),
        f.noise_norm.reshape(B).contiguous(), nsub=cfg.nsub,
        draw_norm=cfg.draw_norm, chan0=int(f.chan_ids[0]), t0=0,
        byte_order=byte_order, **factors)
    return (packed.reshape(f.lead + packed.shape[1:]),
            finite.reshape(f.lead + (nchan,)))


def natural_nbin(signal, pulsar):
    """Phase bins per period at the signal's sample rate —
    ``int(samprate * period)`` (reference: pulsar.py:124)."""
    return int((signal.samprate * pulsar.period).decompose())


def build_fold_config(signal, pulsar, telescope, system, Tsys=None,
                      nbin=None, shift_mode=None):
    """Derive the static config + host inputs for :func:`fold_pipeline`
    from configured objects (without generating any data).

    Returns ``(cfg, profiles_np, noise_norm)``.  ``nbin`` overrides the
    phase resolution (the portrait is evaluated at exactly ``nbin`` bins
    and the sample spacing becomes ``period / nbin``).  Host-side, the same
    arithmetic as the JAX package's ``build_fold_config``, so both give
    equal configs for equal objects.
    """
    if not signal.fold:
        raise ValueError("build_fold_config requires a fold-mode FilterBankSignal")

    period_s = float(pulsar.period.to("s").value)
    nph = int(nbin) if nbin is not None else natural_nbin(signal, pulsar)
    if nph <= 0:
        raise ValueError(f"nbin={nbin} must be positive")
    tobs = signal.tobs
    if tobs is None:
        raise ValueError("set signal._tobs first")
    if signal.sublen is None:
        nsub = 1
        sublen_s = float(tobs.to("s").value)
    else:
        sublen_s = float(signal.sublen.to("s").value)
        nsub = int(np.round(float((tobs / signal.sublen).decompose())))
    nfold = sublen_s / period_s

    # profile normalization + Smax on host (reference: pulsar.py:124-151)
    if pulsar.ref_freq is None:
        pulsar._ref_freq = signal.fcent
    if signal.sigtype == "FilterBankSignal" and pulsar.specidx != 0.0:
        pulsar._add_spec_idx(signal)
    pulsar.Profiles.init_profiles(nph, signal.Nchan)
    profiles_np = np.asarray(pulsar.Profiles.profiles, dtype=np.float32)
    pr = pulsar.Profiles._max_profile
    signal._Smax = pulsar.Smean * len(pr) / float(np.sum(pr))

    # the signal bookkeeping make_pulses would do; under an nbin override
    # nsamp follows the padded resolution
    signal._nsub = nsub
    if nbin is None:
        signal._nsamp = int(nsub * period_s
                            * float(signal.samprate.to("MHz").value) * 1e6)
    else:
        signal._nsamp = nsub * nph
    signal._Nfold = nfold
    signal._set_draw_norm(df=nfold)
    if signal.sublen is None:
        signal._sublen = tobs

    rcvr, _ = telescope.systems[system]
    tsys = rcvr._resolve_tsys(Tsys if Tsys is not None else telescope.Tsys, None)
    noise_norm, noise_df = rcvr._pow_noise_norm(signal, tsys, telescope.gain, pulsar)

    if nbin is None:
        dt_ms = float((1 / signal.samprate).to("ms").value)
    else:
        dt_ms = period_s * 1e3 / nph  # padded effective sample spacing

    cfg = FoldPipelineConfig(
        meta=signal.meta(),
        period_s=period_s,
        nsub=nsub,
        nph=nph,
        nfold=float(nfold),
        draw_norm=float(signal._draw_norm),
        noise_df=float(noise_df),
        dt_ms=dt_ms,
        clip_max=float(signal._draw_max),
        shift_mode=default_shift_mode() if shift_mode is None else shift_mode,
    )
    return cfg, profiles_np, float(noise_norm)


# ---------------------------------------------------------------------------
# Single-pulse / SEARCH-mode pipeline (BASELINE config 4)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SinglePipelineConfig:
    """Static configuration of a single-pulse (SEARCH-mode) observation
    (reference: ``SinglePipelineConfig``).  An integer number of samples
    per period, so the portrait at every sample is its tiling."""

    meta: SignalMeta
    period_s: float
    nph: int          # samples per period
    nsub: int         # number of pulses in the stream
    nsamp: int        # total samples (= int(tobs * samprate))
    draw_norm: float  # int8 dynamic-range scaling (fb_signal.py:114-121)
    noise_df: float   # chi2 df of the radiometer noise draws (1 for search)
    dt_ms: float
    clip_max: float
    n_null: int = 0          # pulses to null (round(nsub * null_frac))
    null_df: float = 1.0     # chi2 df of replacement noise (pulsar.py:297)
    off_pulse_mean: float = 0.0  # mean off-pulse level (pulsar.py:301)
    peak_bin: int = 0        # argmax of channel-0 profile (pulse alignment)
    shift_mode: str = "envelope"  # see default_shift_mode


def _search_chi2(key, chan_ids, df, nsamp, nchan_global=None):
    """SEARCH-mode χ² fields ``(..., C, nsamp)`` from the FLAT whole-tile
    stream at channel-major flat offsets ``c * nsamp + t`` (reference:
    ``_search_chi2``).  Under ``PSS_EXACT_CHI2=1``, a small static df or a
    GLOBAL extent ``nchan_global * nsamp`` past the int32 offsets, the
    per-channel-keyed fields instead — the guard reads the global extent,
    so a channel slab and the whole band pick the same realization."""
    nc = int(chan_ids.shape[0])
    span_end = int(nchan_global if nchan_global is not None else nc) \
        * int(nsamp)
    if not flat_chi2_ok(df, span_end=span_end):
        return _chan_chi2(key, chan_ids, df, nsamp)
    f0 = int(chan_ids[0]) * int(nsamp)
    field = flat_chi2_field(key, f0, nc * int(nsamp), df)
    return field.reshape(key.shape[:-1] + (nc, int(nsamp)))


def _null_mask_at(key, cfg, gidx):
    """Nulled-pulse membership at global sample indices ``gidx`` for
    observation keys ``(..., 2)``: ``(..., *gidx.shape)`` bool (reference:
    ``_null_mask_at``).  The pulses come from jax's permutation on the
    ``"null_select"`` stage, drawn where the keys lie; the window of pulse
    ``p`` starts at ``p * nph + nph // 2 - peak_bin``."""
    lead = key.shape[:-1]
    sel = permutation(stage_key(key, "null_select"), cfg.nsub)
    sel = sel[..., :cfg.n_null].to(gidx.device)
    nulled = torch.zeros(lead + (cfg.nsub + 1,), dtype=torch.bool,
                         device=gidx.device)              # +1: guard row
    nulled.scatter_(-1, sel, True)
    shift_val = cfg.nph // 2 - cfg.peak_bin
    pulse_id = torch.div(gidx - shift_val, cfg.nph, rounding_mode="floor")
    in_range = (pulse_id >= 0) & (pulse_id < cfg.nsub)
    idx = pulse_id.clamp(0, cfg.nsub).reshape(-1)
    hit = nulled[..., idx].reshape(lead + tuple(gidx.shape))
    return hit & in_range


def _null_mask_row(key, cfg, t0, length, device):
    """One mask row per observation over global samples ``[t0,
    t0+length)``: ``(..., length)`` bool on ``device``."""
    gidx = torch.arange(t0, t0 + length, dtype=torch.int64, device=device)
    return _null_mask_at(key, cfg, gidx)


def _roll_rows(row, shifts, t0=0, length=None):
    """``jnp.roll(row[b], shifts[b, c])`` for every channel: rows ``(B,
    n)`` and integer shifts ``(B, C)`` -> ``(B, C, n)``, each output sample
    ``row[b, (t - shift) mod n]``.  One gather pass: each (b, c) row is the
    window of the doubled row starting at ``(-shift) mod n``.  ``t0`` and
    ``length`` keep samples ``[t0, t0 + length)`` of each rolled row only
    (a time slab)."""
    n = row.shape[-1]
    length = n if length is None else int(length)
    doubled = torch.cat([row, row], dim=-1)
    windows = doubled.unfold(-1, length, 1)   # (B, 2n - length + 1, length)
    start = torch.remainder(int(t0) - shifts.to(torch.int64), n)
    b = torch.arange(row.shape[0], device=row.device)[:, None]
    return windows[b, start]


def _tile_periodic(block, prof, nph):
    """Multiply ``block`` ``(..., C, nsamp)`` in place by the portrait
    ``prof`` ``(..., C, nph)`` tiled over time, ``prof[..., n % nph]``
    (reference: ``_tile_periodic``, whose product commutes with this
    one): whole periods through a view, the ragged tail by a slice."""
    nsamp = block.shape[-1]
    k = nsamp // nph
    if k:
        block[..., :k * nph].unflatten(-1, (k, nph)).mul_(prof[..., None, :])
    if k * nph < nsamp:
        block[..., k * nph:].mul_(prof[..., :nsamp - k * nph])
    return block


def single_pipeline(key, dm, noise_norm, profiles, cfg, freqs=None,
                    chan_ids=None, extra_delays_ms=None, device=None,
                    scenario=None, scenario_params=None, rows=None):
    """SEARCH-mode observations: single-pulse synthesis (χ² df = 1),
    pulse nulling, dispersion and radiometer noise — the reference's
    ``make_pulses(fold=False) -> null -> disperse -> observe`` chain
    (reference: ``single_pipeline``).

    Arguments as :func:`fold_pipeline` (keys ``(..., 2)`` with one DM and
    one noise scale per key; ``profiles`` the ``(Nchan, Nph)`` portrait).
    Both χ² fields come from the flat whole-tile stream (on the card the
    sampler kernel's flat layout).  Nulling (``cfg.n_null`` pulses, drawn
    on the ``"null_select"`` stage) replaces each nulled pulse window by
    one off-pulse noise row per observation, keyed by the pseudo-channel
    id ``Nchan``; in envelope mode the windows ride the dispersion as
    circular integer rolls.  ``scenario``/``scenario_params``/``rows``:
    as :func:`fold_pipeline`, with one pulse as the time cell —
    scintillation gains and pulse energies multiply the pulse term before
    nulling, RFI levels ride on top of the radiometer noise.

    Returns:
        ``(..., Nchan, nsamp)`` float32 blocks (unclipped).
    """
    f = _fold_front(key, dm, noise_norm, profiles, cfg, freqs, chan_ids,
                    extra_delays_ms, device)
    dev, lead = f.dev, f.lead
    nsamp, nph, nsub = cfg.nsamp, cfg.nph, cfg.nsub
    nchan = cfg.meta.nchan

    # pulse term: the tiled portrait x chi2(1) x draw_norm
    block = _search_chi2(to_device(f.kp, dev), f.chan_ids, 1.0, nsamp, nchan)
    _tile_periodic(block, f.prof if cfg.shift_mode == "envelope"
                   else f.profiles, nph)
    if cfg.draw_norm != 1.0:
        block.mul_(cfg.draw_norm)

    if rows is None and scenario is not None:
        rows = _scenario_rows(f, cfg, scenario, scenario_params)
    if rows is not None:
        # multiplicative effects modulate the pulse term only
        apply_scenario_pulse_search(block, rows, nsub, nph)

    if cfg.n_null > 0:
        # one replacement-noise row per observation, broadcast to every
        # channel (pulsar.py:304), keyed by the pseudo-channel id Nchan
        knz = to_device(stage_key(f.key, "null_noise"), dev)
        repl = _chan_chi2(knz, torch.tensor([nchan]), cfg.null_df,
                          nsamp)[..., 0, :]
        if cfg.draw_norm != 1.0:
            repl.mul_(cfg.draw_norm)
        repl.mul_(cfg.off_pulse_mean)
        mask_row = _null_mask_row(f.key, cfg, 0, nsamp, dev)
        if cfg.shift_mode == "envelope":
            # the windows ride the dispersion: integer delays (XLA divides
            # by the constant dt as a multiply by its float32 reciprocal,
            # rounds half to even), circular rolls of the shared row
            inv_dt = float(np.float32(1.0) / np.float32(cfg.dt_ms))
            dint = torch.round(f.obs_delays_ms() * inv_dt).to(torch.int64)
            mask = _roll_rows(mask_row.reshape(-1, nsamp),
                              dint.reshape(-1, dint.shape[-1]))
            mask = mask.reshape(block.shape)
        else:
            mask = mask_row[..., None, :]
        torch.where(mask, repl[..., None, :], block, out=block)

    if cfg.shift_mode != "envelope":
        # dispersion (+ FD/scatter) as one batched full-stream shift
        block = fourier_shift(block, f.delays_ms, dt=cfg.dt_ms)

    # radiometer noise, chi2 df=1 in search mode (receiver.py:160-164)
    noise = _search_chi2(to_device(f.kn, dev), f.chan_ids, cfg.noise_df,
                         nsamp, nchan)
    noise.mul_(f.noise_norm[..., None, None])
    block.add_(noise)
    del noise
    if rows is not None:
        # additive effects (RFI) ride on top of the radiometer noise
        apply_scenario_additive_search(block, rows, nsub, nph)
    return block


def build_single_config(signal, pulsar, telescope, system, Tsys=None,
                        null_frac=0.0, shift_mode=None):
    """Derive the static config + host inputs for :func:`single_pipeline`
    from configured objects (reference: ``build_single_config``; semantics
    pulsar.py:222-244).  Returns ``(cfg, profiles_np, noise_norm)``."""
    if signal.fold:
        raise ValueError("build_single_config requires fold=False (SEARCH mode)")

    period_s = float(pulsar.period.to("s").value)
    spp = float((signal.samprate * pulsar.period).decompose())
    nph = int(round(spp))
    if abs(spp - nph) > 1e-6 * max(1.0, nph):
        raise ValueError(
            f"samples per period must be integral for the in-graph SEARCH "
            f"pipeline (got {spp}); use the OO path for fractional sampling"
        )
    tobs = signal.tobs
    if tobs is None:
        raise ValueError("set signal._tobs (or pass tobs through Simulation) first")
    tobs_s = float(tobs.to("s").value)
    nsub = int(np.round(tobs_s / period_s))
    nsamp = int(tobs_s * float(signal.samprate.to("MHz").value) * 1e6)

    if pulsar.ref_freq is None:
        pulsar._ref_freq = signal.fcent
    if signal.sigtype == "FilterBankSignal" and pulsar.specidx != 0.0:
        pulsar._add_spec_idx(signal)
    pulsar.Profiles.init_profiles(nph, signal.Nchan)
    profiles_np = np.asarray(pulsar.Profiles.profiles, dtype=np.float32)
    pr = pulsar.Profiles._max_profile
    signal._Smax = pulsar.Smean * len(pr) / float(np.sum(pr))

    # signal bookkeeping as make_pulses(fold=False) would do (pulsar.py:222-236)
    signal._sublen = pulsar.period
    signal._nsub = nsub
    signal._nsamp = nsamp
    signal._Nfold = None
    signal._set_draw_norm(df=1)

    # nulling statics (reference: pulsar.py:246-333)
    n_null = int(np.round(nsub * null_frac))
    opw = pulsar.Profiles._calcOffpulseWindow(Nphase=nph)
    off_pulse_mean = float(np.mean(pr[np.asarray(opw, int)]))
    peak_bin = int(np.argmax(profiles_np[0]))

    rcvr, _ = telescope.systems[system]
    tsys = rcvr._resolve_tsys(Tsys if Tsys is not None else telescope.Tsys, None)
    noise_norm, noise_df = rcvr._pow_noise_norm(signal, tsys, telescope.gain, pulsar)

    cfg = SinglePipelineConfig(
        meta=signal.meta(),
        period_s=period_s,
        nph=nph,
        nsub=nsub,
        nsamp=nsamp,
        draw_norm=float(signal._draw_norm),
        noise_df=float(noise_df),
        dt_ms=float((1 / signal.samprate).to("ms").value),
        clip_max=float(signal._draw_max),
        n_null=n_null,
        null_df=1.0,
        off_pulse_mean=off_pulse_mean,
        peak_bin=peak_bin,
        shift_mode=default_shift_mode() if shift_mode is None else shift_mode,
    )
    return cfg, profiles_np, float(noise_norm)


# ---------------------------------------------------------------------------
# Baseband coherent-dedispersion pipeline (BASELINE config 3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BasebandPipelineConfig:
    """Static configuration of a baseband (amplitude-signal) observation
    (reference: ``BasebandPipelineConfig``): Nyquist-sampled voltage-like
    data, coherent dispersion by the L&K eq 5.21 transfer function
    (pulsar.py:153-183, ism.py:76-98).  ``os_plan`` is the pow2-block
    overlap-save plan of the dedispersion FFT (:class:`~psrsigsim_torch.
    ops.shift.OSPlan`; None = the exact monolithic FFT)."""

    meta: SignalMeta
    period_s: float
    nph: int
    nsamp: int
    fcent_mhz: float
    bw_mhz: float
    dt_us: float
    os_plan: object = None


def baseband_pipeline(key, dm, noise_norm, sqrt_profiles, cfg, device=None):
    """Baseband observations (reference: ``baseband_pipeline``): amplitude
    synthesis (the tiled sqrt-profile × N(0, 1); pulsar.py:153-183),
    coherent dispersion of every polarization channel (ism.py:76-98) and
    amplitude radiometer noise (receiver.py:123-138).

    Args:
        key: observation keys ``(..., 2)``.
        dm: dispersion measures ``(...)`` (a per-observation DM: the
            transfer function's double-float branch).
        noise_norm: amplitude noise scales ``(...)`` (from
            ``Receiver._amp_noise_norm``; 0 disables the noise).
        sqrt_profiles: ``sqrt(profile)`` at each phase bin, ``(Npol, Nph)``;
            a tensor fixes the device, numpy goes to ``device`` (default:
            the CUDA card).
        cfg: static :class:`BasebandPipelineConfig`.

    Both the pulse and the noise normals come from the FLAT pol-major
    stream (``flat_normal_field(k, 0, Npol·nsamp)``): on the card one
    launch of the sampler's flat layout per stage for the whole batch.
    Dispersion takes the overlap-save plan when ``cfg.os_plan`` is set,
    else the full-length circular filter.

    Returns ``(..., Npol, nsamp)`` float32.
    """
    if isinstance(sqrt_profiles, torch.Tensor):
        dev = sqrt_profiles.device
    else:
        dev = resolve_device(device)
        sqrt_profiles = torch.as_tensor(
            np.asarray(sqrt_profiles, np.float32), device=dev)
    key = as_key(key) if isinstance(key, torch.Tensor) else as_key(key, "cpu")
    lead = key.shape[:-1]
    f32 = torch.float32
    dm = torch.as_tensor(dm, dtype=f32, device=dev).expand(lead)
    noise_norm = torch.as_tensor(noise_norm, dtype=f32, device=dev).expand(lead)
    kp = to_device(stage_key(key, "pulse"), dev)
    kn = to_device(stage_key(key, "noise"), dev)
    nsamp = cfg.nsamp
    npol = sqrt_profiles.shape[0]
    shape = lead + (npol, nsamp)

    # amplitude = the tiled sqrt-profile x the flat normal stream, written
    # into the stream in place (the product commutes)
    block = flat_normal_field(kp, 0, npol * nsamp).reshape(shape)
    _tile_periodic(block, sqrt_profiles, cfg.nph)

    if cfg.os_plan is not None:
        block = coherent_dedisperse_os(block, dm, cfg.fcent_mhz, cfg.bw_mhz,
                                       cfg.dt_us, cfg.os_plan)
    else:
        block = coherent_dedisperse(block, dm, cfg.fcent_mhz, cfg.bw_mhz,
                                    cfg.dt_us)

    noise = flat_normal_field(kn, 0, npol * nsamp).reshape(shape)
    noise.mul_(noise_norm[..., None, None])
    return block.add_(noise)


def build_baseband_config(signal, pulsar, telescope=None, system=None,
                          Tsys=None, dm_max=None, exact_fft=None):
    """Derive the static config + host inputs for :func:`baseband_pipeline`
    (reference: ``build_baseband_config``).  Returns ``(cfg,
    sqrt_profiles_np, noise_norm)``; ``noise_norm`` is 0 without a
    telescope and system (noise then enters through
    ``Receiver.radiometer_noise``).

    ``dm_max`` sizes the overlap-save plan (default: the signal's DM; the
    plan holds for any ``|dm| <= dm_max``).  ``exact_fft=True`` (or
    ``PSS_EXACT_SHIFT=1``) keeps the monolithic FFT whatever the length.
    """
    if signal.sigtype != "BasebandSignal":
        raise ValueError("build_baseband_config requires a BasebandSignal")

    period_s = float(pulsar.period.to("s").value)
    spp = float((signal.samprate * pulsar.period).decompose())
    nph = int(round(spp))
    if abs(spp - nph) > 1e-6 * max(1.0, nph):
        raise ValueError(
            f"samples per period must be integral for the in-graph baseband "
            f"pipeline (got {spp}); use the OO path for fractional sampling"
        )
    tobs = signal.tobs
    if tobs is None:
        raise ValueError("set signal._tobs (or pass tobs through Simulation) first")
    tobs_s = float(tobs.to("s").value)
    nsamp = int(tobs_s * float(signal.samprate.to("MHz").value) * 1e6)

    if pulsar.ref_freq is None:
        pulsar._ref_freq = signal.fcent
    pulsar.Profiles.init_profiles(nph, signal.Nchan)
    profiles_np = np.asarray(pulsar.Profiles.profiles, dtype=np.float64)
    pr = pulsar.Profiles._max_profile
    signal._Smax = pulsar.Smean * len(pr) / float(np.sum(pr))
    signal._nsamp = nsamp

    noise_norm = 0.0
    if telescope is not None and system is not None:
        rcvr, _ = telescope.systems[system]
        tsys = rcvr._resolve_tsys(
            Tsys if Tsys is not None else telescope.Tsys, None
        )
        noise_norm = rcvr._amp_noise_norm(signal, tsys, telescope.gain, pulsar)

    if exact_fft is None:
        exact_fft = bool(os.environ.get("PSS_EXACT_SHIFT"))
    if dm_max is None and signal.dm is not None:
        dm_max = float(signal.dm.value)
    fcent_mhz = float(signal.fcent.to("MHz").value)
    bw_mhz = float(signal.bw.to("MHz").value)
    dt_us = float((1 / signal.samprate).to("us").value)
    os_plan = None
    if not exact_fft and dm_max:
        os_plan = plan_dedisperse_os(nsamp, dm_max, fcent_mhz, bw_mhz, dt_us)

    cfg = BasebandPipelineConfig(
        meta=signal.meta(),
        period_s=period_s,
        nph=nph,
        nsamp=nsamp,
        fcent_mhz=fcent_mhz,
        bw_mhz=bw_mhz,
        dt_us=dt_us,
        os_plan=os_plan,
    )
    return cfg, np.sqrt(profiles_np).astype(np.float32), float(noise_norm)
