"""The scenario registry: each physical effect declared once (counterpart:
psrsigsim_tpu/scenarios/registry.py).

An effect entry names everything the entry points need: its draws
(:mod:`psrsigsim_torch.ops.scenario`), its RNG stage
(:data:`psrsigsim_torch.utils.rng.STAGES`), its parameter schema (name,
default, bounds — a Monte-Carlo prior knob) and its modes.  A
:class:`ScenarioStack` is the selection of enabled effects (with a mode
where an effect has modes); per-observation parameters follow
:meth:`ScenarioStack.param_names`.

The invariants every effect honours, as in the JAX package:

* **disabled is free** — ``stack=None`` never enters the code below: a
  scenario-free build runs exactly the pre-scenario path and writes the
  same bytes;
* **keyed draws only** — every random quantity keys off the observation
  (or trial) key via the effect's own stage, folded by GLOBAL integers
  (channel ids, subint ids, scintle cells), so results are bit-identical
  for any chunk size.

:func:`scenario_rows` draws everything one batch needs, once: the
per-(observation, channel, subint) factors the fold body multiplies and
adds, and the RFI ground truth.  The unfused body, the fused kernel's
launch, the Monte-Carlo trial and the truth mask all read from it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops import scenario_draws
from ..ops.scenario import pulse_energies, rfi_levels, scint_gain
from ..runtime.telemetry import count, span
from ..utils.device import to_device
from ..utils.rng import STAGES, fold_in

__all__ = ["EffectParam", "Effect", "EFFECTS", "EFFECT_ORDER",
           "SP_MODE_KNOBS", "ScenarioStack", "ScenarioRows", "parse_stack",
           "stack_label", "scenario_knobs", "stack_from_knobs", "param_dict",
           "default_params", "scenario_rows", "apply_scenario_pulse",
           "apply_scenario_additive", "apply_scenario_pulse_search",
           "apply_scenario_additive_search", "apply_pulse_effects",
           "apply_additive_effects", "apply_pulse_effects_search",
           "apply_additive_effects_search", "rfi_truth_mask", "energy_truth"]


@dataclasses.dataclass(frozen=True)
class EffectParam:
    """One parameter of an effect: the schema behind the Monte-Carlo prior
    knob and the default used when a caller leaves the knob unset."""

    name: str        # fully qualified, effect-prefixed ("scint_dnu_d_mhz")
    default: float
    lo: float
    hi: float
    doc: str


@dataclasses.dataclass(frozen=True)
class Effect:
    """One registered physical effect (declarative; the draws live in
    :func:`scenario_rows`, dispatched by name)."""

    name: str
    stage: str               # RNG stage (utils/rng.py STAGES)
    params: tuple            # EffectParam, canonical order
    modes: tuple = ()        # modes; () = modeless
    default_mode: str = ""
    doc: str = ""

    def param_names(self):
        return tuple(p.name for p in self.params)


def _register(effect, table):
    if effect.name in table:
        raise ValueError(f"duplicate effect {effect.name!r}")
    taken = {p.name for e in table.values() for p in e.params}
    clash = taken & {p.name for p in effect.params}
    if clash:
        raise ValueError(
            f"effect {effect.name!r} re-declares parameter(s) "
            f"{sorted(clash)} owned by another effect")
    table[effect.name] = effect
    return effect


EFFECTS = {}

_register(Effect(
    name="scintillation",
    stage="scint",
    params=(
        EffectParam("scint_dnu_d_mhz", 50.0, 1e-4, 1e5,
                    "scintillation bandwidth at band center (MHz); "
                    "scaled per channel by the thin-screen nu^4.4 law"),
        EffectParam("scint_dt_d_s", 60.0, 1e-3, 1e7,
                    "scintillation timescale at band center (s); "
                    "scaled per channel by nu^1.2"),
        EffectParam("scint_mod", 1.0, 0.0, 1.0,
                    "modulation index: 0 = no modulation, 1 = saturated "
                    "strong scintillation (unit-mean exponential gains)"),
    ),
    doc="per-(channel, subint) dynamic-spectrum gain screen drawn from "
        "scintle-cell-folded keys (ops.scenario.scint_gain)",
), EFFECTS)

_register(Effect(
    name="rfi",
    stage="rfi",
    params=(
        EffectParam("rfi_imp_prob", 0.1, 0.0, 1.0,
                    "per-subint probability of a broadband impulsive "
                    "burst"),
        EffectParam("rfi_imp_snr", 5.0, 0.0, 1e4,
                    "impulsive burst level in units of the mean "
                    "radiometer noise level"),
        EffectParam("rfi_nb_prob", 0.1, 0.0, 1.0,
                    "per-channel probability of a persistent narrowband "
                    "tone"),
        EffectParam("rfi_nb_snr", 3.0, 0.0, 1e4,
                    "narrowband tone level in units of the mean "
                    "radiometer noise level"),
    ),
    doc="impulsive + narrowband RFI injection with a ground-truth "
        "contamination mask (ops.scenario.rfi_levels)",
), EFFECTS)

_register(Effect(
    name="single_pulse",
    stage="transient",
    params=(
        EffectParam("sp_sigma", 0.5, 0.0, 5.0,
                    "log-normal mode: log-energy width sigma "
                    "(unit-mean pulse-energy distribution)"),
        EffectParam("sp_alpha", 2.5, 1.05, 10.0,
                    "power-law mode: Pareto index alpha (unit-mean "
                    "giant-pulse tail)"),
        EffectParam("sp_amp", 10.0, 0.0, 1e4,
                    "frb mode: amplitude of the one-off burst in "
                    "envelope units"),
    ),
    modes=("lognormal", "powerlaw", "frb"),
    default_mode="lognormal",
    doc="per-pulse energy distribution modulating the fold envelope "
        "(ops.scenario.pulse_energies); frb mode emits exactly one burst",
), EFFECTS)

#: canonical effect order — stacks and parameter lists follow it
EFFECT_ORDER = tuple(EFFECTS)

#: which parameter selects which single_pulse mode (Monte-Carlo inference)
SP_MODE_KNOBS = {"sp_sigma": "lognormal", "sp_alpha": "powerlaw",
                 "sp_amp": "frb"}


@dataclasses.dataclass(frozen=True)
class ScenarioStack:
    """The enabled-effect selection: ``((name, mode), ...)`` in
    :data:`EFFECT_ORDER` order.  Frozen and hashable."""

    entries: tuple

    def __bool__(self):
        return bool(self.entries)

    def names(self):
        return tuple(n for n, _ in self.entries)

    def mode(self, name):
        for n, m in self.entries:
            if n == name:
                return m
        return None

    def labels(self):
        """Canonical string form, one per effect: ``name`` (modeless or
        default mode) / ``name:mode``."""
        out = []
        for n, m in self.entries:
            eff = EFFECTS[n]
            out.append(n if (not eff.modes or m == eff.default_mode)
                       else f"{n}:{m}")
        return out

    def label(self):
        """One stable human-readable id for counters and metrics."""
        return stack_label(self.labels())

    def param_names(self):
        """Parameter layout: every enabled effect's parameters in registry
        order (mode-independent, so a mode switch never moves another
        parameter's slot)."""
        return tuple(p for n, _ in self.entries
                     for p in EFFECTS[n].param_names())

    def describe(self):
        """JSON-able canonical form (fingerprints, manifests)."""
        return list(self.labels())


def stack_label(labels):
    """The canonical id of a list of effect labels (``"base"`` when
    empty)."""
    labels = list(labels)
    return "+".join(labels) if labels else "base"


def parse_stack(items):
    """A :class:`ScenarioStack` from effect labels (``"name"`` /
    ``"name:mode"`` strings or ``(name, mode)`` pairs), canonicalized to
    :data:`EFFECT_ORDER`; ``None`` for an empty selection.  Raises
    ValueError naming every bad entry at once."""
    if items is None:
        return None
    if isinstance(items, ScenarioStack):
        return items if items.entries else None
    errors = []
    chosen = {}
    for it in items:
        if isinstance(it, (tuple, list)) and len(it) == 2:
            name, mode = str(it[0]), str(it[1])
        else:
            name, _, mode = str(it).partition(":")
        eff = EFFECTS.get(name)
        if eff is None:
            errors.append(f"unknown effect {name!r}; known: "
                          f"{list(EFFECT_ORDER)}")
            continue
        if eff.modes:
            mode = mode or eff.default_mode
            if mode not in eff.modes:
                errors.append(f"{name}: unknown mode {mode!r}; valid: "
                              f"{list(eff.modes)}")
                continue
        elif mode:
            errors.append(f"{name}: takes no mode, got {mode!r}")
            continue
        if name in chosen and chosen[name] != mode:
            errors.append(f"{name}: requested twice with modes "
                          f"{chosen[name]!r} and {mode!r}")
            continue
        chosen[name] = mode
    if errors:
        raise ValueError("invalid scenario selection: " + "; ".join(errors))
    entries = tuple((n, chosen[n]) for n in EFFECT_ORDER if n in chosen)
    return ScenarioStack(entries) if entries else None


def scenario_knobs():
    """Every registered parameter name in canonical order — the
    Monte-Carlo study appends these to its knob table."""
    return tuple(p for n in EFFECT_ORDER for p in EFFECTS[n].param_names())


def stack_from_knobs(knob_names):
    """The stack a set of prior knobs implies: any ``scint_*`` knob enables
    scintillation, any ``rfi_*`` knob RFI, and exactly one single-pulse
    mode selector (:data:`SP_MODE_KNOBS`) single_pulse in that mode.
    ``None`` when no scenario knob is present."""
    present = set(knob_names)
    labels = []
    if present & set(EFFECTS["scintillation"].param_names()):
        labels.append("scintillation")
    if present & set(EFFECTS["rfi"].param_names()):
        labels.append("rfi")
    sp = sorted(present & set(SP_MODE_KNOBS))
    if len(sp) > 1:
        raise ValueError(
            f"single_pulse mode is ambiguous: priors declare {sp}, which "
            f"select modes {[SP_MODE_KNOBS[k] for k in sp]}; declare "
            "exactly one of sp_sigma (lognormal), sp_alpha (powerlaw), "
            "sp_amp (frb)")
    if sp:
        labels.append(f"single_pulse:{SP_MODE_KNOBS[sp[0]]}")
    return parse_stack(labels)


def _param(name):
    for eff in EFFECTS.values():
        for p in eff.params:
            if p.name == name:
                return p
    raise KeyError(name)


def param_dict(stack, values):
    """Name-keyed parameters of ``stack``: from a dict (registry defaults,
    as float32, fill the names it lacks) or a sequence ordered by
    :meth:`ScenarioStack.param_names`."""
    names = stack.param_names()
    if values is None:
        values = {}
    if isinstance(values, dict):
        return {n: (values[n] if n in values
                    else float(np.float32(_param(n).default)))
                for n in names}
    if len(values) != len(names):
        raise ValueError(
            f"scenario param vector has {len(values)} entries; stack "
            f"{stack.labels()} expects {len(names)}: {list(names)}")
    return {n: values[i] for i, n in enumerate(names)}


def default_params(stack):
    """Host-side default parameter vector (floats) for a stack."""
    return tuple(_param(n).default for n in stack.param_names())


_SP_PARAM = {"lognormal": "sp_sigma", "powerlaw": "sp_alpha",
             "frb": "sp_amp"}


class ScenarioRows(NamedTuple):
    """One batch's scenario factors, each None where its effect is off:
    ``gain`` ``(..., C, nsub)`` (scintillation), ``energy`` ``(...,
    nsub)`` (single-pulse energies), ``level`` ``(..., C, nsub)`` (the RFI
    level times the observation's mean noise level) and ``mask`` ``(...,
    C, nsub)`` bool (the RFI ground truth)."""

    gain: torch.Tensor | None
    energy: torch.Tensor | None
    level: torch.Tensor | None
    mask: torch.Tensor | None


def _stage_keys(keys, stages):
    """``stage_key(keys, s)`` for every stage name in ``stages`` in one
    threefry pass per fold: ``(..., len(stages), 2)``."""
    sid = torch.tensor([STAGES[s] for s in stages], dtype=torch.int64)
    return fold_in(fold_in(keys[..., None, :], sid), 0)


def _draw(keys, stack, p, *, nsub, freqs, fcent_mhz, sublen_s, f_lo_mhz,
          chan_ids, device=None, noise_level=None):
    """The raw draws of ``stack`` for observation keys ``(..., 2)``:
    ``(gain, energy, levels, mask)``, None where off.  For a CUDA
    ``device`` the keys and the parameters cross to it in one copy and the
    scenario-draws kernel derives the stage keys and draws every effect
    there; else every effect draws on the host.  ``noise_level``, where
    given, multiplies the RFI levels.  Each effect's draws are a child
    span named after the effect (a no-op with no span open)."""
    stages = [EFFECTS[n].stage for n in stack.names()]
    if keys.device.type != "cpu":
        keys = keys.cpu()
    if device is not None and torch.device(device).type == "cuda":
        keys, cols = scenario_draws.to_card(
            list(p.values()), keys.shape[:-1], torch.device(device), keys)
        p = dict(zip(p, cols))
        sk = scenario_draws.stage_keys(keys, [STAGES[s] for s in stages])
    else:
        sk = _stage_keys(keys, stages)
    gain = energy = levels = mask = None
    for (name, mode), k in zip(stack.entries, sk.unbind(-2)):
        with span(name):
            if name == "scintillation":
                gain = scint_gain(k, freqs, nsub, p["scint_dnu_d_mhz"],
                                  p["scint_dt_d_s"], p["scint_mod"],
                                  fcent_mhz, sublen_s, f_lo_mhz=f_lo_mhz)
            elif name == "rfi":
                levels, mask = rfi_levels(
                    k, chan_ids, nsub, p["rfi_imp_prob"], p["rfi_imp_snr"],
                    p["rfi_nb_prob"], p["rfi_nb_snr"], noise_level)
            elif name == "single_pulse":
                energy = pulse_energies(k, nsub, mode, p[_SP_PARAM[mode]])
    return gain, energy, levels, mask


def scenario_rows(keys, stack, params, cfg, noise_level, freqs=None,
                  chan_ids=None):
    """Everything a batch of observations draws for ``stack``, once:
    a :class:`ScenarioRows`.

    Args:
        keys: observation keys ``(..., 2)`` (on the host, for the
            pipelines).
        stack: a :class:`ScenarioStack` (or labels for :func:`parse_stack`).
        params: ``{name: scalar or (...) tensor}`` (registry defaults fill
            unset names), or a sequence in ``stack.param_names()`` order.
        cfg: the :class:`~psrsigsim_torch.simulate.FoldPipelineConfig`
            (the subintegration is the effect's time cell) or
            :class:`~psrsigsim_torch.simulate.SinglePipelineConfig` (one
            pulse is: the scintillation cell lasts a period).
        noise_level: the mean radiometer level ``noise_df · noise_norm``,
            ``(...)`` float32; RFI levels are in its units and are
            multiplied by it on its device.
        freqs: channel frequencies (MHz) on the host; default: ``cfg``'s
            grid.  The scintle cells are anchored at the GLOBAL band floor
            ``fcent - bw/2``, as the JAX package's fold path anchors them.
        chan_ids: GLOBAL channel ids; default ``arange(Nchan)``.

    The factors land on ``noise_level``'s device, and are drawn there: on
    a CUDA device by the scenario-draws kernel, from the keys and
    parameters sent in one copy, else on the host.  The batch's factor
    cells (observations × channels × subints) are counted as
    ``scenario.cells`` in the timers of the span open on this thread.
    """
    stack = parse_stack(stack)
    meta = cfg.meta
    if freqs is None:
        freqs = np.asarray(meta.dat_freq_mhz(), np.float32)
    if chan_ids is None:
        chan_ids = torch.arange(meta.nchan)
    count("scenario.cells",
          int(np.prod(keys.shape[:-1])) * len(chan_ids) * int(cfg.nsub))
    noise_level = torch.as_tensor(noise_level, dtype=torch.float32)
    dev = noise_level.device
    gain, energy, levels, mask = _draw(
        keys, stack, param_dict(stack, params), nsub=cfg.nsub, freqs=freqs,
        fcent_mhz=meta.fcent_mhz, sublen_s=(
            cfg.nfold * cfg.period_s if hasattr(cfg, "nfold")
            else cfg.period_s),
        f_lo_mhz=meta.fcent_mhz - meta.bw_mhz / 2, chan_ids=chan_ids,
        device=dev, noise_level=noise_level)
    return ScenarioRows(*(None if t is None else to_device(t, dev)
                          for t in (gain, energy, levels, mask)))


def apply_scenario_pulse(block, rows, nsub, nph):
    """Multiply blocks ``(..., C, nsub*nph)`` by the rows' gains, then
    energies, in place (the unfused order; before nulling and noise)."""
    v = block.view(block.shape[:-1] + (nsub, nph))
    if rows.gain is not None:
        v.mul_(rows.gain[..., None])
    if rows.energy is not None:
        v.mul_(rows.energy[..., None, :, None])
    return block


def apply_scenario_additive(block, rows, nsub, nph):
    """Add the rows' RFI levels to blocks ``(..., C, nsub*nph)`` in place
    (after the radiometer noise)."""
    if rows.level is not None:
        block.view(block.shape[:-1] + (nsub, nph)).add_(rows.level[..., None])
    return block


def apply_pulse_effects(key, block, stack, params, *, nsub, nph, freqs,
                        fcent_mhz, sublen_s, f_lo_mhz):
    """Multiplicative effects on synthesized pulse blocks ``(..., C,
    nsub*nph)`` for observation keys ``(..., 2)`` on the host:
    scintillation gains, then single-pulse energies (BEFORE nulling and
    radiometer noise).  ``f_lo_mhz`` is the GLOBAL band floor."""
    stack = parse_stack(stack)
    freqs = torch.as_tensor(freqs, dtype=torch.float32).to("cpu")
    gain, energy, _, _ = _draw(
        key, ScenarioStack(tuple(e for e in stack.entries if e[0] != "rfi")),
        param_dict(stack, params), nsub=nsub, freqs=freqs,
        fcent_mhz=fcent_mhz, sublen_s=sublen_s, f_lo_mhz=f_lo_mhz,
        chan_ids=None)
    rows = ScenarioRows(
        None if gain is None else to_device(gain, block.device),
        None if energy is None else to_device(energy, block.device),
        None, None)
    return apply_scenario_pulse(block, rows, nsub, nph)


def apply_additive_effects(key, block, stack, params, *, nsub, nph,
                           chan_ids, noise_level):
    """Additive effects on post-noise blocks ``(..., C, nsub*nph)``: RFI
    rides on top of the radiometer noise, in units of ``noise_level``
    (``noise_df · noise_norm``, one per observation)."""
    stack = parse_stack(stack)
    if stack is None or "rfi" not in stack.names():
        return block
    _, _, levels, _ = _draw(
        key, ScenarioStack((("rfi", ""),)), param_dict(stack, params),
        nsub=nsub, freqs=None, fcent_mhz=None, sublen_s=None, f_lo_mhz=None,
        chan_ids=chan_ids)
    level = torch.as_tensor(noise_level, dtype=torch.float32,
                            device=block.device)
    rows = ScenarioRows(None, None, to_device(levels, block.device)
                        * level[..., None, None], None)
    return apply_scenario_additive(block, rows, nsub, nph)


def _per_pulse(block, factor, nph, nsub, op):
    """Apply ``op`` in place with one factor per pulse of a SEARCH stream:
    sample ``t`` of ``block`` ``(..., C, nsamp)`` takes ``factor[...,
    min(t // nph, nsub - 1)]`` of ``factor`` ``(..., C or 1, nsub)`` — a
    ragged tail clamps into the last pulse (reference:
    ``_subint_of_sample``) — through views, never a per-sample index."""
    nsamp = block.shape[-1]
    k = min(nsamp // nph, nsub)
    if k:
        op(block[..., :k * nph].unflatten(-1, (k, nph)),
           factor[..., :k, None])
    if k * nph < nsamp:
        j = min(k, nsub - 1)
        op(block[..., k * nph:], factor[..., j:j + 1])
    return block


def apply_scenario_pulse_search(block, rows, nsub, nph):
    """:func:`apply_scenario_pulse` for SEARCH streams ``(..., C, nsamp)``:
    one pulse is the time cell."""
    if rows.gain is not None:
        _per_pulse(block, rows.gain, nph, nsub, torch.Tensor.mul_)
    if rows.energy is not None:
        _per_pulse(block, rows.energy[..., None, :], nph, nsub,
                   torch.Tensor.mul_)
    return block


def apply_scenario_additive_search(block, rows, nsub, nph):
    """:func:`apply_scenario_additive` for SEARCH streams ``(..., C,
    nsamp)``: each contaminated (channel, pulse) cell lifted by its level
    across the pulse's samples."""
    if rows.level is not None:
        _per_pulse(block, rows.level, nph, nsub, torch.Tensor.add_)
    return block


def apply_pulse_effects_search(key, block, stack, params, *, nsub, nph,
                               nsamp, freqs, fcent_mhz, period_s, f_lo_mhz):
    """SEARCH-mode twin of :func:`apply_pulse_effects` on single-pulse
    streams ``(..., C, nsamp)``: one pulse is the effect's time cell (the
    scintillation cell lasts ``period_s``); the same draws on the same
    stages, so :func:`rfi_truth_mask` and :func:`energy_truth` recompute
    them from the key."""
    if block.shape[-1] != nsamp:
        raise ValueError(f"block has {block.shape[-1]} samples, not {nsamp}")
    stack = parse_stack(stack)
    freqs = torch.as_tensor(freqs, dtype=torch.float32).to("cpu")
    gain, energy, _, _ = _draw(
        key, ScenarioStack(tuple(e for e in stack.entries if e[0] != "rfi")),
        param_dict(stack, params), nsub=nsub, freqs=freqs,
        fcent_mhz=fcent_mhz, sublen_s=period_s, f_lo_mhz=f_lo_mhz,
        chan_ids=None)
    rows = ScenarioRows(
        None if gain is None else to_device(gain, block.device),
        None if energy is None else to_device(energy, block.device),
        None, None)
    return apply_scenario_pulse_search(block, rows, nsub, nph)


def apply_additive_effects_search(key, block, stack, params, *, nsub, nph,
                                  nsamp, chan_ids, noise_level):
    """SEARCH-mode twin of :func:`apply_additive_effects`: RFI rides on top
    of the radiometer noise, in units of ``noise_level``."""
    if block.shape[-1] != nsamp:
        raise ValueError(f"block has {block.shape[-1]} samples, not {nsamp}")
    stack = parse_stack(stack)
    if stack is None or "rfi" not in stack.names():
        return block
    _, _, levels, _ = _draw(
        key, ScenarioStack((("rfi", ""),)), param_dict(stack, params),
        nsub=nsub, freqs=None, fcent_mhz=None, sublen_s=None, f_lo_mhz=None,
        chan_ids=chan_ids)
    level = torch.as_tensor(noise_level, dtype=torch.float32,
                            device=block.device)
    rows = ScenarioRows(None, None, to_device(levels, block.device)
                        * level[..., None, None], None)
    return apply_scenario_additive_search(block, rows, nsub, nph)


def energy_truth(key, stack, params, *, nsub):
    """The ground-truth per-subint energies ``(..., nsub)`` for
    observation keys ``(..., 2)`` — the same draws as the injection, made
    on the host; None when the stack has no single_pulse."""
    stack = parse_stack(stack)
    if stack is None or "single_pulse" not in stack.names():
        return None
    mode = stack.mode("single_pulse")
    p = param_dict(stack, params)
    k = _stage_keys(key.to("cpu"), ["transient"])[..., 0, :]
    return pulse_energies(k, nsub, mode, p[_SP_PARAM[mode]])


def rfi_truth_mask(key, stack, params, *, nsub, chan_ids):
    """The ground-truth RFI contamination mask ``(..., C, nsub)`` bool for
    observation keys ``(..., 2)`` — the same draws as the injection, made
    on the host; None when the stack has no RFI."""
    stack = parse_stack(stack)
    if stack is None or "rfi" not in stack.names():
        return None
    p = param_dict(stack, params)
    k = _stage_keys(key.to("cpu"), ["rfi"])[..., 0, :]
    _, mask = rfi_levels(k, chan_ids, nsub, p["rfi_imp_prob"],
                         p["rfi_imp_snr"], p["rfi_nb_prob"], p["rfi_nb_snr"])
    return mask
