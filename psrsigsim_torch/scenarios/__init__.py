"""Scenario engine: physics effects as a registry of priors (counterpart:
psrsigsim_tpu/scenarios/).

Each registered effect — scintillation gain screens, impulsive and
narrowband RFI with a ground-truth mask, single-pulse / transient energy
distributions — is declared once in :mod:`.registry` and reachable from
the port's fold-mode entry points:

* **ensembles** — ``FoldEnsemble(..., scenario=[...])`` with
  per-observation parameters on ``run`` / ``run_quantized`` /
  ``iter_chunks``, the PSRFITS export (``scenario_params=``) and
  ``Simulation.to_ensemble(scenario=...)``;
* **Monte-Carlo studies** — every registered parameter is a prior knob
  (``MonteCarloStudy`` infers the stack from the declared priors).

Disabled effects cost nothing (a scenario-free build writes the bytes it
wrote before the engine existed); enabled effects are bit-identical
across chunk sizes because every draw keys off the observation key via
the effect's own RNG stage.  On the card the factors ride into the fused
fold → quantize → pack kernel as per-row constants.  In SEARCH mode
(``single_pipeline``, the dataset factory) one pulse is the time cell
(``apply_*_effects_search``).
"""

from .registry import (
    EFFECT_ORDER,
    EFFECTS,
    Effect,
    EffectParam,
    ScenarioRows,
    ScenarioStack,
    apply_additive_effects,
    apply_additive_effects_search,
    apply_pulse_effects,
    apply_pulse_effects_search,
    default_params,
    energy_truth,
    parse_stack,
    rfi_truth_mask,
    scenario_knobs,
    scenario_rows,
    stack_from_knobs,
)

__all__ = [
    "EFFECTS",
    "EFFECT_ORDER",
    "Effect",
    "EffectParam",
    "ScenarioStack",
    "ScenarioRows",
    "parse_stack",
    "scenario_knobs",
    "stack_from_knobs",
    "default_params",
    "scenario_rows",
    "apply_pulse_effects",
    "apply_additive_effects",
    "apply_pulse_effects_search",
    "apply_additive_effects_search",
    "rfi_truth_mask",
    "energy_truth",
]
