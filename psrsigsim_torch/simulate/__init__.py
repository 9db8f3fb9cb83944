"""Orchestration: the Simulation façade and the fold-mode pipeline
(counterpart: psrsigsim_tpu/simulate/)."""

from .pipeline import (FoldPipelineConfig, build_fold_config,
                       default_shift_mode, fold_pipeline,
                       fold_pipeline_quantized, fold_subints, fused_route,
                       natural_nbin)
from .simulate import Simulation

__all__ = ["Simulation", "FoldPipelineConfig", "build_fold_config",
           "default_shift_mode", "fold_pipeline", "fold_pipeline_quantized",
           "fold_subints", "fused_route", "natural_nbin"]
