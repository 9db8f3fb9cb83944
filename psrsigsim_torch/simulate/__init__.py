"""Orchestration: the Simulation façade and the fold-mode, SEARCH-mode
and baseband pipelines (counterpart: psrsigsim_tpu/simulate/)."""

from .pipeline import (BasebandPipelineConfig, FoldPipelineConfig,
                       SinglePipelineConfig, baseband_pipeline,
                       build_baseband_config, build_fold_config,
                       build_single_config, default_shift_mode,
                       fold_pipeline, fold_pipeline_batch,
                       fold_pipeline_hetero,
                       fold_pipeline_quantized, fold_subints, fused_route,
                       natural_nbin, single_pipeline)
from .simulate import Simulation

__all__ = ["Simulation", "FoldPipelineConfig", "build_fold_config",
           "default_shift_mode", "fold_pipeline", "fold_pipeline_batch",
           "fold_pipeline_hetero",
           "fold_pipeline_quantized", "fold_subints", "fused_route",
           "natural_nbin", "SinglePipelineConfig", "single_pipeline",
           "build_single_config", "BasebandPipelineConfig",
           "baseband_pipeline", "build_baseband_config"]
