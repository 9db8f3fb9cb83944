"""Simulation pipelines (counterpart: psrsigsim_tpu/simulate/; this slice
ports the fold-mode pipeline)."""

from .pipeline import (FoldPipelineConfig, build_fold_config,
                       default_shift_mode, fold_pipeline,
                       fold_pipeline_quantized, fused_route,
                       natural_nbin)

__all__ = ["FoldPipelineConfig", "build_fold_config", "default_shift_mode",
           "fold_pipeline", "fold_pipeline_quantized", "fused_route",
           "natural_nbin"]
