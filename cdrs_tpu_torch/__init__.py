"""PyTorch/CUDA port of the clustering-driven replication strategy.

The batch pipeline of ``cdrs_tpu`` (``backend="jax"``) and its stream
path (streaming feature fold, mini-batch KMeans, drift detector) on
PyTorch, with the TPU kernels — the fused Lloyd step and the
bisection-median counter — written in CUDA C++ for Hopper (``csrc/``).
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from .config import (GeneratorConfig, KMeansConfig, PipelineConfig, ScoringConfig,
                     SimulatorConfig, validated_scoring_config)
from .pipeline import PipelineResult, run_pipeline

__all__ = ["GeneratorConfig", "KMeansConfig", "PipelineConfig", "ScoringConfig",
           "SimulatorConfig", "validated_scoring_config", "PipelineResult",
           "run_pipeline"]
