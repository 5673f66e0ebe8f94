"""Standalone evaluation metrics (the JAX package's ``analysis`` layer)."""

from uda_aerial_semantic_segmentation_research_tpu_torch.analysis.metrics import (
    SegmentationMetrics,
)

__all__ = ["SegmentationMetrics"]
