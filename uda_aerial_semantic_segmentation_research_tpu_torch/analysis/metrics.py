"""Histogram-based segmentation evaluation metrics.

The implementation lives in ``ops.metrics`` (shared with the trainers, where
the confusion-matrix histogram is computed on the device); this module keeps
the import path ``<pkg>.analysis.metrics.SegmentationMetrics`` of the JAX
package.
"""

from uda_aerial_semantic_segmentation_research_tpu_torch.ops.metrics import (
    SegmentationMetrics,
    accuracy_from_hist,
    confusion_matrix,
    iou_from_hist,
)

__all__ = [
    "SegmentationMetrics",
    "confusion_matrix",
    "iou_from_hist",
    "accuracy_from_hist",
]
