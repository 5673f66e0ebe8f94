"""Observability of the PyTorch port: TensorBoard event files written
without the ``tensorboard`` package, prediction overlays and figures drawn
in numpy."""

from uda_aerial_semantic_segmentation_research_tpu_torch.visualization import utils
from uda_aerial_semantic_segmentation_research_tpu_torch.visualization.tensorboard_logger import (
    TensorboardLogger,
)

__all__ = ["TensorboardLogger", "utils"]
