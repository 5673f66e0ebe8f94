"""Utilities of the PyTorch port."""

from uda_aerial_semantic_segmentation_research_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)

__all__ = ["load_checkpoint", "save_checkpoint"]
