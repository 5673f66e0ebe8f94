"""Operators of the PyTorch port: the CUDA kernels and their plain versions."""

from uda_aerial_semantic_segmentation_research_tpu_torch.ops import (
    augment,
    losses,
    metrics,
    upsample_conv,
)

__all__ = ["augment", "losses", "metrics", "upsample_conv"]
