"""Image normalization (ImageNet statistics), NHWC.

Counterpart of ``normalize_images`` / ``denormalize_images`` in the JAX
package's ``ops/augment.py``.  The training augmentations come with the
training slice.
"""

from __future__ import annotations

import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config


def _stats(device):
    mean = torch.tensor(Config.NORMALIZE_MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(Config.NORMALIZE_STD, dtype=torch.float32, device=device)
    return mean, std


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """uint8/float NHWC -> normalized float32 NHWC (integers divided by 255)."""
    x = images.float()
    if not images.dtype.is_floating_point:
        x = x / 255.0
    mean, std = _stats(images.device)
    return (x - mean) / std


def denormalize_images(images: torch.Tensor) -> torch.Tensor:
    """Inverse of ``normalize_images`` -> float32 in [0, 1]."""
    mean, std = _stats(images.device)
    return torch.clamp(images * std + mean, 0.0, 1.0)
