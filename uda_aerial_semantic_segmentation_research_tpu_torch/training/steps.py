"""Step factories of the PyTorch port.

Counterpart of the JAX package's ``training/steps.py``.  Only the
serving step is ported so far; the train and eval steps come with the
training slice.
"""

from __future__ import annotations

import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.ops.augment import (
    normalize_images,
)


def model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_predict_step(model: torch.nn.Module):
    """``step(images)``: uint8/float NHWC images -> float32 NHWC logits.

    Normalizes (ImageNet statistics; integers divided by 255), then runs
    the model's eval-mode forward under ``torch.inference_mode``.  Images
    may be a numpy array or a tensor; they are moved to the model's
    device.
    """
    device = model_device(model)

    def step(images):
        with torch.inference_mode():
            x = normalize_images(torch.as_tensor(images, device=device))
            return model(x).float()

    return step
