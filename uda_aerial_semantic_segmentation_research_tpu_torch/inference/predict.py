"""Batch and full-raster inference (the serving path).

Counterpart of ``predict_batch`` and ``predict_raster`` in the JAX
package's ``inference/predict.py``, for array input.  Images are NHWC.
Both run on ``cuda`` unless the caller passes ``device="cpu"``; the
model must already be on that device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.data.tiling import (
    stitch_tiles,
    tile_image,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.augment import (
    normalize_images,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.training.steps import (
    make_predict_step,
    model_device,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.utils.device import (
    resolve_device,
)


def _check_model_device(model, device) -> torch.device:
    dev = resolve_device(device)
    if model_device(model).type != dev.type:
        raise ValueError(f"model is on {model_device(model)}, not on {dev}")
    return model_device(model)


def predict_batch(model, images, device=None) -> np.ndarray:
    """Batch argmax prediction.

    ``images``: (B, H, W, C) raw uint8 or normalized float NHWC (CHW
    accepted).  Returns int32 label maps (B, H, W) as numpy.  The model
    runs in eval mode (running BatchNorm statistics, left unchanged), as
    the JAX package's ``ModelBundle`` always does.
    """
    dev = _check_model_device(model, device)
    model.eval()
    arr = np.asarray(images)
    if arr.ndim == 4 and arr.shape[1] == 3 and arr.shape[-1] != 3:
        arr = np.transpose(arr, (0, 2, 3, 1))
    with torch.inference_mode():
        if np.issubdtype(arr.dtype, np.integer):
            x = normalize_images(torch.tensor(arr, device=dev))
        else:
            x = torch.tensor(arr, dtype=torch.float32, device=dev)
        preds = model(x).argmax(dim=-1)
    return preds.to(torch.int32).cpu().numpy()


def predict_raster(model, image, tile: int = 512, overlap: int = 64,
                   batch_size: int = 8, device=None) -> np.ndarray:
    """Full-resolution raster inference by tiling + overlap-mean stitching.

    ``image``: (H, W, 3) uint8 array.  Tiles go through the model in
    batches of ``batch_size``; per-tile LOGITS stitch back with overlap
    averaging, then one argmax.  Returns (H, W) int32.
    """
    _check_model_device(model, device)
    if isinstance(image, (str, os.PathLike)):
        raise TypeError("predict_raster takes an (H, W, 3) array; reading "
                        "image files is not ported yet")
    image = np.asarray(image)
    h, w = image.shape[:2]
    step = make_predict_step(model)
    tiles, origins, padded_hw = tile_image(image, tile, overlap)
    logits = [step(tiles[i:i + batch_size]).cpu().numpy()
              for i in range(0, len(tiles), batch_size)]
    full = stitch_tiles(np.concatenate(logits), origins, padded_hw, reduce="mean")
    return np.argmax(full, axis=-1).astype(np.int32)[:h, :w]
