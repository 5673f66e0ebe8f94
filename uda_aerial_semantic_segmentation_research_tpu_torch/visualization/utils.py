"""Prediction overlay visualization (numpy only).

The port's copy of the JAX package's ``visualization/utils.py``: 8 fixed
class colors extended with seeded random colors, integer label map ->
colored mask, alpha blend.  Arrays are channels-last (H, W, 3) float32 in
[0, 1]; CHW input is accepted and converted.  The output is bit-identical
to the JAX package's for the same input.
"""

from __future__ import annotations

import numpy as np

_FIXED_COLORS = np.array([
    [0.0, 0.0, 0.0],  # background - black
    [1.0, 0.0, 0.0],  # red
    [0.0, 1.0, 0.0],  # green
    [0.0, 0.0, 1.0],  # blue
    [1.0, 1.0, 0.0],  # yellow
    [1.0, 0.0, 1.0],  # magenta
    [0.0, 1.0, 1.0],  # cyan
    [0.5, 0.5, 0.5],  # gray
], dtype=np.float32)


def class_colors(num_classes: int, seed: int = 0) -> np.ndarray:
    """(num_classes, 3) float color table: 8 fixed + seeded random extension."""
    colors = _FIXED_COLORS
    if num_classes > len(colors):
        rng = np.random.default_rng(seed)
        extra = rng.random((num_classes - len(colors), 3), dtype=np.float32)
        colors = np.concatenate([colors, extra], axis=0)
    return colors[:num_classes]


def colorize_mask(mask: np.ndarray, num_classes: int | None = None,
                  seed: int = 0) -> np.ndarray:
    """Integer label map (H, W) -> float32 (H, W, 3) colored mask."""
    mask = np.asarray(mask).astype(np.int64)
    if num_classes is None:
        num_classes = int(mask.max()) + 1
    table = class_colors(max(num_classes, 1), seed=seed)
    return table[np.clip(mask, 0, len(table) - 1)]


def create_overlay(image, mask, alpha: float = 0.5) -> np.ndarray:
    """Blend an image with a colored class mask.

    Args:
        image: (H, W, 3) or (3, H, W) array, float in [0, 1]-ish or uint8.
        mask: (H, W) integer label map.
        alpha: mask opacity.

    Returns:
        float32 (H, W, 3) overlay in [0, 1].
    """
    img = np.asarray(image)
    if img.ndim == 3 and img.shape[0] == 3 and img.shape[-1] != 3:
        img = np.transpose(img, (1, 2, 0))
    img = img.astype(np.float32)
    if img.max() > 1.5:  # uint8-ranged
        img = img / 255.0
    img = np.clip(img, 0.0, 1.0)

    colored = colorize_mask(np.asarray(mask))
    overlay = img * (1.0 - alpha) + colored * alpha
    return np.clip(overlay, 0.0, 1.0)
