"""Unlabeled target-domain (Holyrood) dataset.

The port's copy of the JAX package's ``data/target_dataset.py``: the sorted
image listing of a directory, ``load_raw`` returning a uint8 (H, W, 3) RGB
image resized to ``target_size`` -- JPEGs through the native decoder
(``data/native.py``) where it is built, else cv2 (imported only then) with
a BGR -> RGB swap and an INTER_AREA resize -- and an optional transform on
``__getitem__``.  No labels.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from uda_aerial_semantic_segmentation_research_tpu_torch.data import native
from uda_aerial_semantic_segmentation_research_tpu_torch.data.dataset import IMG_EXTS


class TargetDataset:
    """Dataset of target-domain images (no labels)."""

    def __init__(self, images_dir: str, transform=None,
                 target_size: Tuple[int, int] = (256, 256), verbose: bool = True):
        self.images_dir = images_dir
        self.transform = transform
        self.target_size = target_size
        self.images = sorted(f for f in os.listdir(images_dir) if f.endswith(IMG_EXTS))
        if verbose:
            print(f"Found {len(self.images)} target domain images")
            if self.images:
                print(f"First target image: {self.images[0]}")

    def __len__(self):
        return len(self.images)

    def load_raw(self, idx: int) -> np.ndarray:
        """Decode one image -> uint8 (H, W, 3) RGB resized to ``target_size``
        (``(width, height)``, cv2's order)."""
        path = os.path.join(self.images_dir, self.images[idx])
        if self.target_size and path.lower().endswith((".jpg", ".jpeg")):
            w, h = self.target_size
            out = native.decode_jpeg_rgb(path, h, w)
            if out is not None:
                return out
        import cv2

        image = cv2.imread(path)
        if image is None:
            raise ValueError(f"Failed to load image: {path}")
        image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
        if self.target_size:
            image = cv2.resize(image, self.target_size, interpolation=cv2.INTER_AREA)
        return image

    def __getitem__(self, idx: int):
        image = self.load_raw(idx)
        if self.transform is not None:
            image = self.transform(image=image)["image"]
        return image
