"""Synthetic source- and target-domain fixtures (no download).

The port's copy of the JAX package's ``data/setup_test_data.py``: with the
same seed it writes the same files, from the same ``rng`` stream (the
target tiles are drawn after the source tiles),

- ``<SAMPLE_DATA_DIR>/{original_images,label_images_semantic}``: structured
  synthetic aerial tiles (JPEG) and per-pixel masks (PNG) covering all
  classes,
- ``<SAMPLE_DATA_DIR>/class_dict_seg.csv`` and a copy at
  ``<DATA_DIR>/class_dict_seg.csv``,
- ``<SAMPLE_HOLYROOD_DIR>`` and ``<TARGET_DATA_DIR>``: target-domain JPEGs
  ``DJI_####.jpg`` with other photometric statistics (a domain gap).

Drawing and encoding use cv2, imported when the fixtures are written.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config

# Semantic Drone Dataset class names (public class_dict_seg.csv schema).
CLASS_NAMES = [
    "unlabeled", "paved-area", "dirt", "grass", "gravel", "water", "rocks",
    "pool", "vegetation", "roof", "wall", "window", "door", "fence",
    "fence-pole", "person", "dog", "car", "bicycle", "tree", "bald-tree",
    "ar-marker", "obstacle",
]


def _class_colors(num_classes: int, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(num_classes, 3), dtype=np.int64)


def _synthetic_tile(rng: np.random.Generator, size: int, num_classes: int):
    """One structured synthetic aerial tile + mask: a smooth background
    (upsampled low-resolution noise) with random filled discs, rectangles
    and polygons, each assigned a class."""
    import cv2

    low = rng.uniform(40, 215, size=(8, 8, 3)).astype(np.float32)
    img = cv2.resize(low, (size, size), interpolation=cv2.INTER_CUBIC)
    mask = np.zeros((size, size), dtype=np.uint8)

    n_shapes = int(rng.integers(6, 14))
    for _ in range(n_shapes):
        cls = int(rng.integers(0, num_classes))
        color = rng.uniform(0, 255, size=3)
        kind = rng.integers(0, 3)
        if kind == 0:  # disc
            c = rng.integers(0, size, size=2)
            r = int(rng.integers(size // 16, size // 3))
            cv2.circle(img, (int(c[0]), int(c[1])), r, color.tolist(), -1)
            cv2.circle(mask, (int(c[0]), int(c[1])), r, int(cls), -1)
        elif kind == 1:  # rectangle
            p0 = rng.integers(0, size, size=2)
            p1 = np.clip(p0 + rng.integers(size // 12, size // 2, size=2), 0, size - 1)
            cv2.rectangle(img, tuple(int(v) for v in p0), tuple(int(v) for v in p1),
                          color.tolist(), -1)
            cv2.rectangle(mask, tuple(int(v) for v in p0), tuple(int(v) for v in p1),
                          int(cls), -1)
        else:  # polygon
            pts = rng.integers(0, size, size=(int(rng.integers(3, 7)), 2)).astype(np.int32)
            cv2.fillPoly(img, [pts], color.tolist())
            cv2.fillPoly(mask, [pts], int(cls))

    noise = rng.normal(0, 6.0, size=img.shape).astype(np.float32)
    img = np.clip(img + noise, 0, 255).astype(np.uint8)
    return img, mask


def _write_class_dict(path: Path, num_classes: int):
    colors = _class_colors(num_classes)
    lines = ["name, r, g, b"]
    for i in range(num_classes):
        n = CLASS_NAMES[i] if i < len(CLASS_NAMES) else f"class_{i}"
        lines.append(f"{n}, {colors[i, 0]}, {colors[i, 1]}, {colors[i, 2]}")
    path.write_text("\n".join(lines) + "\n")


def setup_test_data(num_source: int = 10, num_holyrood: int = 8, image_size: int = 256,
                    seed: int = 42, force: bool = False) -> None:
    """Create the source- and target-domain fixtures (idempotent unless
    ``force``)."""
    import cv2

    num_classes = Config.NUM_CLASSES
    sample_dir = Path(Config.SAMPLE_DATA_DIR)
    images_dir = sample_dir / "original_images"
    masks_dir = sample_dir / "label_images_semantic"
    rng = np.random.default_rng(seed)

    def _count(d: Path, ext: str) -> int:
        return len(list(d.glob(f"*{ext}"))) if d.exists() else 0

    if force or _count(images_dir, ".jpg") < num_source or _count(masks_dir, ".png") < num_source:
        images_dir.mkdir(parents=True, exist_ok=True)
        masks_dir.mkdir(parents=True, exist_ok=True)
        for i in range(num_source):
            img, mask = _synthetic_tile(rng, image_size, num_classes)
            # guarantee global class coverage across the set
            stripe = (np.arange(image_size) * num_classes // image_size).astype(np.uint8)
            mask[: image_size // 16, :] = stripe[None, :]
            cv2.imwrite(str(images_dir / f"{i:03d}.jpg"),
                        cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            cv2.imwrite(str(masks_dir / f"{i:03d}.png"), mask)

    csv_path = sample_dir / "class_dict_seg.csv"
    if force or not csv_path.exists():
        _write_class_dict(csv_path, num_classes)
    data_csv = Path(Config.DATA_DIR) / "class_dict_seg.csv"
    if force or not data_csv.exists():
        data_csv.parent.mkdir(parents=True, exist_ok=True)
        _write_class_dict(data_csv, num_classes)

    for tgt_dir in (Path(Config.SAMPLE_HOLYROOD_DIR), Path(Config.TARGET_DATA_DIR)):
        if force or _count(tgt_dir, ".jpg") < num_holyrood:
            tgt_dir.mkdir(parents=True, exist_ok=True)
            for i in range(num_holyrood):
                img, _ = _synthetic_tile(rng, image_size, num_classes)
                # other photometric statistics: a domain gap
                img = np.clip(img.astype(np.float32) * 0.7 + 40.0, 0, 255).astype(np.uint8)
                img = img[:, :, ::-1].copy()  # channel-swapped palette
                cv2.imwrite(str(tgt_dir / f"DJI_{i:04d}.jpg"),
                            cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


if __name__ == "__main__":
    setup_test_data()
    print("Synthetic test data ready under", os.path.abspath(Config.DATA_DIR))
