"""Build the 10-image sample source-dataset fixture.

The port's copy of the JAX package's ``data/create_sample_dataset.py``:
copies a seeded random subset of the full Semantic Drone Dataset (and its
class_dict CSV) into ``Config.SAMPLE_DATA_DIR``; when the full dataset is
absent, writes the synthetic fixtures instead (``setup_test_data``).
"""

from __future__ import annotations

import os
import random
import shutil
from pathlib import Path

from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config


def create_sample_dataset(
        source_dir: str = os.path.join("data", "raw", "semantic_drone"),
        sample_dir: str | None = None,
        num_samples: int = 10, seed: int = 42) -> int:
    """Copy a seeded ``num_samples`` subset into the sample layout."""
    sample_dir = Path(sample_dir or Config.SAMPLE_DATA_DIR)
    images_out = sample_dir / "original_images"
    masks_out = sample_dir / "label_images_semantic"

    src = Path(source_dir)
    src_images = src / "dataset" / "semantic_drone_dataset" / "original_images"
    src_masks = src / "dataset" / "semantic_drone_dataset" / "label_images_semantic"
    if not src_images.exists():  # alternative layout
        src_images = src / "original_images"
        src_masks = src / "label_images_semantic"

    if not src_images.exists():
        print(f"Full dataset not found under {source_dir}; generating "
              "synthetic fixtures instead")
        from uda_aerial_semantic_segmentation_research_tpu_torch.data.setup_test_data import (
            setup_test_data,
        )

        setup_test_data(num_source=num_samples, seed=seed)
        return num_samples

    images_out.mkdir(parents=True, exist_ok=True)
    masks_out.mkdir(parents=True, exist_ok=True)

    names = sorted(p.stem for p in src_images.glob("*.jpg"))
    rng = random.Random(seed)
    chosen = rng.sample(names, min(num_samples, len(names)))
    for stem in chosen:
        shutil.copy2(src_images / f"{stem}.jpg", images_out / f"{stem}.jpg")
        shutil.copy2(src_masks / f"{stem}.png", masks_out / f"{stem}.png")

    for csv in src.rglob("class_dict_seg.csv"):
        shutil.copy2(csv, sample_dir / "class_dict_seg.csv")
        break
    print(f"Created sample dataset with {len(chosen)} images at {sample_dir}")
    return len(chosen)


if __name__ == "__main__":
    create_sample_dataset()
