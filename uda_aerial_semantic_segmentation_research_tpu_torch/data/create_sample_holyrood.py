"""Build the 8-image sample Holyrood (target-domain) set.

The port's copy of the JAX package's ``data/create_sample_holyrood.py``:
copies the first ``num_samples`` images (sorted) of the prepared target set
into ``SAMPLE_HOLYROOD_DIR``; when the prepared set is absent it writes the
synthetic fixtures instead (``setup_test_data``).
"""

from __future__ import annotations

import shutil
from pathlib import Path

from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
from uda_aerial_semantic_segmentation_research_tpu_torch.data.dataset import IMG_EXTS


def create_sample_holyrood(source_dir: str | None = None, sample_dir: str | None = None,
                           num_samples: int = 8) -> int:
    """Fill ``sample_dir``; returns the number of images it holds."""
    source_dir = Path(source_dir or Config.TARGET_DATA_DIR)
    sample_dir = Path(sample_dir or Config.SAMPLE_HOLYROOD_DIR)
    sample_dir.mkdir(parents=True, exist_ok=True)

    existing = [f for f in sample_dir.iterdir() if f.suffix in IMG_EXTS]
    if len(existing) >= num_samples:
        print(f"Sample Holyrood set already exists ({len(existing)} images)")
        return len(existing)

    candidates = (sorted(f for f in source_dir.iterdir() if f.suffix in IMG_EXTS)
                  if source_dir.exists() else [])
    if not candidates:
        print(f"No prepared Holyrood images under {source_dir}; generating "
              "synthetic fixtures instead")
        from uda_aerial_semantic_segmentation_research_tpu_torch.data.setup_test_data import (
            setup_test_data,
        )

        setup_test_data(num_holyrood=num_samples)
        return num_samples

    for f in candidates[:num_samples]:
        shutil.copy2(f, sample_dir / f.name)
    n = min(num_samples, len(candidates))
    print(f"Created sample Holyrood set with {n} images at {sample_dir}")
    return n


if __name__ == "__main__":
    create_sample_holyrood()
