"""Kaggle download of the Semantic Drone Dataset (source domain).

The port's copy of the JAX package's ``data/download_semantic_drone.py``:
downloads ``bulentsiyah/semantic-drone-dataset`` into
``data/raw/semantic_drone`` through the Kaggle API.  It needs the ``kaggle``
package, its credentials and network access; without them it says so and
returns False (``setup_test_data`` writes synthetic fixtures instead).

    python -m uda_aerial_semantic_segmentation_research_tpu_torch.data.download_semantic_drone
"""

from __future__ import annotations

import os


def download_semantic_drone_dataset(
        dest: str = os.path.join("data", "raw", "semantic_drone")) -> bool:
    """Download + unzip the dataset; returns True on success or when
    ``dest`` already holds files."""
    os.makedirs(dest, exist_ok=True)
    if os.listdir(dest):
        print(f"Dataset already present at {dest}; skipping download")
        return True
    try:
        import kaggle  # noqa: F401  (requires ~/.kaggle/kaggle.json)
    except Exception as e:
        print(f"Kaggle API unavailable ({e}); cannot download. "
              "Use setup_test_data() for synthetic fixtures.")
        return False

    from kaggle.api.kaggle_api_extended import KaggleApi

    api = KaggleApi()
    api.authenticate()
    print("Downloading bulentsiyah/semantic-drone-dataset ...")
    api.dataset_download_files("bulentsiyah/semantic-drone-dataset",
                               path=dest, unzip=True)
    print(f"Downloaded to {dest}")
    return True


if __name__ == "__main__":
    download_semantic_drone_dataset()
