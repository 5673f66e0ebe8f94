"""Data helpers of the PyTorch port."""

from uda_aerial_semantic_segmentation_research_tpu_torch.data.dataset import (
    DroneDataset,
    Subset,
    WeightedRandomSampler,
    random_split,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.data.loader import DataLoader
from uda_aerial_semantic_segmentation_research_tpu_torch.data.target_dataset import (
    TargetDataset,
)

__all__ = ["DataLoader", "DroneDataset", "Subset", "TargetDataset", "WeightedRandomSampler",
           "random_split"]
