"""Training: states, step factories, the three phases' trainers, the phase
lifecycle, the three-phase pipeline and the GRL stack's ``MultiPhaseTrainer``."""

from uda_aerial_semantic_segmentation_research_tpu_torch.training.trainer_phases import (
    MultiPhaseTrainer,
)

__all__ = ["MultiPhaseTrainer"]
