"""Training: states, step factories, the three phases' trainers, the phase
lifecycle, the three-phase pipeline and the GRL stack's ``MultiPhaseTrainer``.

The trainers and the phase lifecycle are exported here, as from the JAX
package's ``training``."""

from uda_aerial_semantic_segmentation_research_tpu_torch.training.train import (
    EarlyStopping,
    SegmentationTrainer,
    train_model,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.training.adversarial_trainer import (
    AdversarialTrainer,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.training.unsupervised_trainer import (
    UnsupervisedTrainer,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.training.phase_manager import (
    PhaseManager,
    TrainingPhase,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.training.trainer_phases import (
    MultiPhaseTrainer,
)

__all__ = ["AdversarialTrainer", "EarlyStopping", "MultiPhaseTrainer", "PhaseManager",
           "SegmentationTrainer", "TrainingPhase", "UnsupervisedTrainer", "train_model"]
