"""Training: states, step factories, the three phases' trainers, the phase
lifecycle, the three-phase pipeline and the GRL stack's ``MultiPhaseTrainer``.

Exports the names of the JAX package's ``training.__all__``;
``run_pipeline`` is imported when called, as there."""

from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
    AdversarialState,
    TrainState,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.training.train import (
    EarlyStopping,
    SegmentationTrainer,
    launch_tensorboard,
    load_class_dict,
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

__all__ = ["AdversarialState", "AdversarialTrainer", "EarlyStopping", "MultiPhaseTrainer",
           "PhaseManager", "SegmentationTrainer", "TrainState", "TrainingPhase",
           "UnsupervisedTrainer", "launch_tensorboard", "load_class_dict", "run_pipeline",
           "train_model"]


def run_pipeline(*args, **kwargs):
    """The three-phase pipeline (``training.pipeline.run_pipeline``, imported
    on the first call)."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.pipeline import (
        run_pipeline as run,
    )

    return run(*args, **kwargs)
