"""The trainer's members that the harness reaches for, in one module.

``SegmentationTrainer.train`` prepares an epoch with private members that
no public call exposes: the steps are built (``_build_steps``), the logged
learning rate is set (``_lr``), and the state is checked against the
process group (``_setup_mesh``).  The harness runs ``train_epoch`` alone,
so it repeats that preparation here.  ``tap_losses`` reads the loss that
the trainer logs at each step, where it hands it to its logger.
"""

from __future__ import annotations


def prepare(trainer, loader, learning_rate: float):
    """The state ``SegmentationTrainer.train`` would start its first epoch
    with: ``TrainState(model, adam(learning_rate))``, steps built."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.state import (
        TrainState,
        adam,
    )

    trainer._build_steps()
    trainer._lr = float(learning_rate)
    return trainer._setup_mesh(loader, TrainState(trainer.model, adam(learning_rate)))


def tap_losses(trainer) -> list:
    """A list that receives every ``train/loss`` the trainer logs, in order;
    the logger still gets each."""
    losses = []
    log_scalar = trainer.logger.log_scalar

    def tapped(tag, value, step):
        if tag == "train/loss":
            losses.append(float(value))
        return log_scalar(tag, value, step)

    trainer.logger.log_scalar = tapped
    return losses
