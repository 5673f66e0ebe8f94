"""The three-phase UDA pipeline: supervised -> adversarial -> unsupervised.

The port's copy of the JAX package's ``training/pipeline.py``:

    python -m uda_aerial_semantic_segmentation_research_tpu_torch.training.pipeline \\
        --phase1-epochs 30 --phase2-epochs 20 --phase3-epochs 15 [--device cpu]

Phase 1 (``SegmentationTrainer``) -> gate (iou > 0.5 and accuracy > 0.75)
-> phase 2 (``AdversarialTrainer``) -> gate (domain_confusion > 0.4 and
iou > 0.45) -> phase 3 (``UnsupervisedTrainer`` at a tenth of the learning
rate, with phase 2's discriminator), with per-phase best checkpoints and
the ``training_metadata.json`` lifecycle of ``PhaseManager``.
``force_transitions`` proceeds when a gate fails (the summary records the
gate).  ``resume_dir`` continues an experiment: completed phases are
skipped and the weights -- the discriminator's too -- are restored.

Single process: the JAX package's multi-process sharding of the loaders
is not ported (``ROADMAP.md`` A.14).  Runs on ``Config.DEVICE`` (``cuda``
unless the caller sets ``cpu``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config


def _build_loaders(batch_size: int):
    """(train, val, target) loaders: the sample source dataset split
    ``TRAIN_VAL_SPLIT`` with weighted sampling of its training part, and the
    target images under ``TARGET_DATA_DIR`` shuffled, both ``drop_last``."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.data.dataset import (
        DroneDataset,
        random_split,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.data.loader import DataLoader
    from uda_aerial_semantic_segmentation_research_tpu_torch.data.target_dataset import (
        TargetDataset,
    )

    source = DroneDataset(
        images_dir=os.path.join(Config.SAMPLE_DATA_DIR, "original_images"),
        masks_dir=os.path.join(Config.SAMPLE_DATA_DIR, "label_images_semantic"),
        image_size=Config.IMAGE_SIZE, verbose=False)
    train_size = max(int(Config.TRAIN_VAL_SPLIT * len(source)), 1)
    train_ds, val_ds = random_split(
        source, [train_size, len(source) - train_size], seed=Config.SEED)
    sampler = source.get_sampler(indices=train_ds.indices)
    target = TargetDataset(images_dir=Config.TARGET_DATA_DIR,
                           target_size=(Config.IMAGE_SIZE, Config.IMAGE_SIZE), verbose=False)

    train_loader = DataLoader(train_ds, batch_size=batch_size, sampler=sampler,
                              drop_last=True, num_workers=Config.NUM_WORKERS)
    val_loader = DataLoader(val_ds, batch_size=batch_size)
    target_loader = DataLoader(target, batch_size=batch_size, shuffle=True,
                               drop_last=True, num_workers=Config.NUM_WORKERS)
    return train_loader, val_loader, target_loader


def run_pipeline(phase1_epochs: int = 30, phase2_epochs: int = 20, phase3_epochs: int = 15,
                 learning_rate: Optional[float] = None, batch_size: Optional[int] = None,
                 lambda_adv: float = 0.001, force_transitions: bool = False,
                 checkpoints_dir: Optional[str] = None, model=None,
                 resume_dir: Optional[str] = None) -> Dict:
    """Run supervised -> adversarial -> unsupervised with gated transitions;
    returns the summary (``experiment_dir``, per-phase metrics and gates,
    ``final_phase``)."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
        create_discriminator,
        create_model,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.models.domain_model import (
        DomainAdaptationModel,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.adversarial_trainer import (
        AdversarialTrainer,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.phase_manager import (
        PhaseManager,
        TrainingPhase,
        load_jax_state_dict,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.train import (
        SegmentationTrainer,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.training.unsupervised_trainer import (
        UnsupervisedTrainer,
    )

    Config.apply_env_overrides()
    Config.setup_directories()
    learning_rate = learning_rate or Config.LEARNING_RATE
    batch_size = batch_size or Config.BATCH_SIZE
    device = Config.get_device()

    train_loader, val_loader, target_loader = _build_loaders(batch_size)
    if model is None:
        model = create_model("Unet", encoder_name=Config.ENCODER_NAME,
                             encoder_weights=Config.ENCODER_WEIGHTS,
                             classes=Config.NUM_CLASSES, device=device)
    resume_disc_state = None
    if resume_dir:
        pm = PhaseManager.resume(model=model, device=device, experiment_dir=resume_dir)
        # phase-2/3 checkpoints carry the trained discriminator: a resume
        # does not restart the adversary from scratch
        resume_disc_state = (pm.last_checkpoint or {}).get("discriminator_state_dict")
        print(f"Resumed {resume_dir}: phase={pm.get_current_phase().name}, "
              f"completed={pm.phases_completed()}, "
              f"discriminator={'restored' if resume_disc_state else 'fresh'}")
    else:
        pm = PhaseManager(model=model, device=device,
                          checkpoints_dir=checkpoints_dir or Config.CHECKPOINTS_DIR)
    summary: Dict = {"experiment_dir": str(pm.experiment_dir), "phases": {}}
    adv_trainer = None

    # ---- phase 1: supervised segmentation -----------------------------
    if pm.get_current_phase() == TrainingPhase.SEGMENTATION:
        print("\n=== Phase 1: supervised segmentation ===")
        seg_trainer = SegmentationTrainer(model, device)
        best1 = seg_trainer.train(train_loader, val_loader, epochs=phase1_epochs,
                                  learning_rate=learning_rate, patience=Config.PATIENCE)
        metrics1 = best1 or seg_trainer.validate(val_loader)
        pm.save_checkpoint(seg_trainer, metrics1, TrainingPhase.SEGMENTATION, is_best=True)
        gate1 = pm.can_transition(metrics1)
        summary["phases"]["segmentation"] = {"metrics": metrics1, "gate": gate1}
        if not (gate1 or force_transitions):
            print(f"Phase-1 gate not met ({metrics1}); stopping "
                  "(use force_transitions to continue)")
            return summary
        pm.transition_to_next_phase()

    # ---- phase 2: adversarial domain adaptation ------------------------
    if pm.get_current_phase() == TrainingPhase.ADVERSARIAL:
        print("\n=== Phase 2: adversarial domain adaptation ===")
        adv_trainer = AdversarialTrainer(model, device, lambda_adv=lambda_adv)
        if resume_disc_state is not None:
            load_jax_state_dict(adv_trainer.discriminator, resume_disc_state)
        adv_trainer.train(train_loader, target_loader, val_loader, epochs=phase2_epochs,
                          learning_rate=learning_rate, patience=Config.PATIENCE)
        _, val2 = adv_trainer.validate(val_loader)
        metrics2 = {**val2, **adv_trainer.domain_metrics.get_metrics()}
        pm.save_checkpoint(adv_trainer, metrics2, TrainingPhase.ADVERSARIAL, is_best=True)
        gate2 = pm.can_transition(metrics2)
        summary["phases"]["adversarial"] = {"metrics": metrics2, "gate": gate2}
        if not (gate2 or force_transitions):
            print(f"Phase-2 gate not met ({metrics2}); stopping")
            return summary
        pm.transition_to_next_phase()

    # ---- phase 3: unsupervised fine-tuning ------------------------------
    print("\n=== Phase 3: unsupervised fine-tuning ===")
    # phase 2's discriminator carries into fine-tuning; on a phase-3 resume
    # it is rebuilt from the saved state
    discriminator = adv_trainer.discriminator if adv_trainer else None
    if discriminator is None and resume_disc_state is not None:
        discriminator = create_discriminator(input_channels=3, image_size=Config.IMAGE_SIZE,
                                             device=device)
        load_jax_state_dict(discriminator, resume_disc_state)
    unsup_trainer = UnsupervisedTrainer(DomainAdaptationModel(model, discriminator), device)
    best_iou = unsup_trainer.train(target_loader, val_loader, epochs=phase3_epochs,
                                   learning_rate=learning_rate * 0.1,
                                   patience=Config.PATIENCE)
    metrics3 = {"iou": best_iou, **unsup_trainer.domain_metrics.get_metrics()}
    pm.save_checkpoint(unsup_trainer, metrics3, TrainingPhase.FINE_TUNING, is_best=True)
    summary["phases"]["fine_tuning"] = {"metrics": metrics3}
    summary["final_phase"] = pm.get_current_phase().name

    print("\nPipeline complete:")
    print(json.dumps(summary, indent=2, default=float))
    return summary


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description="Three-phase UDA pipeline")
    p.add_argument("--phase1-epochs", type=int, default=30)
    p.add_argument("--phase2-epochs", type=int, default=20)
    p.add_argument("--phase3-epochs", type=int, default=15)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lambda-adv", type=float, default=0.001)
    p.add_argument("--force-transitions", action="store_true")
    p.add_argument("--resume", default=None, metavar="EXPERIMENT_DIR",
                   help="resume an existing experiment (skips completed phases)")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    a = p.parse_args()
    if a.device:
        Config.DEVICE = a.device
    run_pipeline(phase1_epochs=a.phase1_epochs, phase2_epochs=a.phase2_epochs,
                 phase3_epochs=a.phase3_epochs, learning_rate=a.learning_rate,
                 batch_size=a.batch_size, lambda_adv=a.lambda_adv,
                 force_transitions=a.force_transitions, resume_dir=a.resume)
