"""System test harness -- the framework's primary CLI, on the port.

Counterpart of the JAX package's ``test_system.py``: the same 14 named
suites, in the same order, runnable all together or one by one:

    python -m uda_aerial_semantic_segmentation_research_tpu_torch.test_system [--device cpu] [suite ...]

It runs on ``cuda`` unless ``--device cpu`` is given (``Config.DEVICE``);
without a GPU and without ``--device cpu`` every suite fails with the
no-CUDA error and the command exits 1.  It writes ``data/``, ``logs/``,
``checkpoints/``, ``results/`` and ``test_logs/`` under the working
directory, the synthetic fixtures of ``setup_test_data`` (cv2) among them.
``UDA_TPU_IMAGE_SIZE`` / ``UDA_TPU_ENCODER`` / ``UDA_TPU_BATCH_SIZE`` /
``UDA_TPU_NUM_CLASSES`` scale it down.

Suites return ✓/✗, thread shared objects (model, loaders) through the
dispatch loop, and keep the JAX suites' assertions.  The port's idioms: tensors
on ``Config.get_device()``; the parameter count as the sum of
``numel()``; the event file read back with ``read_events`` (no
``tensorboard``); the ``logging`` suite's figure drawn by
``visualization.figures.curves_image`` (no matplotlib); ``model_io`` writes
the model's state in the JAX layout (``to_jax_state_dict``), which loads in
either package, and reloads it through ``from_jax_state_dict``.  A suite
whose prerequisite failed (the model, the loaders) reports ✗ instead of
stopping the run.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np
import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
from uda_aerial_semantic_segmentation_research_tpu_torch.data.dataset import (
    DroneDataset,
    random_split,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.data.loader import DataLoader
from uda_aerial_semantic_segmentation_research_tpu_torch.data.prepare_holyrood import (
    prepare_holyrood_dataset,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.data.setup_test_data import (
    setup_test_data,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.data.target_dataset import (
    TargetDataset,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.inference.predict import (
    predict_mask,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
    DomainAdaptationModel,
    create_discriminator,
    create_unet,
    from_jax_state_dict,
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.augment import (
    get_strong_augmentation,
    get_training_augmentation,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.losses import (
    AdversarialLoss,
    ConsistencyLoss,
    DiceLoss,
    FineTuningLoss,
    WeightedSegmentationLoss,
    calculate_class_weights,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.training import (
    AdversarialTrainer,
    PhaseManager,
    SegmentationTrainer,
    TrainingPhase,
    UnsupervisedTrainer,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.visualization.figures import (
    curves_image,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.visualization.tensorboard_logger import (
    TensorboardLogger,
    read_events,
)


def _num_workers():
    return Config.NUM_WORKERS


def _on_device(array) -> torch.Tensor:
    return torch.as_tensor(np.asarray(array), device=Config.get_device())


def _source_dirs():
    return (os.path.join(Config.SAMPLE_DATA_DIR, "original_images"),
            os.path.join(Config.SAMPLE_DATA_DIR, "label_images_semantic"))


class TestSuites:
    # ------------------------------------------------------------------
    @staticmethod
    def data_loading_suite():
        print("\nRunning Data Loading Test Suite...")
        try:
            images_dir, masks_dir = _source_dirs()
            dataset = DroneDataset(
                images_dir=images_dir, masks_dir=masks_dir,
                transform=get_training_augmentation(device=Config.get_device()),
                balance_classes=True, image_size=Config.IMAGE_SIZE)
            print(f"✓ Dataset loaded successfully with {len(dataset)} images")

            assert hasattr(dataset, "class_stats"), "Dataset should have class statistics"
            assert hasattr(dataset, "sample_weights"), "Dataset should have sample weights"
            assert len(dataset.sample_weights) == len(dataset), "Wrong number of sample weights"
            assert np.isclose(dataset.sample_weights.sum(), 1.0), "Sample weights should sum to 1"

            train_size = int(Config.TRAIN_VAL_SPLIT * len(dataset))
            val_size = len(dataset) - train_size
            train_dataset, val_dataset = random_split(
                dataset, [train_size, val_size], seed=Config.SEED)

            train_sampler = dataset.get_sampler(indices=train_dataset.indices)
            train_loader = DataLoader(train_dataset, batch_size=Config.BATCH_SIZE,
                                      sampler=train_sampler,
                                      num_workers=_num_workers())
            val_loader = DataLoader(val_dataset, batch_size=Config.BATCH_SIZE,
                                    shuffle=False, num_workers=_num_workers())

            sample_batch = next(iter(train_loader))
            assert len(sample_batch) == 2, "Batch should contain images and masks"

            print("✓ DataLoaders created successfully")
            print("Class statistics:", dataset.class_stats)
            return True, train_loader, val_loader, train_dataset, val_dataset
        except Exception as e:
            print(f"✗ Data loading failed: {e}")
            return False, None, None, None, None

    # ------------------------------------------------------------------
    @staticmethod
    def model_creation_suite():
        print("\nRunning Model Creation Test Suite...")
        try:
            model = create_unet(
                encoder_name=Config.ENCODER_NAME,
                encoder_weights=Config.ENCODER_WEIGHTS,
                in_channels=Config.IN_CHANNELS,
                classes=Config.NUM_CLASSES,
                device=Config.get_device())
            n_params = sum(p.numel() for p in model.parameters())
            print(f"✓ Model created successfully ({n_params:,} params)")
            return True, model
        except Exception as e:
            print(f"✗ Model creation failed: {e}")
            return False, None

    # ------------------------------------------------------------------
    @staticmethod
    def loss_functions_suite():
        print("\nRunning Loss Functions Test Suite...")
        try:
            print("\nTesting Dice Loss...")
            dice_loss = DiceLoss()
            batch_size, s = 4, Config.IMAGE_SIZE
            num_classes = Config.NUM_CLASSES
            rng = np.random.default_rng(0)
            predictions = _on_device(rng.random((batch_size, s, s, num_classes),
                                                dtype=np.float32))
            targets = _on_device(rng.integers(0, num_classes, (batch_size, s, s)))

            loss = dice_loss(predictions, targets)
            assert loss.shape == (), "Loss should be a scalar"
            assert 0.0 <= float(loss) <= 1.0, "Dice loss should be between 0 and 1"
            print("✓ Dice Loss tested successfully")
            print(f"Sample Dice Loss: {float(loss):.4f}")

            print("\nTesting Weighted Segmentation Loss...")
            images_dir, masks_dir = _source_dirs()
            dummy_dataset = DroneDataset(images_dir=images_dir, masks_dir=masks_dir,
                                         transform=None, balance_classes=True, verbose=False)
            class_weights = calculate_class_weights(dummy_dataset, num_classes=num_classes)
            weighted_loss = WeightedSegmentationLoss(num_classes=num_classes,
                                                     class_weights=class_weights)
            predictions = _on_device(rng.normal(size=(batch_size, s, s, num_classes))
                                     .astype(np.float32))
            loss = weighted_loss(predictions, targets)
            assert loss.shape == (), "Loss should be a scalar"
            assert float(loss) >= 0, "Loss should be non-negative"
            print("✓ Weighted Segmentation Loss tested successfully")
            print(f"Sample weighted loss: {float(loss):.4f}")
            return True
        except Exception as e:
            print(f"✗ Loss functions test failed: {e}")
            return False

    # ------------------------------------------------------------------
    @staticmethod
    def logging_suite():
        print("\nRunning Logging Test Suite...")
        try:
            logger = TensorboardLogger(log_dir="test_logs")
            logger.log_scalar("test/loss", 0.5, 1)
            logger.log_scalars("test/metrics", {"accuracy": 0.85, "precision": 0.78}, 1)

            sample_image = np.random.rand(64, 64, 3).astype(np.float32)
            logger.log_image("test/image", sample_image, 1)

            # the line y = x through (1, 1), (2, 2), (3, 3), on the unit square
            xs = (np.array([1.0, 2.0, 3.0]) - 1.0) / 2.0
            logger.log_figure("test/figure", curves_image([(0, xs, xs, 1.0)], 1), 1)

            values = np.random.randn(1000)
            logger.log_histogram("test/histogram", values, 1)

            model = create_unet(encoder_name=Config.ENCODER_NAME,
                                encoder_weights=None,
                                in_channels=Config.IN_CHANNELS,
                                classes=Config.NUM_CLASSES,
                                device=Config.get_device())
            logger.log_model_graph(
                model, input_shape=(1, Config.IMAGE_SIZE, Config.IMAGE_SIZE, 3))
            logger.close()
            print("✓ Tensorboard Logger tested successfully")
            return True
        except Exception as e:
            print(f"✗ Tensorboard Logger test failed: {e}")
            return False

    # ------------------------------------------------------------------
    @staticmethod
    def training_suite(model, train_loader, val_loader):
        print("\nRunning Training Test Suite...")
        try:
            trainer = SegmentationTrainer(model=model, device=Config.get_device())
            assert hasattr(trainer, "logger"), "Trainer should have tensorboard logger"
            assert isinstance(trainer.logger, TensorboardLogger), \
                "Logger should be TensorboardLogger instance"

            trainer.train(train_dataloader=train_loader,
                          valid_dataloader=val_loader,
                          epochs=2, learning_rate=Config.LEARNING_RATE,
                          patience=Config.PATIENCE)

            log_dir = Path(Config.LOGS_DIR)
            assert log_dir.exists(), "Log directory should exist"
            assert any(log_dir.iterdir()), "Log directory should contain files"

            event_files = sorted(log_dir.rglob("events.out.tfevents.*"),
                                 key=lambda x: x.stat().st_mtime)
            assert len(event_files) > 0, "No tensorboard event files found"

            scalar_tags = {v["tag"] for event in read_events(event_files[-1])
                           for v in event["values"] if v.get("kind") == "scalar"}
            for tag in ("early_stopping/score", "early_stopping/counter"):
                assert any(tag in t for t in scalar_tags), f"Missing {tag} in logged data"

            print("✓ Training loop and early stopping completed successfully")
            return True
        except Exception as e:
            print(f"✗ Training loop failed: {e}")
            return False

    # ------------------------------------------------------------------
    @staticmethod
    def model_io_suite(model):
        print("\nRunning Model I/O Test Suite...")
        try:
            test_dir = os.path.join(Config.CHECKPOINTS_DIR, "test_checkpoint")
            os.makedirs(test_dir, exist_ok=True)
            path = os.path.join(test_dir, "test_model.pth")

            save_checkpoint(to_jax_state_dict(model), path)
            model.load_state_dict(from_jax_state_dict(load_checkpoint(path)), strict=True)
            print("✓ Model checkpoint saved and loaded successfully")
            return True
        except Exception as e:
            print(f"✗ Model saving/loading failed: {e}")
            return False

    # ------------------------------------------------------------------
    @staticmethod
    def prediction_suite(model, val_dataset):
        print("\nRunning Prediction Test Suite...")
        try:
            sample_image, _ = val_dataset[0]
            sample_image = np.asarray(sample_image)[None]  # add batch dim

            prediction = predict_mask(model=model, img=sample_image,
                                      device=Config.get_device())
            print("✓ Prediction completed successfully")
            print(f"Prediction shape: {prediction.shape}")
            return True
        except Exception as e:
            print(f"✗ Prediction failed: {e}")
            return False

    # ------------------------------------------------------------------
    @staticmethod
    def domain_adaptation_suite():
        print("\nRunning Domain Adaptation Test Suite...")
        try:
            discriminator = create_discriminator(input_channels=3,
                                                 image_size=Config.IMAGE_SIZE,
                                                 device=Config.get_device())
            batch_size = 4
            rng = np.random.default_rng(0)
            test_input = rng.normal(
                size=(batch_size, Config.IMAGE_SIZE, Config.IMAGE_SIZE, 3)
            ).astype(np.float32)

            with torch.inference_mode():
                domain_predictions = discriminator(_on_device(test_input))
            dp = domain_predictions.cpu().numpy()
            assert dp.shape == (batch_size, 1), \
                f"Expected shape {(batch_size, 1)}, got {dp.shape}"
            assert np.all((dp >= 0) & (dp <= 1)), "Predictions should be between 0 and 1"
            print("✓ Domain discriminator tested successfully")
            print(f"Sample predictions shape: {dp.shape}")
            print(f"Sample prediction values: {dp.squeeze()}")

            adv_loss = AdversarialLoss(lambda_adv=0.001)
            source_pred = _on_device(rng.normal(size=(batch_size, 1)).astype(np.float32))
            target_pred = _on_device(rng.normal(size=(batch_size, 1)).astype(np.float32))

            d_loss = adv_loss.discriminator_loss(source_pred, target_pred)
            assert d_loss.shape == (), "Discriminator loss should be a scalar"
            g_loss = adv_loss.generator_loss(target_pred)
            assert g_loss.shape == (), "Generator loss should be a scalar"
            print("✓ Adversarial losses tested successfully")
            print(f"Sample discriminator loss: {float(d_loss):.4f}")
            print(f"Sample generator loss: {float(g_loss):.4f}")
            return True
        except Exception as e:
            print(f"✗ Domain adaptation test failed: {e}")
            return False

    # ------------------------------------------------------------------
    @staticmethod
    def target_dataset_suite():
        print("\nRunning Target Dataset Test Suite...")
        try:
            target_images_dir = os.path.join(Config.SAMPLE_DATA_DIR, "original_images")
            target_dataset = TargetDataset(
                images_dir=target_images_dir,
                transform=get_training_augmentation(device=Config.get_device()),
                target_size=(Config.IMAGE_SIZE, Config.IMAGE_SIZE))
            assert len(target_dataset) > 0, "Target dataset is empty"

            sample_image = np.asarray(target_dataset[0])
            assert sample_image.ndim == 3, "Image should have 3 dimensions (H, W, C)"
            assert sample_image.shape[-1] == 3, "Image should have 3 channels"

            target_loader = DataLoader(target_dataset, batch_size=Config.BATCH_SIZE,
                                       shuffle=True, num_workers=_num_workers())
            sample_batch = next(iter(target_loader))
            assert np.asarray(sample_batch).ndim == 4, \
                "Batch should have 4 dimensions (B, H, W, C)"

            print("✓ Target domain dataset tested successfully")
            print(f"Dataset size: {len(target_dataset)}")
            print(f"Sample image shape: {sample_image.shape}")
            print(f"Sample batch shape: {np.asarray(sample_batch).shape}")
            return True
        except Exception as e:
            print(f"✗ Target domain dataset test failed: {e}")
            return False

    # ------------------------------------------------------------------
    @staticmethod
    def holyrood_suite():
        print("\nRunning Holyrood Test Suite...")
        try:
            prepare_holyrood_dataset()
            holyrood_dataset = TargetDataset(
                images_dir=os.path.join("data", "sample", "holyrood"),
                transform=get_training_augmentation(device=Config.get_device()),
                target_size=(Config.IMAGE_SIZE, Config.IMAGE_SIZE))
            holyrood_loader = DataLoader(holyrood_dataset,
                                         batch_size=Config.BATCH_SIZE,
                                         shuffle=True, num_workers=_num_workers())
            sample_batch = next(iter(holyrood_loader))
            assert np.asarray(sample_batch).ndim == 4, \
                "Batch should have 4 dimensions (B, H, W, C)"

            print("✓ Holyrood sample dataset tested successfully")
            print(f"Total sample images: {len(holyrood_dataset)}")
            print(f"Sample batch shape: {np.asarray(sample_batch).shape}")
            return True
        except Exception as e:
            print(f"✗ Holyrood sample dataset test failed: {e}")
            return False

    # ------------------------------------------------------------------
    @staticmethod
    def adversarial_training_suite(model, val_loader):
        print("\nRunning Adversarial Training Test Suite...")
        try:
            device = Config.get_device()
            adv_trainer = AdversarialTrainer(model=model, device=device, lambda_adv=0.001)
            images_dir, masks_dir = _source_dirs()
            source_dataset = DroneDataset(
                images_dir=images_dir, masks_dir=masks_dir,
                transform=get_training_augmentation(device=device),
                image_size=Config.IMAGE_SIZE, verbose=False)
            target_dataset = TargetDataset(
                images_dir=os.path.join("data", "target", "holyrood"),
                transform=get_training_augmentation(device=device),
                target_size=(Config.IMAGE_SIZE, Config.IMAGE_SIZE))

            source_loader = DataLoader(source_dataset, batch_size=Config.BATCH_SIZE,
                                       shuffle=True, num_workers=_num_workers())
            target_loader = DataLoader(target_dataset, batch_size=Config.BATCH_SIZE,
                                       shuffle=True, num_workers=_num_workers())

            adv_trainer.train(source_dataloader=source_loader,
                              target_dataloader=target_loader,
                              valid_dataloader=val_loader,
                              epochs=2, learning_rate=Config.LEARNING_RATE,
                              patience=Config.PATIENCE)

            assert hasattr(adv_trainer, "domain_metrics"), "Trainer should have domain metrics"
            metrics = adv_trainer.domain_metrics.get_metrics()
            assert "source_domain_acc" in metrics, "Should track source domain accuracy"
            assert "target_domain_acc" in metrics, "Should track target domain accuracy"
            assert "domain_confusion" in metrics, "Should track domain confusion"

            print("✓ Adversarial trainer tested successfully")
            print("Domain adaptation metrics:", metrics)
            return True, adv_trainer
        except Exception as e:
            print(f"✗ Adversarial trainer test failed: {e}")
            return False, None

    # ------------------------------------------------------------------
    @staticmethod
    def phase_management_suite(model, adv_trainer):
        print("\nRunning Phase Management Test Suite...")
        try:
            phase_manager = PhaseManager(model=model, device=Config.get_device(),
                                         checkpoints_dir=Config.CHECKPOINTS_DIR)
            assert phase_manager.get_current_phase() == TrainingPhase.SEGMENTATION

            test_metrics = {"iou": 0.6, "accuracy": 0.85, "domain_confusion": 0.3}
            phase_manager.save_checkpoint(trainer=adv_trainer,
                                          metrics=test_metrics,
                                          phase=TrainingPhase.SEGMENTATION,
                                          is_best=True)
            phase_dir = next(iter(phase_manager.phase_dirs.values()))
            assert (phase_dir / "best_model.pth").exists(), "Best model checkpoint not saved"

            assert phase_manager.metadata_path.exists(), "Metadata file not created"
            metadata = phase_manager._load_metadata()
            assert metadata["current_phase"] == TrainingPhase.SEGMENTATION.name
            assert "best_metrics" in metadata

            assert phase_manager.can_transition(test_metrics), \
                "Should be ready to transition with good metrics"
            new_phase = phase_manager.transition_to_next_phase()
            assert new_phase == TrainingPhase.ADVERSARIAL

            metadata = phase_manager._load_metadata()
            assert TrainingPhase.SEGMENTATION.name in metadata["phases_completed"]
            assert len(metadata["phase_transitions"]) > 0

            checkpoint = phase_manager.load_checkpoint(TrainingPhase.SEGMENTATION,
                                                       load_best=True)
            assert checkpoint is not None, "Failed to load checkpoint"
            assert "model_state_dict" in checkpoint
            assert "metrics" in checkpoint

            print("✓ Phase manager tested successfully")
            print(f"Current phase: {phase_manager.get_current_phase().name}")
            return True
        except Exception as e:
            print(f"✗ Phase manager test failed: {e}")
            return False

    # ------------------------------------------------------------------
    @staticmethod
    def fine_tuning_suite():
        print("\nRunning Fine-tuning Test Suite...")
        try:
            consistency_loss = ConsistencyLoss()
            batch_size, s = 4, Config.IMAGE_SIZE
            rng = np.random.default_rng(0)
            pred1 = _on_device(rng.random((batch_size, s, s, Config.NUM_CLASSES),
                                          dtype=np.float32))
            pred2 = _on_device(rng.random((batch_size, s, s, Config.NUM_CLASSES),
                                          dtype=np.float32))
            cons_loss = consistency_loss(pred1, pred2)
            assert cons_loss.shape == (), "Consistency loss should be a scalar"

            strong_aug = get_strong_augmentation(device=Config.get_device())
            sample_image = rng.integers(0, 255, (s, s, 3)).astype(np.uint8)
            augmented = strong_aug(image=sample_image)
            augmented_image = np.asarray(augmented["image"])
            assert augmented_image.shape == (s, s, 3), "Wrong output shape"

            fine_tuning_loss = FineTuningLoss(consistency_weight=1.0,
                                              domain_weight=0.1,
                                              supervised_weight=0.1,
                                              rampup_length=40)
            domain_pred = _on_device(rng.normal(size=(batch_size, 1)).astype(np.float32))
            for epoch in (0, 20, 40, 60):
                losses = fine_tuning_loss(pred1, pred2, domain_pred, epoch)
                for key in ("total", "consistency", "domain_confusion", "rampup_weight"):
                    assert key in losses, f"Missing {key} loss"
                assert float(losses["total"]) >= 0, "Total loss should be non-negative"
                r = float(losses["rampup_weight"])
                assert 0 <= r <= 1, "Rampup weight should be between 0 and 1"
                if epoch == 0:
                    assert r == 0, "Rampup should start at 0"
                elif epoch >= 40:
                    assert r == 1, "Rampup should reach 1"

            supervised_pred = _on_device(
                rng.random((batch_size, s, s, Config.NUM_CLASSES), dtype=np.float32))
            supervised_target = _on_device(
                rng.integers(0, Config.NUM_CLASSES, (batch_size, s, s)))
            losses_sup = fine_tuning_loss(pred1, pred2, domain_pred, 40,
                                          supervised_pred=supervised_pred,
                                          supervised_target=supervised_target)
            assert float(losses_sup["supervised"]) > 0, \
                "Supervised loss should be positive when provided"

            print("✓ Fine-tuning components tested successfully")
            print("Loss components:",
                  {k: float(v) for k, v in losses.items()})
            return True
        except Exception as e:
            print(f"✗ Fine-tuning test failed: {e}")
            return False

    # ------------------------------------------------------------------
    @staticmethod
    def unsupervised_training_suite(model):
        print("\n12c. Testing unsupervised trainer...")
        try:
            device = Config.get_device()
            discriminator = create_discriminator(input_channels=3,
                                                 image_size=Config.IMAGE_SIZE,
                                                 device=device)
            domain_model = DomainAdaptationModel(model, discriminator)

            unsup_trainer = UnsupervisedTrainer(
                model=domain_model, device=device,
                consistency_weight=1.0, domain_weight=0.1,
                supervised_weight=0.1, rampup_length=40, log_interval=10)

            target_dataset = TargetDataset(
                images_dir=os.path.join("data", "target", "holyrood"),
                transform=get_strong_augmentation(device=device),
                target_size=(Config.IMAGE_SIZE, Config.IMAGE_SIZE))

            test_batch_size = 1
            target_loader = DataLoader(target_dataset, batch_size=test_batch_size,
                                       shuffle=True, num_workers=0,
                                       drop_last=True)
            images_dir, masks_dir = _source_dirs()
            val_dataset = DroneDataset(
                images_dir=images_dir, masks_dir=masks_dir,
                transform=get_training_augmentation(device=device),
                image_size=Config.IMAGE_SIZE, verbose=False)
            val_loader_small = DataLoader(val_dataset, batch_size=test_batch_size,
                                          shuffle=False, num_workers=0,
                                          drop_last=True)

            unsup_trainer.train(target_dataloader=target_loader,
                                valid_dataloader=val_loader_small,
                                epochs=1, learning_rate=Config.LEARNING_RATE,
                                supervised_dataloader=None,
                                patience=Config.PATIENCE)

            assert hasattr(unsup_trainer, "domain_metrics"), \
                "Trainer should have domain metrics"
            metrics = unsup_trainer.domain_metrics.get_metrics()
            assert "domain_confusion" in metrics, "Should track domain confusion"

            print("✓ Unsupervised trainer tested successfully")
            print("Domain adaptation metrics:", metrics)
            return True
        except Exception as e:
            print(f"✗ Unsupervised trainer test failed: {e}")
            return False


ALL_SUITE_NAMES = [
    "data_loading", "model_creation", "loss_functions", "logging", "training",
    "model_io", "prediction", "domain_adaptation", "target_dataset",
    "holyrood", "adversarial_training", "phase_management", "fine_tuning",
    "unsupervised_training",
]


def _ensure_data(shared):
    """Self-provision loaders/datasets for standalone suite runs."""
    if "train_loader" not in shared:
        ok, train_loader, val_loader, train_ds, val_ds = TestSuites.data_loading_suite()
        if ok:
            shared.update(train_loader=train_loader, val_loader=val_loader,
                          train_dataset=train_ds, val_dataset=val_ds)
    return shared


def _ensure_model(shared):
    if "model" not in shared:
        ok, model = TestSuites.model_creation_suite()
        if ok:
            shared["model"] = model
    return shared


def _run_suite(suite: str, shared: dict) -> bool:
    """Run one suite, provisioning what it needs; a missing prerequisite
    (its suite failed) raises KeyError."""
    if suite == "data_loading":
        ok, train_loader, val_loader, train_ds, val_ds = TestSuites.data_loading_suite()
        if ok:
            shared.update(train_loader=train_loader, val_loader=val_loader,
                          train_dataset=train_ds, val_dataset=val_ds)
        return ok
    if suite == "model_creation":
        ok, model = TestSuites.model_creation_suite()
        if ok:
            shared["model"] = model
        return ok
    if suite == "training":
        _ensure_model(shared)
        _ensure_data(shared)
        return TestSuites.training_suite(
            shared["model"], shared["train_loader"], shared["val_loader"])
    if suite == "model_io":
        _ensure_model(shared)
        return TestSuites.model_io_suite(shared["model"])
    if suite == "prediction":
        _ensure_model(shared)
        _ensure_data(shared)
        return TestSuites.prediction_suite(shared["model"], shared["val_dataset"])
    if suite == "adversarial_training":
        _ensure_model(shared)
        _ensure_data(shared)
        ok, adv_trainer = TestSuites.adversarial_training_suite(
            shared["model"], shared["val_loader"])
        if ok:
            shared["adv_trainer"] = adv_trainer
        return ok
    if suite == "phase_management":
        _ensure_model(shared)
        if "adv_trainer" not in shared:
            shared["adv_trainer"] = AdversarialTrainer(
                model=shared["model"], device=Config.get_device())
        return TestSuites.phase_management_suite(shared["model"], shared["adv_trainer"])
    if suite == "unsupervised_training":
        _ensure_model(shared)
        return TestSuites.unsupervised_training_suite(shared["model"])
    return getattr(TestSuites, f"{suite}_suite")()


def test_system(suites=None, device=None) -> bool:
    """Run the system test suites (all of them, in order, by default) on
    ``device`` (``Config.DEVICE`` when None); True when every suite passed."""
    print("Starting system test...")
    Config.apply_env_overrides()
    if device is not None:
        Config.DEVICE = str(device)
    if suites is None:
        suites = list(ALL_SUITE_NAMES)
    for suite in suites:
        if suite not in ALL_SUITE_NAMES:
            print(f"Warning: Unknown test suite '{suite}'")
    suites = [suite for suite in suites if suite in ALL_SUITE_NAMES]

    results = {}
    try:
        Config.get_device()
    except (RuntimeError, ValueError) as e:
        print(f"✗ {e}")
        results = {suite: False for suite in suites}
    else:
        Config.setup_directories()
        setup_test_data(image_size=Config.IMAGE_SIZE)
        shared: dict = {}
        for suite in suites:
            try:
                results[suite] = _run_suite(suite, shared)
            except KeyError as e:
                print(f"✗ {suite}: its prerequisite {e} is missing (an earlier suite failed)")
                results[suite] = False

    print("\n" + "=" * 50)
    for name, ok in results.items():
        print(f"  {'✓' if ok else '✗'} {name}")
    all_ok = all(results.values()) and bool(results)
    if all_ok:
        print("\nAll system tests completed successfully! ✓")
    else:
        print("\nSome system tests FAILED ✗")
    return all_ok


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="System test suites of the port")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    parser.add_argument("suites", nargs="*", help=f"any of {' '.join(ALL_SUITE_NAMES)}")
    args = parser.parse_args(argv)
    success = test_system(suites=args.suites or None, device=args.device)
    if success:
        print("\nSystem is ready for training!")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
