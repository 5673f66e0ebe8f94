"""Global configuration of the PyTorch port.

Same attribute names as the JAX package's ``Config`` (the reference's
static ``Config`` surface), so code written against one reads the
other.  The differences: ``DEVICE`` names a torch device (``cuda`` by
default, ``cpu`` when a caller asks for the CPU), ``get_device()`` returns
a ``torch.device`` and raises without a GPU unless ``DEVICE`` is ``cpu``,
``compute_dtype()`` returns a ``torch.dtype``.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.utils.device import (
    resolve_device,
)


class Config:
    """Static hyperparameter / path configuration (reference Config surface)."""

    # --- model -----------------------------------------------------------
    NUM_CLASSES: int = 23                 # Semantic Drone Dataset classes
    ENCODER_NAME: str = "resnet34"        # reference default encoder
    ENCODER_WEIGHTS: str | None = "imagenet"
    IN_CHANNELS: int = 3
    MODEL_NAME: str = "Unet"
    IMAGE_SIZE: int = 256                 # training tile size

    # --- data ------------------------------------------------------------
    DATA_DIR: str = "data"
    SAMPLE_DATA_DIR: str = os.path.join("data", "sample", "semantic_drone")
    TARGET_DATA_DIR: str = os.path.join("data", "target", "holyrood")
    SAMPLE_HOLYROOD_DIR: str = os.path.join("data", "sample", "holyrood")
    TRAIN_VAL_SPLIT: float = 0.8
    BATCH_SIZE: int = 8
    NUM_WORKERS: int = 2                  # host prefetch threads
    NORMALIZE_MEAN: tuple = (0.485, 0.456, 0.406)   # ImageNet stats
    NORMALIZE_STD: tuple = (0.229, 0.224, 0.225)

    # --- training --------------------------------------------------------
    LEARNING_RATE: float = 1e-4
    NUM_EPOCHS: int = 50
    PATIENCE: int = 7
    LOG_INTERVAL: int = 10
    SEED: int = 0

    # --- paths -----------------------------------------------------------
    LOGS_DIR: str = "logs"
    CHECKPOINTS_DIR: str = "checkpoints"
    CHECKPOINT_DIR: str = "checkpoints"
    RESULTS_DIR: str = "results"

    # --- device knobs ------------------------------------------------------
    COMPUTE_DTYPE: str = "bfloat16"       # activations and convolutions
    PARAM_DTYPE: str = "float32"          # master weights
    DEVICE: str = "cuda"                  # 'cuda' | 'cpu'

    @classmethod
    def apply_env_overrides(cls) -> None:
        """Scale-down knobs via environment variables.

        ``UDA_TPU_IMAGE_SIZE`` / ``UDA_TPU_ENCODER`` / ``UDA_TPU_BATCH_SIZE``
        / ``UDA_TPU_NUM_CLASSES`` override the defaults (the same names
        the JAX package reads).
        """
        if os.environ.get("UDA_TPU_IMAGE_SIZE"):
            cls.IMAGE_SIZE = int(os.environ["UDA_TPU_IMAGE_SIZE"])
        if os.environ.get("UDA_TPU_ENCODER"):
            cls.ENCODER_NAME = os.environ["UDA_TPU_ENCODER"]
        if os.environ.get("UDA_TPU_BATCH_SIZE"):
            cls.BATCH_SIZE = int(os.environ["UDA_TPU_BATCH_SIZE"])
        if os.environ.get("UDA_TPU_NUM_CLASSES"):
            cls.NUM_CLASSES = int(os.environ["UDA_TPU_NUM_CLASSES"])

    @classmethod
    def get_device(cls) -> torch.device:
        """The device ``DEVICE`` names, resolved by ``resolve_device``:
        ``cuda`` by default (RuntimeError without a GPU), ``cpu`` only when
        ``DEVICE`` says so."""
        return resolve_device(cls.DEVICE)

    @classmethod
    def setup_directories(cls) -> None:
        """Create the workspace directory layout (the JAX package's set)."""
        for d in (
            cls.LOGS_DIR,
            cls.CHECKPOINTS_DIR,
            cls.DATA_DIR,
            os.path.join(cls.DATA_DIR, "source"),
            os.path.join(cls.DATA_DIR, "target"),
            os.path.join(cls.RESULTS_DIR, "plots"),
            os.path.join(cls.RESULTS_DIR, "metrics"),
        ):
            Path(d).mkdir(parents=True, exist_ok=True)

    @classmethod
    def compute_dtype(cls) -> torch.dtype:
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[cls.COMPUTE_DTYPE]
