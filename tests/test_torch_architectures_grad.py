"""The seven other ``create_model`` families in train mode, against the
JAX package (CPU, float32): logits, BatchNorm buffers and the gradients of
a plain cross-entropy against ``jax.grad`` of the same loss.  Weights,
inputs, sizes, helpers and the tolerances with their reasons are
``tests/test_torch_architectures.py``'s, which holds the mobilenet_v2
U-Net the same way.  Then the entry points on the CPU: ``create_model``
with ``encoder_weights="imagenet"`` for every name, and ``train_model`` with
a non-U-Net ``Config.MODEL_NAME``.
"""

import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_adversarial import few_torch_threads  # noqa: F401  (autouse)
from tests.test_torch_architectures import CASES, check_gradients, check_train_mode
from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
from uda_aerial_semantic_segmentation_research_tpu_torch.models import (
    ARCHITECTURES,
    build_encoder,
    create_model,
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.training import train
from uda_aerial_semantic_segmentation_research_tpu_torch.visualization.tensorboard_logger import (
    read_events,
)

CLASSES = 7

FAMILIES = [case for case, (name, _, _) in CASES.items() if name != "Unet"]


@pytest.mark.parametrize("case", FAMILIES)
def test_train_mode_logits_and_buffers_match_jax(case):
    check_train_mode(case)


@pytest.mark.parametrize("case", FAMILIES)
def test_cross_entropy_gradients_match_jax(case):
    check_gradients(case)


@pytest.mark.parametrize("name", ["Unet", *ARCHITECTURES])
def test_imagenet_encoder_loads_into_every_model(name, tmp_path, monkeypatch):
    """``encoder_weights="imagenet"`` finds the encoder by its ``stem_conv``
    and loads a converted file in the JAX layout (``load_imagenet_encoder``),
    here mobilenet_v2's, whichever family holds it."""
    source = build_encoder("mobilenet_v2", dtype=torch.float32)
    npz = {}
    for k, v in to_jax_state_dict(source).items():
        coll, rest = k.split("/", 1)
        npz[rest if coll == "params" else f"batch_stats::{rest}"] = v
    np.savez(tmp_path / "mobilenet_v2_imagenet.npz", **npz)
    monkeypatch.setenv("UDA_TPU_PRETRAINED", str(tmp_path))
    monkeypatch.delenv("UDA_TPU_IMAGENET_NPZ", raising=False)
    model = create_model(name, "mobilenet_v2", encoder_weights="imagenet", classes=CLASSES,
                         dtype=torch.float32, device="cpu")
    for k, v in source.state_dict().items():
        torch.testing.assert_close(model.encoder.state_dict()[k], v, rtol=0, atol=0)


def test_train_model_with_a_non_unet_model_name(tmp_path, monkeypatch):
    """``train_model`` with ``Config.MODEL_NAME = "DeepLabV3Plus"`` over the
    ``setup_test_data`` fixtures: the trainer runs the family unchanged,
    logs finite train and validation scalars and writes its final
    checkpoint in the JAX layout."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.data.setup_test_data import (
        setup_test_data,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.models.architectures import (
        DeepLabV3Plus,
    )
    from uda_aerial_semantic_segmentation_research_tpu_torch.utils.checkpoint import (
        load_checkpoint,
    )

    monkeypatch.setattr(Config, "DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setattr(Config, "SAMPLE_DATA_DIR", str(tmp_path / "data" / "sample"))
    for name, value in (("LOGS_DIR", "logs"), ("CHECKPOINTS_DIR", "ckpt"),
                        ("CHECKPOINT_DIR", "final")):
        monkeypatch.setattr(Config, name, str(tmp_path / value))
    for name, value in (("DEVICE", "cpu"), ("MODEL_NAME", "DeepLabV3Plus"),
                        ("ENCODER_NAME", "resnet18"), ("IMAGE_SIZE", 32), ("BATCH_SIZE", 2),
                        ("NUM_WORKERS", 2), ("NUM_CLASSES", CLASSES)):
        monkeypatch.setattr(Config, name, value)
    setup_test_data(num_source=5, num_holyrood=0, image_size=40, force=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")                    # no converted ImageNet file
        model, _ = train.train_model(epochs=1)
    assert isinstance(model, DeepLabV3Plus) and model.dtype == torch.bfloat16
    scalars = {}
    for path in Path(tmp_path / "logs").rglob("events.out.tfevents.*"):
        for event in read_events(path):
            for v in event["values"]:
                if v["kind"] == "scalar":
                    scalars.setdefault(v["tag"], []).append(v["value"])
    for tag in ("train/loss", "train/iou", "val/loss", "val/iou"):
        assert scalars.get(tag) and np.isfinite(scalars[tag]).all(), tag
    final = load_checkpoint(tmp_path / "final" / "final_model.pth")
    state = final["model_state_dict"]
    assert set(state) == set(to_jax_state_dict(model))
    assert all(np.isfinite(v).all() for v in state.values())
