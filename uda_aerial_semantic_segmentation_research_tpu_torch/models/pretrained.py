"""ImageNet-pretrained encoder weights from a local converted file.

Counterpart of the JAX package's ``models/pretrained.py::load_imagenet_encoder``.
No weights are downloaded: the file is the JAX package's converted
checkpoint, ``$UDA_TPU_IMAGENET_NPZ`` or
``$UDA_TPU_PRETRAINED/<encoder>_imagenet.npz`` (``pretrained/`` by
default), in the JAX layout (``stem_conv/kernel`` HWIO,
``stage1_block0/Conv_0/kernel``, ``batch_stats::stem_norm/mean``, ...).  Its
entries are mapped onto the port's encoder through
``models.convert.from_jax_state_dict``.  When the file is absent the
encoder keeps its seeded initialization and a warning says so.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.models.convert import (
    from_jax_state_dict,
)

PRETRAINED_ENV = "UDA_TPU_PRETRAINED"
PRETRAINED_FILE_ENV = "UDA_TPU_IMAGENET_NPZ"   # one file; wins over the directory


def load_imagenet_encoder(model: torch.nn.Module, encoder_name: str) -> bool:
    """Merge a converted ImageNet checkpoint into ``model``'s encoder; True
    when at least one tensor was loaded, False (with a warning) when there
    is no file."""
    path = os.environ.get(PRETRAINED_FILE_ENV)
    if not path:
        root = os.environ.get(PRETRAINED_ENV, "pretrained")
        path = os.path.join(root, f"{encoder_name}_imagenet.npz")
    if not os.path.exists(path):
        warnings.warn(
            f"encoder_weights='imagenet' requested but no converted checkpoint "
            f"at {path} (set ${PRETRAINED_FILE_ENV} to a converted file or "
            f"${PRETRAINED_ENV} to its directory); encoder stays randomly "
            f"initialized", stacklevel=2)
        return False

    state = model.state_dict()
    stem = next((k for k in state if ".stem_conv." in k), None)
    if stem is None:
        raise ValueError("could not locate the encoder in the model")
    prefix = stem.split("stem_conv.")[0].replace(".", "/")       # e.g. "encoder/"
    flat = {}
    with np.load(path) as blob:
        for k in blob.files:
            if k.startswith("batch_stats::"):
                flat[f"batch_stats/{prefix}{k[len('batch_stats::'):]}"] = blob[k]
            else:
                flat[f"params/{prefix}{k}"] = blob[k]
    hits = 0
    for k, v in from_jax_state_dict(flat).items():
        if k in state:
            state[k] = v
            hits += 1
    model.load_state_dict(state, strict=True)
    return hits > 0
