"""ImageNet-pretrained encoder weights from a local converted file.

Counterpart of the JAX package's ``models/pretrained.py``
(``convert_torch_resnet``, ``load_imagenet_encoder``) and of
``tools/convert_imagenet.py``.  No weights are downloaded: the file is a
converted checkpoint, ``$UDA_TPU_IMAGENET_NPZ`` or
``$UDA_TPU_PRETRAINED/<encoder>_imagenet.npz`` (``pretrained/`` by
default), in the JAX layout (``stem_conv/kernel`` HWIO,
``stage1_block0/Conv_0/kernel``, ``batch_stats::stem_norm/mean``, ...).  Its
entries are mapped onto the port's encoder through
``models.convert.from_jax_state_dict``.  When the file is absent the
encoder keeps its seeded initialization and a warning says so.

``convert_torch_resnet`` maps a torchvision-layout ResNet ``state_dict`` onto
that flat JAX layout, from the port's own encoder table.  The module's
command line writes the file without JAX, where ``tools/convert_imagenet.py``
(which imports the JAX package) cannot run::

    python -m uda_aerial_semantic_segmentation_research_tpu_torch.models.pretrained \
        resnet34 /path/to/resnet34-weights.pth [--out-dir pretrained]
    # -> <out-dir>/resnet34_imagenet.npz ($UDA_TPU_PRETRAINED, else ./pretrained)
"""

from __future__ import annotations

import argparse
import os
import warnings
from typing import Dict

import numpy as np
import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.models.convert import (
    from_jax_state_dict,
)

PRETRAINED_ENV = "UDA_TPU_PRETRAINED"
PRETRAINED_FILE_ENV = "UDA_TPU_IMAGENET_NPZ"   # one file; wins over the directory


def _bn(prefix_t: str, prefix_j: str, sd, out: Dict[str, np.ndarray]):
    out[f"{prefix_j}/scale"] = np.asarray(sd[f"{prefix_t}.weight"])
    out[f"{prefix_j}/bias"] = np.asarray(sd[f"{prefix_t}.bias"])
    out[f"batch_stats::{prefix_j}/mean"] = np.asarray(sd[f"{prefix_t}.running_mean"])
    out[f"batch_stats::{prefix_j}/var"] = np.asarray(sd[f"{prefix_t}.running_var"])


def _conv(name_t: str, name_j: str, sd, out: Dict[str, np.ndarray]):
    out[f"{name_j}/kernel"] = np.transpose(np.asarray(sd[name_t]), (2, 3, 1, 0))  # OIHW -> HWIO


def convert_torch_resnet(sd: Dict, encoder_name: str) -> Dict[str, np.ndarray]:
    """torchvision resnet{18,34,50,101,152} ``state_dict`` (tensors or numpy
    arrays) -> the flat JAX-layout mapping that ``load_imagenet_encoder``
    reads: ``stem_conv``, ``stem_norm``, ``stage{s}_block{b}/Conv_{c}`` and
    ``/BatchNorm_{c}`` in definition order, ``downsample_{conv,norm}``; HWIO
    kernels; running statistics under ``batch_stats::``.  The values are the
    state dict's, transposed, never rounded."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.models.resnet import (
        ENCODERS,
        Bottleneck,
    )

    spec = ENCODERS[encoder_name]
    if spec["stage_sizes"] is None:
        raise ValueError(f"convert_torch_resnet converts ResNets, not {encoder_name}")
    sd = {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v for k, v in sd.items()}
    n_convs = 3 if spec["block_cls"] is Bottleneck else 2
    out: Dict[str, np.ndarray] = {}
    _conv("conv1.weight", "stem_conv", sd, out)
    _bn("bn1", "stem_norm", sd, out)
    for s, n_blocks in enumerate(spec["stage_sizes"]):
        for b in range(n_blocks):
            t, j = f"layer{s + 1}.{b}", f"stage{s + 1}_block{b}"
            for c in range(n_convs):
                _conv(f"{t}.conv{c + 1}.weight", f"{j}/Conv_{c}", sd, out)
                _bn(f"{t}.bn{c + 1}", f"{j}/BatchNorm_{c}", sd, out)
            if f"{t}.downsample.0.weight" in sd:
                _conv(f"{t}.downsample.0.weight", f"{j}/downsample_conv", sd, out)
                _bn(f"{t}.downsample.1", f"{j}/downsample_norm", sd, out)
    return out


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


def _load_state_dict(path: str):
    """A torch ``state_dict`` file (raw, or inside ``state_dict`` / ``model`` /
    ``model_state_dict``) or a flat ``.npz``, with the ``module.`` and
    ``encoder.`` prefixes stripped."""
    if path.endswith(".npz"):
        with np.load(path) as blob:
            return {k: blob[k] for k in blob.files}
    blob = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model", "model_state_dict"):
        if isinstance(blob, dict) and key in blob:
            blob = blob[key]
            break
    out = {}
    for k, v in blob.items():
        for pref in ("module.", "encoder."):
            if k.startswith(pref):
                k = k[len(pref):]
        out[k] = v
    return out


def main(argv=None) -> int:
    """Convert a ResNet weights file to ``<out-dir>/<encoder>_imagenet.npz``
    (the arguments of ``tools/convert_imagenet.py``)."""
    ap = argparse.ArgumentParser(description="Convert a torchvision ResNet state_dict "
                                             "into the encoder file load_imagenet_encoder "
                                             "reads.")
    ap.add_argument("encoder", help="resnet18 | resnet34 | resnet50 | resnet101 | resnet152")
    ap.add_argument("weights", help="torch .pth/.pt state_dict or .npz")
    ap.add_argument("--out-dir", default=os.environ.get(PRETRAINED_ENV, "pretrained"))
    args = ap.parse_args(argv)

    flat = convert_torch_resnet(_load_state_dict(args.weights), args.encoder)
    n_params = sum(1 for k in flat if not k.startswith("batch_stats::"))
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, f"{args.encoder}_imagenet.npz")
    np.savez(out, **{k: np.asarray(v, dtype=np.float32) for k, v in flat.items()})
    print(f"wrote {out}: {n_params} param arrays + {len(flat) - n_params} BN stats "
          f"({sum(v.size for v in flat.values()):,} values)")
    print(f"use: export {PRETRAINED_ENV}={args.out_dir}; "
          f"create_unet(..., encoder_weights='imagenet') now loads it")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
