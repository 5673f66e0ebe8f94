"""Weight bridge between JAX ``ModelBundle.state_dict()`` and torch
``state_dict`` (``from_jax_state_dict`` and its inverse ``to_jax_state_dict``).

The JAX package flattens its variables to ``{'params/a/b/leaf': array,
'batch_stats/a/b/leaf': array}``.  The port keeps the same module paths
with three renames:

- ``.../kernel`` -> ``....weight``: a conv's HWIO becomes OIHW (a
  depthwise ``(kh, kw, 1, C)`` becomes ``(C, 1, kh, kw)``), a dense
  layer's (in, out) becomes ``nn.Linear``'s (out, in);
- the encoder blocks' auto-named ``Conv_{i}`` / ``BatchNorm_{i}`` ->
  ``conv{i+1}`` / ``bn{i+1}`` (torchvision's names; the ResNet blocks
  ``stage{s}_block{b}``, MobileNetV2's ``ir0`` and ``stage{s}_block{b}``);
- ``/`` -> ``.``.

BatchNorm ``scale``/``bias`` (params) and ``mean``/``var``
(batch_stats) keep their names.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_AUTO = re.compile(r"^(Conv|BatchNorm)_(\d+)$")
_LEAVES = {"params": {"kernel", "bias", "scale"}, "batch_stats": {"mean", "var"}}
_NORM_LEAVES = ("scale", "bias", "mean", "var")
_PORT_AUTO = re.compile(r"^(conv|bn)(\d+)$")
_ENCODER_BLOCK = re.compile(r"^(stage\d+_block\d+|ir0)$")


def _module_path(parts) -> str:
    out = []
    for p in parts:
        m = _AUTO.match(p)
        if m:
            p = ("conv" if m.group(1) == "Conv" else "bn") + str(int(m.group(2)) + 1)
        out.append(p)
    return ".".join(out)


def from_jax_state_dict(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Map a flat JAX variable dict onto the port's parameter names.

    Raises ValueError on a key that maps to nothing (unknown collection
    or leaf) and on a BatchNorm that lacks one of scale/bias/mean/var.
    Load the result with ``model.load_state_dict(sd, strict=True)``,
    which raises on any torch key left unfilled.
    """
    out: Dict[str, torch.Tensor] = {}
    leaves_at: Dict[str, set] = {}
    for key, value in flat.items():
        parts = key.split("/")
        coll, leaf = parts[0], parts[-1]
        if len(parts) < 3 or leaf not in _LEAVES.get(coll, ()):
            raise ValueError(f"unmapped JAX key {key!r}")
        path = _module_path(parts[1:-1])
        leaves_at.setdefault(path, set()).add(leaf)
        arr = np.asarray(value, dtype=np.float32)
        if leaf == "kernel":
            if arr.ndim not in (2, 4):
                raise ValueError(f"expected an HWIO or (in, out) kernel at {key!r}, "
                                 f"got {arr.shape}")
            order = (3, 2, 0, 1) if arr.ndim == 4 else (1, 0)
            out[f"{path}.weight"] = torch.from_numpy(np.array(arr.transpose(order), order="C"))
        else:
            out[f"{path}.{leaf}"] = torch.from_numpy(arr.copy())
    for path, leaves in leaves_at.items():
        missing = [n for n in _NORM_LEAVES if n not in leaves]
        if leaves & {"scale", "mean", "var"} and missing:
            raise ValueError(f"BatchNorm {path!r} lacks {missing}")
    return out


def _jax_module_path(parts) -> str:
    """Inverse of ``_module_path``: ``conv{i}`` / ``bn{i}`` directly under an
    encoder block (``stage{s}_block{b}``, ``ir0``) are flax's auto-named
    ``Conv_{i-1}`` / ``BatchNorm_{i-1}``; every other name is kept."""
    out = []
    for i, p in enumerate(parts):
        m = _PORT_AUTO.match(p)
        if m and i > 0 and _ENCODER_BLOCK.match(parts[i - 1]):
            p = ("Conv" if m.group(1) == "conv" else "BatchNorm") + f"_{int(m.group(2)) - 1}"
        out.append(p)
    return "/".join(out)


def to_jax_state_dict(model: torch.nn.Module, grads: bool = False) -> Dict[str, np.ndarray]:
    """The model's parameters and BatchNorm buffers under the JAX flat keys
    (``params/...``, ``batch_stats/...``; kernels back in HWIO / (in, out)), as
    float32 numpy arrays, so that two states compare key by key.

    With ``grads=True`` returns the parameters' ``.grad`` under the
    ``params/...`` keys instead (a parameter without a gradient raises).
    """
    out: Dict[str, np.ndarray] = {}
    tensors = dict(model.named_parameters())
    if grads:
        missing = [k for k, p in tensors.items() if p.grad is None]
        if missing:
            raise ValueError(f"parameters without a gradient: {missing}")
        tensors = {k: p.grad for k, p in tensors.items()}
    else:
        tensors.update(model.named_buffers())
    for name, t in tensors.items():
        *parts, leaf = name.split(".")
        arr = t.detach().float().cpu().numpy().copy()   # never a view of the model
        if leaf == "weight":
            order = (2, 3, 1, 0) if arr.ndim == 4 else (1, 0)
            leaf, arr = "kernel", np.ascontiguousarray(arr.transpose(order))
        coll = "batch_stats" if leaf in _LEAVES["batch_stats"] else "params"
        out[f"{coll}/{_jax_module_path(parts)}/{leaf}"] = arr
    return out
