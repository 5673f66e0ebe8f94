"""Weight bridge: JAX ``ModelBundle.state_dict()`` -> torch ``state_dict``.

The JAX package flattens its variables to ``{'params/a/b/leaf': array,
'batch_stats/a/b/leaf': array}``.  The port keeps the same module paths
with three renames:

- ``.../kernel`` (HWIO) -> ``....weight`` (OIHW);
- the encoder's auto-named ``Conv_{i}`` / ``BatchNorm_{i}`` ->
  ``conv{i+1}`` / ``bn{i+1}`` (torchvision's names);
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
            if arr.ndim != 4:
                raise ValueError(f"expected an HWIO kernel at {key!r}, got {arr.shape}")
            out[f"{path}.weight"] = torch.from_numpy(
                np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
        else:
            out[f"{path}.{leaf}"] = torch.from_numpy(arr.copy())
    for path, leaves in leaves_at.items():
        missing = [n for n in _NORM_LEAVES if n not in leaves]
        if leaves & {"scale", "mean", "var"} and missing:
            raise ValueError(f"BatchNorm {path!r} lacks {missing}")
    return out
