"""Device resolution for the port's entry points.

Counterpart of ``Config.get_device`` in the JAX package.  The port runs
on the GPU: ``cuda`` is the default, the CPU is used only when the
caller asks for it, and a missing GPU is an error -- never a silent
fall back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a GPU); else that device.

    Raises RuntimeError when CUDA is requested (explicitly or by
    default) and ``torch.cuda.is_available()`` is false.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
