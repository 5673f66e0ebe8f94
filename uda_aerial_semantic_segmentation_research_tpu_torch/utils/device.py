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


def refuse_under_capture(what: str) -> None:
    """Raise when the current CUDA stream is capturing a graph.

    A kernel wrapper calls this where it does host-side set-up that it keeps
    across calls: building or loading a library, a function-attribute or
    occupancy query, a device constant or a scratch buffer held in a
    module-level cache.  Under capture none of that is recorded, and a
    buffer made there would live in the graph's private pool.  Run the step
    once on the capture stream before capturing it (``make_scan_driver``'s
    warm-up does)."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what} must not happen during CUDA graph capture: run the "
                           "work once on the capture stream before capturing it")
