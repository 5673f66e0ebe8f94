"""Dtype helpers shared by the ops."""

from __future__ import annotations

import torch


def to_f32(x: torch.Tensor) -> torch.Tensor:
    """Upcast to float32, the accumulation type of every op of the port.
    float64 stays as it is, so that the plain versions can be held against
    finite differences in double precision."""
    return x if x.dtype == torch.float64 else x.float()
