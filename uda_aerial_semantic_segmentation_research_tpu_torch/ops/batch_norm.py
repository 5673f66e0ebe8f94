"""Eval-mode BatchNorm with the flax formula.

Counterpart of the running-average branch of the JAX package's
``ops/lane_bn.py::BatchNorm``:

    y = ((x.f32 - mean) * (rsqrt(var + 1e-5) * scale) + bias).to(dtype)

Parameters are named ``scale``/``bias`` and buffers ``mean``/``var``, as
in the JAX checkpoint tree.  Train-mode statistics come with the
training slice; until then a module in train mode raises.
"""

from __future__ import annotations

import torch
from torch import nn

EPS = 1e-5  # flax / torch default, as every BatchNorm of the JAX package


class BatchNorm(nn.Module):
    """Per-channel BatchNorm over dim 1 of an NCHW (or channels_last) tensor."""

    def __init__(self, features: int, zero_scale: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        init = torch.zeros if zero_scale else torch.ones
        self.scale = nn.Parameter(init(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def folded(self):
        """(mul, bias) of the eval-mode affine: y = (x - mean) * mul + bias."""
        return torch.rsqrt(self.var + EPS) * self.scale, self.bias

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm is not ported yet; call model.eval()")
        mul, bias = self.folded()
        shape = (1, -1) + (1,) * (x.dim() - 2)
        y = (x.float() - self.mean.view(shape)) * mul.view(shape) + bias.view(shape)
        return y.to(self.dtype)
