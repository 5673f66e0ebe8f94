"""Image-level domain discriminator.

Counterpart of the JAX package's ``models/discriminator.py``: four stride-2
4x4 convolutions with bias (3->64->128->256->512, padding 1), LeakyReLU
0.2, BatchNorm (the port's ``BatchNorm``, whose train mode takes its
statistics from the ``channel_sums`` kernels) on layers 2-4, a global
average pool, then ``Linear(512, 1)``.  The module returns float32 LOGITS
with ``return_logits=True`` and their sigmoid otherwise (the JAX package's
documented convention: training uses logit-BCE).

``forward`` takes NHWC input, as the JAX module; inside, activations are
NCHW views in channels_last memory, as ``bn_train`` requires.  Parameters
are float32; activations run in ``dtype``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from uda_aerial_semantic_segmentation_research_tpu_torch.models.resnet import Conv2d
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import (
    BatchNorm,
)

NEGATIVE_SLOPE = 0.2


class DomainDiscriminator(nn.Module):
    """Source (1) / target (0) classifier over whole images."""

    def __init__(self, input_channels: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        widths = (input_channels, 64, 128, 256, 512)
        for i in range(4):
            self.add_module(f"conv{i + 1}", Conv2d(widths[i], widths[i + 1], 4, stride=2,
                                                   padding=1, bias=True))
            if i:
                self.add_module(f"norm{i + 1}", BatchNorm(widths[i + 1], dtype=dtype))
        self.classifier = nn.Linear(512, 1)

    def forward(self, x, return_logits: bool = False):
        """(B, H, W, C) -> (B, 1) float32 logits, or probabilities."""
        y = F.leaky_relu(self.conv1(x.to(self.dtype).permute(0, 3, 1, 2)), NEGATIVE_SLOPE)
        for i in (2, 3, 4):
            y = getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(y))
            y = F.leaky_relu(y, NEGATIVE_SLOPE)
        y = y.mean(dim=(2, 3))                                  # global average pool
        logits = F.linear(y, self.classifier.weight.to(self.dtype),
                          self.classifier.bias.to(self.dtype)).float()
        return logits if return_logits else torch.sigmoid(logits)
