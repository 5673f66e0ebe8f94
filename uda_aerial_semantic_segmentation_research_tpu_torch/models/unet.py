"""U-Net segmentation model (smp.Unet-style) with a fused eval path.

Counterpart of the JAX package's ``models/unet.py``: ResNet encoder ->
five decoder blocks with skip connections (channels 256/128/64/32/16)
-> 3x3 segmentation head.  The decoder uses the naive upsample -> concat
-> conv schedule, which is what the JAX ``fused_decoder="auto"``
resolves to off the TPU.

``fused_eval=True`` is the counterpart of the JAX pair
``packed_decoder=True, pallas_eval=True``: in eval mode, each decoder
block with <= 32 filters and even H, W runs BN1-affine + ReLU + conv2
as one CUDA kernel (``ops.conv_bn_relu``).  With the default decoder
channels that is blocks 3 and 4: two launches per forward.  The JAX
space-to-depth packing is a TPU lane trick, numerically a plain conv,
and is not ported.

``Unet.forward`` takes NHWC input and returns float32 NHWC logits;
inside, tensors are NCHW views in channels_last memory.  ``encode`` /
``decode`` split it at the encoder pyramid (kept NCHW), for the
feature-level domain discriminator of ``models.uda``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from uda_aerial_semantic_segmentation_research_tpu_torch.models.resnet import (
    build_encoder,
    conv,
    encoder_out_channels,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import (
    BatchNorm,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.conv_bn_relu import (
    conv_bn_relu,
)

FUSED_MAX_FILTERS = 32


class DecoderBlock(nn.Module):
    """Upsample 2x -> concat skip -> (conv3x3 + BN + ReLU) x 2."""

    def __init__(self, cin: int, cskip: int, filters: int,
                 dtype: torch.dtype = torch.bfloat16, fused_eval: bool = False):
        super().__init__()
        self.dtype = dtype
        self.filters = filters
        self.fused_eval = fused_eval
        self.conv1 = conv(cin + cskip, filters, 3)
        self.norm1 = BatchNorm(filters, dtype=dtype)
        self.conv2 = conv(filters, filters, 3)
        self.norm2 = BatchNorm(filters, dtype=dtype)

    def _fused_conv2(self, y):
        """norm1 folded to an affine (as the JAX pallas_eval branch),
        then relu + conv2 in one kernel launch on the NHWC view."""
        inv, bias = self.norm1.folded()
        shift = bias - self.norm1.mean * inv
        # guard the fold against an exactly-zero BN scale, as the JAX fold
        inv = torch.where(inv.abs() < 1e-12, torch.full_like(inv, 1e-12), inv)
        k3 = self.conv2.weight.to(self.dtype).permute(2, 3, 1, 0)   # OIHW -> HWIO
        y2 = conv_bn_relu(y.permute(0, 2, 3, 1).contiguous(), k3, inv, shift)
        return y2.permute(0, 3, 1, 2)

    def forward(self, x, skip: Optional[torch.Tensor] = None):
        y = F.interpolate(x.to(self.dtype), scale_factor=2, mode="nearest")
        if skip is not None:
            y = torch.cat([y, skip.to(self.dtype)], dim=1)
        y = self.conv1(y)
        if (self.fused_eval and not self.training
                and self.filters <= FUSED_MAX_FILTERS
                and y.shape[2] % 2 == 0 and y.shape[3] % 2 == 0):
            return torch.relu(self.norm2(self._fused_conv2(y)))
        x = torch.relu(self.norm1(y))
        return torch.relu(self.norm2(self.conv2(x)))


class UnetDecoder(nn.Module):
    """Five decoder blocks ``block0..block4`` over an NCHW pyramid."""

    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 dtype: torch.dtype = torch.bfloat16, fused_eval: bool = False):
        super().__init__()
        # skips: /16, /8, /4, /2, none (features[1:-1] reversed)
        skip_ch = list(encoder_channels[1:-1])[::-1] + [0]
        cin = encoder_channels[-1]
        for i, (ch, cs) in enumerate(zip(decoder_channels, skip_ch)):
            self.add_module(f"block{i}", DecoderBlock(cin, cs, ch, dtype, fused_eval))
            cin = ch
        self.n_blocks = len(decoder_channels)

    def forward(self, features):
        skips = list(features[1:-1])[::-1] + [None]
        x = features[-1]
        for i, skip in zip(range(self.n_blocks), skips):
            x = getattr(self, f"block{i}")(x, skip)
        return x


class Unet(nn.Module):
    """Encoder-decoder semantic segmentation network (NHWC in and out)."""

    def __init__(self, encoder_name: str = "resnet34", classes: int = 23,
                 in_channels: int = 3,
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 activation: Optional[str] = None,
                 dtype: torch.dtype = torch.bfloat16, fused_eval: bool = False):
        super().__init__()
        if activation not in (None, "softmax", "sigmoid"):
            raise ValueError(f"unknown activation {activation!r}")
        self.classes = classes
        self.activation = activation
        self.dtype = dtype
        self.encoder = build_encoder(encoder_name, in_channels, dtype)
        self.decoder = UnetDecoder(encoder_out_channels(encoder_name),
                                   decoder_channels, dtype, fused_eval)
        self.segmentation_head = conv(decoder_channels[-1], classes, 3, bias=True)

    def encode(self, x):
        """(B, H, W, in_channels) -> the encoder pyramid ``[identity, /2, /4,
        /8, /16, /32]`` in the internal NCHW form (channels_last memory)."""
        return self.encoder.features(x.permute(0, 3, 1, 2))

    def _logits(self, features):
        return self.segmentation_head(self.decoder(features)).float()

    def decode(self, features):
        """The pyramid of ``encode`` -> float32 logits (B, H, W, classes),
        before any ``activation`` (the JAX ``Unet.decode``)."""
        return self._logits(features).permute(0, 2, 3, 1).contiguous()

    def forward(self, x):
        """(B, H, W, in_channels) -> float32 logits (B, H, W, classes)."""
        y = self._logits(self.encode(x))
        if self.activation == "softmax":
            y = torch.softmax(y, dim=1)
        elif self.activation == "sigmoid":
            y = torch.sigmoid(y)
        return y.permute(0, 2, 3, 1).contiguous()
