"""Feature-level UDA components: gradient reversal, feature discriminator,
single-pass UDA segmentation model, combined UDA loss.

Counterpart of the JAX package's ``models/uda.py``:

- ``gradient_reverse_layer``      identity forward, ``-alpha * g`` backward
  (a ``torch.autograd.Function`` where JAX has a ``custom_vjp``);
- ``FeatureDomainDiscriminator``  three 3x3 conv + BatchNorm + ReLU layers
  (512, 256, 128 channels) over the encoder's bottleneck, a 1x1 conv to
  one channel, a global mean: float32 ``(B, 1)`` logits;
- ``UDASegmentationModel``        a U-Net whose bottleneck feeds that
  discriminator through the GRL, so one traversal gives the segmentation
  and the domain logits;
- ``UDALoss``                     ``SMPDiceLoss`` + ``lambda_adv`` * BCE.

The attribute names are the JAX module names (``net``,
``domain_discriminator``, ``conv1``..``conv4``, ``norm1``..``norm3``), so
``models.convert`` maps the JAX variable tree onto this module key for key.
Train or eval mode comes from ``nn.Module.train()``; train-mode BatchNorm
takes its statistics from the ``channel_sums`` kernels (``ops.batch_norm``).
"""

from __future__ import annotations

import torch
from torch import nn

from uda_aerial_semantic_segmentation_research_tpu_torch.models.resnet import (
    Conv2d,
    encoder_out_channels,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.models.unet import Unet
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.batch_norm import BatchNorm
from uda_aerial_semantic_segmentation_research_tpu_torch.ops.losses import (
    SMPDiceLoss,
    sigmoid_bce_with_logits,
)


class _GradientReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # the product in float32, rounded once to the gradient's dtype, as
        # JAX's ``(-alpha * g).astype(g.dtype)`` with a float32 alpha
        return (g.float() * -ctx.alpha).to(g.dtype), None


def gradient_reverse_layer(x, alpha=1.0):
    """Identity forward; the incoming gradient times ``-alpha`` backward.

    ``alpha`` (a Python float or a 0-d float32 tensor on ``x``'s device)
    gets no gradient and is never read back to the host, so a schedule can
    feed it as a device scalar."""
    return _GradientReverse.apply(x, alpha)


class FeatureDomainDiscriminator(nn.Module):
    """Conv stack over bottleneck features: C -> 512 -> 256 -> 128 -> 1, then
    a global mean.  ``forward`` takes NHWC input, as the JAX module."""

    def __init__(self, num_channels: int = 512, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        widths = (num_channels, 512, 256, 128)
        for i in range(3):
            self.add_module(f"conv{i + 1}", Conv2d(widths[i], widths[i + 1], 3, padding=1,
                                                   bias=True))
            self.add_module(f"norm{i + 1}", BatchNorm(widths[i + 1], dtype=dtype))
        self.conv4 = Conv2d(128, 1, 1, bias=True)

    def forward(self, x, return_logits: bool = True):
        """(B, H, W, C) -> (B, 1) float32 logits, or their sigmoid."""
        y = x.to(self.dtype).permute(0, 3, 1, 2)
        for i in (1, 2, 3):
            y = torch.relu(getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(y)))
        logits = self.conv4(y).mean(dim=(2, 3)).float()
        return logits if return_logits else torch.sigmoid(logits)


class UDASegmentationModel(nn.Module):
    """U-Net whose bottleneck feeds a feature-level domain head through a GRL.

    ``forward(x, domain_adaptation=True, alpha=a)`` returns ``(seg_logits,
    domain_logits)`` from one traversal; the encoder receives the domain
    loss's gradient reversed and scaled by ``alpha``."""

    def __init__(self, encoder_name: str = "resnet50", classes: int = 23,
                 in_channels: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.classes = classes
        self.dtype = dtype
        self.net = Unet(encoder_name=encoder_name, classes=classes,
                        in_channels=in_channels, dtype=dtype)
        self.domain_discriminator = FeatureDomainDiscriminator(
            num_channels=encoder_out_channels(encoder_name)[-1], dtype=dtype)

    def forward(self, x, domain_adaptation: bool = False, alpha=1.0,
                domain_only: bool = False):
        """``x`` NHWC -> float32 NHWC segmentation logits, or with
        ``domain_adaptation`` ``(seg, (B, 1) domain logits)``.

        ``domain_only=True`` runs encoder -> GRL -> domain head and returns
        ``(None, domain_logits)``: no decoder forward, so the decoder's
        BatchNorm statistics do not see the batch (gradient-exact for a
        caller that discards the segmentation)."""
        features = self.net.encode(x)
        seg = None if domain_only else self.net.decode(features)
        if not domain_adaptation:
            return seg
        reversed_feat = gradient_reverse_layer(features[-1], alpha)
        return seg, self.domain_discriminator(reversed_feat.permute(0, 2, 3, 1))

    def get_encoder_features(self, x):
        """The bottleneck feature map, NHWC, in this module's mode."""
        return self.net.encode(x)[-1].permute(0, 2, 3, 1)


class UDALoss:
    """``SMPDiceLoss(pred, target) + lambda_adv * BCE(domain_pred,
    domain_target)`` (the dice term alone without domain inputs)."""

    def __init__(self, lambda_adv: float = 0.001):
        self.segmentation_loss = SMPDiceLoss()
        self.lambda_adv = float(lambda_adv)

    def __call__(self, pred, target, domain_pred=None, domain_target=None):
        seg_loss = self.segmentation_loss(pred, target)
        if domain_pred is not None and domain_target is not None:
            return seg_loss + self.lambda_adv * sigmoid_bce_with_logits(domain_pred,
                                                                        domain_target)
        return seg_loss
