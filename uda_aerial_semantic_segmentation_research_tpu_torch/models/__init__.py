"""Model factories of the PyTorch port.

``create_unet`` is the smp.Unet-analogue entry point: it builds a
``Unet``, draws its weights from a seeded ``torch.Generator`` with the
JAX package's initializers (lecun-normal convs, BatchNorm ones/zeros,
zero-initialized last norm of each residual block), and returns it in
eval mode on the device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
from uda_aerial_semantic_segmentation_research_tpu_torch.models.convert import (
    from_jax_state_dict,
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.models.resnet import (
    ENCODERS,
    Conv2d,
    ResNetEncoder,
    build_encoder,
    encoder_out_channels,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.models.unet import Unet
from uda_aerial_semantic_segmentation_research_tpu_torch.utils.device import (
    resolve_device,
)

# stddev correction of a normal truncated to +-2 sigma (flax variance_scaling)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_weights_(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Lecun-normal (truncated) conv kernels and zero conv biases."""
    for m in model.modules():
        if isinstance(m, Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            torch.nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                        generator=generator)
            if m.bias is not None:
                m.bias.zero_()


def create_unet(encoder_name: Optional[str] = None, classes: Optional[int] = None,
                in_channels: Optional[int] = None,
                activation: Optional[str] = None, seed: int = 0,
                dtype: Optional[torch.dtype] = None, device=None,
                fused_eval: bool = False) -> Unet:
    """Build a seeded U-Net in eval mode on ``device`` (default ``cuda``).

    ``dtype`` is the compute dtype (parameters stay float32);
    ``fused_eval`` routes the low-channel decoder blocks through the
    ``conv_bn_relu`` kernel in eval mode.
    """
    dev = resolve_device(device)
    model = Unet(encoder_name=encoder_name or Config.ENCODER_NAME,
                 classes=classes or Config.NUM_CLASSES,
                 in_channels=in_channels or Config.IN_CHANNELS,
                 activation=activation, dtype=dtype or Config.compute_dtype(),
                 fused_eval=fused_eval)
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(dev, memory_format=torch.channels_last).eval()


__all__ = ["ENCODERS", "ResNetEncoder", "Unet", "build_encoder", "create_unet",
           "encoder_out_channels", "from_jax_state_dict", "init_weights_",
           "to_jax_state_dict"]
