"""Model factories of the PyTorch port.

``create_unet`` is the smp.Unet-analogue entry point: it builds a
``Unet``, draws its weights from a seeded ``torch.Generator`` with the
JAX package's initializers (lecun-normal convs, BatchNorm ones/zeros,
zero-initialized last norm of each residual block), and returns it in
eval mode on the device.  ``create_model`` selects the architecture by
name from the JAX package's registry (``Unet`` and the families of
``models.architectures``), on any encoder of ``ENCODERS``.
``create_discriminator`` builds the image-level domain discriminator the
same way, and ``create_uda_model`` the GRL stack's ``UDASegmentationModel``
(resnet50 by default, as in the JAX package).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config
from uda_aerial_semantic_segmentation_research_tpu_torch.models import architectures
from uda_aerial_semantic_segmentation_research_tpu_torch.models.discriminator import (
    DomainDiscriminator,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.models.domain_model import (
    DomainAdaptationModel,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.models.convert import (
    from_jax_state_dict,
    to_jax_state_dict,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.models.pretrained import (
    load_imagenet_encoder,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.models.resnet import (
    ENCODERS,
    Conv2d,
    ResNetEncoder,
    build_encoder,
    encoder_out_channels,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.models.uda import (
    FeatureDomainDiscriminator,
    UDALoss,
    UDASegmentationModel,
    gradient_reverse_layer,
)
from uda_aerial_semantic_segmentation_research_tpu_torch.models.unet import Unet
from uda_aerial_semantic_segmentation_research_tpu_torch.utils.device import (
    resolve_device,
)

# stddev correction of a normal truncated to +-2 sigma (flax variance_scaling)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_weights_(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Lecun-normal (truncated) conv and dense kernels, zero biases."""
    for m in model.modules():
        if isinstance(m, (Conv2d, torch.nn.Linear)):
            fan_in = (m.in_features if isinstance(m, torch.nn.Linear)
                      else m.weight[0].numel())       # a group's inputs x kh x kw
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            torch.nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                        generator=generator)
            if m.bias is not None:
                m.bias.zero_()


def create_unet(encoder_name: Optional[str] = None, encoder_weights: Optional[str] = None,
                in_channels: Optional[int] = None, classes: Optional[int] = None,
                activation: Optional[str] = None, image_size: Optional[int] = None,
                seed: int = 0, dtype: Optional[torch.dtype] = None, device=None,
                fused_eval: bool = False, remat=False,
                logits_dtype: torch.dtype = torch.float32, fused_decoder="auto") -> Unet:
    """Build a seeded U-Net in eval mode on ``device`` (default ``cuda``).

    The arguments up to ``dtype`` sit where the JAX ``create_unet`` has
    them.  ``encoder_weights="imagenet"`` then loads the local converted
    encoder checkpoint (``models.pretrained``; without the file a warning
    says that the encoder keeps its seeded weights).  ``image_size`` is
    accepted for the JAX signature; the port's initialization does not need
    a sample input.  ``dtype`` is the compute dtype (parameters stay
    float32); ``fused_eval`` routes the low-channel decoder blocks through
    the ``conv_bn_relu`` kernel in eval mode; ``remat``, ``logits_dtype`` and
    ``fused_decoder`` are the ``Unet``'s (the JAX ``create_unet`` passes them
    through its ``**unet_kwargs``).
    """
    del image_size
    dev = resolve_device(device)
    encoder_name = encoder_name or Config.ENCODER_NAME
    model = Unet(encoder_name=encoder_name,
                 classes=classes or Config.NUM_CLASSES,
                 in_channels=in_channels or Config.IN_CHANNELS,
                 activation=activation, dtype=dtype or Config.compute_dtype(),
                 fused_eval=fused_eval, remat=remat, logits_dtype=logits_dtype,
                 fused_decoder=fused_decoder)
    init_weights_(model, torch.Generator().manual_seed(seed))
    model = model.to(dev, memory_format=torch.channels_last).eval()
    if encoder_weights == "imagenet":
        load_imagenet_encoder(model, encoder_name)
    return model


def create_discriminator(input_channels: int = 3, image_size: Optional[int] = None,
                         seed: int = 1, dtype: Optional[torch.dtype] = None,
                         device=None) -> DomainDiscriminator:
    """Build a seeded image-level domain discriminator in eval mode on
    ``device`` (default ``cuda``).  ``image_size`` is accepted for the JAX
    signature; the port's initialization does not need a sample input."""
    del image_size
    dev = resolve_device(device)
    model = DomainDiscriminator(input_channels, dtype=dtype or Config.compute_dtype())
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(dev, memory_format=torch.channels_last).eval()


def create_uda_model(encoder_name: str = "resnet50", classes: Optional[int] = None,
                     image_size: Optional[int] = None, seed: int = 0,
                     dtype: Optional[torch.dtype] = None, device=None) -> UDASegmentationModel:
    """Build a seeded ``UDASegmentationModel`` (U-Net + feature discriminator)
    in eval mode on ``device`` (default ``cuda``), without ImageNet weights,
    as the JAX ``create_uda_model``.  ``image_size`` is accepted for the JAX
    signature; the port's initialization does not need a sample input."""
    del image_size
    dev = resolve_device(device)
    model = UDASegmentationModel(encoder_name=encoder_name,
                                 classes=classes or Config.NUM_CLASSES,
                                 dtype=dtype or Config.compute_dtype())
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(dev, memory_format=torch.channels_last).eval()


# the JAX package's create_model registry, by name
ARCHITECTURES = {"FPN": architectures.FPN, "PSPNet": architectures.PSPNet,
                 "Linknet": architectures.Linknet,
                 "DeepLabV3Plus": architectures.DeepLabV3Plus,
                 "UnetPlusPlus": architectures.UnetPlusPlus, "PAN": architectures.PAN,
                 "MAnet": architectures.MAnet}


def create_model(model_name: Optional[str] = None, encoder_name: Optional[str] = None,
                 encoder_weights: Optional[str] = None, in_channels: Optional[int] = None,
                 classes: Optional[int] = None, image_size: Optional[int] = None,
                 seed: int = 0, dtype: Optional[torch.dtype] = None, device=None,
                 **arch_kwargs) -> torch.nn.Module:
    """By-name architecture factory (defaults from ``Config``), with the JAX
    ``create_model``'s arguments in their positions and its registry:
    ``Unet``, ``UnetPlusPlus``, ``FPN``, ``PSPNet``, ``Linknet``,
    ``DeepLabV3Plus``, ``PAN``, ``MAnet``.  A seeded model in eval mode on
    ``device`` (default ``cuda``); ``encoder_weights="imagenet"`` loads the
    local converted encoder checkpoint (``models.pretrained``); ``image_size``
    is accepted for the JAX signature (the port's initialization needs no
    sample input).  ``arch_kwargs`` go to the architecture's constructor:
    ``remat``, ``logits_dtype``, ``fused_eval``, ``fused_decoder`` to the ``Unet`` (through
    ``create_unet``), ``bins``, ``atrous_rates``, ``pyramid_channels``, ... to
    the others; ``layout="smp"`` to ``DeepLabV3Plus`` builds smp's own
    DeepLabV3+ (output stride 16, separable ASPP, dropout), whose dropout
    masks ``seed`` also seeds (``DeepLabV3Plus.seed_dropout``)."""
    model_name = model_name or Config.MODEL_NAME
    encoder_name = encoder_name or Config.ENCODER_NAME
    if model_name == "Unet":
        return create_unet(encoder_name, encoder_weights, in_channels=in_channels,
                           classes=classes, image_size=image_size, seed=seed, dtype=dtype,
                           device=device, **arch_kwargs)
    if model_name not in ARCHITECTURES:
        raise ValueError(f"Unknown model '{model_name}'; "
                         f"available: {sorted([*ARCHITECTURES, 'Unet'])}")
    dev = resolve_device(device)
    model = ARCHITECTURES[model_name](encoder_name=encoder_name,
                                      classes=classes or Config.NUM_CLASSES,
                                      in_channels=in_channels or Config.IN_CHANNELS,
                                      dtype=dtype or Config.compute_dtype(), **arch_kwargs)
    init_weights_(model, torch.Generator().manual_seed(seed))
    if hasattr(model, "seed_dropout"):
        model.seed_dropout(seed)
    model = model.to(dev, memory_format=torch.channels_last).eval()
    if encoder_weights == "imagenet":
        load_imagenet_encoder(model, encoder_name)
    return model


__all__ = ["ENCODERS", "DomainAdaptationModel", "DomainDiscriminator",
           "FeatureDomainDiscriminator", "ResNetEncoder", "UDALoss", "UDASegmentationModel",
           "Unet", "build_encoder", "create_discriminator", "create_model", "create_uda_model",
           "create_unet", "encoder_out_channels", "from_jax_state_dict",
           "gradient_reverse_layer", "init_weights_", "load_imagenet_encoder",
           "to_jax_state_dict"]
