"""The program's U-Net as ``create_unet`` builds it with its own defaults
(the model users train and serve), for a configuration of the ``Unet``
architecture on a ResNet encoder."""


def build(cfg, device):
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import create_unet

    return create_unet(encoder_name=cfg["encoder_name"], in_channels=cfg["in_channels"],
                       classes=cfg["classes"], device=device)
