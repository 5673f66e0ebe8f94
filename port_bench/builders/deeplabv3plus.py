"""The program's DeepLabV3+ as ``create_model`` builds it in smp's layout
(``layout="smp"``: output stride 16, separable ASPP, dropout), with the
configuration's dropout seed, for a configuration of the ``DeepLabV3Plus``
architecture on a ResNet encoder."""


def build(cfg, device):
    from uda_aerial_semantic_segmentation_research_tpu_torch.models import create_model

    return create_model("DeepLabV3Plus", cfg["encoder_name"], in_channels=cfg["in_channels"],
                        classes=cfg["classes"], layout="smp", seed=cfg["dropout_seed"],
                        device=device)
