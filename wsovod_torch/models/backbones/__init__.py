from .resnet_wsl import WSRResNet, build_wsl_resnet_backbone
from .vgg import VGG16, build_vgg_backbone

# ``MODEL.BACKBONE.NAME`` -> builder; the MRRP names build the same modules,
# as in the JAX package. config.check_supported refuses the other names.
BACKBONES = {
    "build_wsl_resnet_backbone": build_wsl_resnet_backbone,
    "build_mrrp_wsl_resnet_backbone": build_wsl_resnet_backbone,
    "build_vgg_backbone": build_vgg_backbone,
    "build_mrrp_vgg_backbone": build_vgg_backbone,
}


def build_backbone(cfg):
    """The backbone ``MODEL.BACKBONE.NAME`` names; an unknown name raises."""
    name = cfg.MODEL.BACKBONE.NAME
    if name not in BACKBONES:
        raise NotImplementedError(f"MODEL.BACKBONE.NAME={name!r} is not ported")
    return BACKBONES[name](cfg)


__all__ = ["VGG16", "WSRResNet", "build_backbone", "build_vgg_backbone",
           "build_wsl_resnet_backbone"]
