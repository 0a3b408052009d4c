from .resnet_wsl import WSRResNet, build_wsl_resnet_backbone

# The WSR ResNet, plain or MRRP (``build_wsl_resnet_backbone`` and
# ``build_mrrp_wsl_resnet_backbone`` build the same module, as in the JAX
# package), is the one ported backbone; config.check_supported refuses the
# others by name before a model is built.
build_backbone = build_wsl_resnet_backbone

__all__ = ["WSRResNet", "build_wsl_resnet_backbone", "build_backbone"]
