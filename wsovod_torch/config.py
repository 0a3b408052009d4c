"""Configuration: the JAX package's ``CfgNode`` defaults with the port's own
defaults on top, and a check that refuses every key asking for a path the
port does not have yet.

The YAML loader and the default tree are reused by import from
``wsovod_tpu.config`` (pure Python + YAML). ``wsovod_tpu/__init__.py`` tries
to enable JAX's compile cache when it is imported; ``WSOVOD_NO_COMPILE_CACHE``
makes it return before it touches ``jax``, so importing the config never
imports JAX, whether JAX is installed or not.
"""

from __future__ import annotations

import os

os.environ.setdefault("WSOVOD_NO_COMPILE_CACHE", "1")

from wsovod_tpu.config import CfgNode  # noqa: E402
from wsovod_tpu.config import get_cfg as _reference_get_cfg  # noqa: E402

__all__ = ["CfgNode", "get_cfg", "check_supported"]


def get_cfg() -> CfgNode:
    """The reference defaults with the port's own defaults:

    * ``TPU.DAN_FC1_QUANT = "none"`` and ``TPU.RPN_CONV_QUANT = "none"`` (the
      JAX package defaults both to its TPU-only int8 paths, which the port
      does not have);
    * ``TPU.COMPUTE_DTYPE = "bfloat16"`` (parameters stay float32);
    * ``MODEL.DEVICE = "cuda"``.
    """
    cfg = _reference_get_cfg()
    cfg.MODEL.DEVICE = "cuda"
    cfg.TPU.DAN_FC1_QUANT = "none"
    cfg.TPU.RPN_CONV_QUANT = "none"
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    return cfg


def _refuse(key: str, value, why: str):
    raise NotImplementedError(
        f"{key}={value!r} is not ported to wsovod_torch yet ({why})"
    )


def check_supported(cfg: CfgNode) -> None:
    """Raise ``NotImplementedError`` naming the first key that asks for a
    path this slice does not port. Keys that only act during training
    (solver, sampling, mining, ``WSOVOD.BBOX_REFINE``) are not checked: the
    reference ignores them at inference too."""
    m = cfg.MODEL
    checks = [
        ("MODEL.META_ARCHITECTURE", m.META_ARCHITECTURE,
         m.META_ARCHITECTURE == "GeneralizedRCNN_WSOVOD", "mixed datasets"),
        ("MODEL.BACKBONE.NAME", m.BACKBONE.NAME,
         m.BACKBONE.NAME == "build_wsl_resnet_backbone", "VGG/Swin/MRRP backbones"),
        ("MODEL.MRRP.MRRP_ON", m.MRRP.MRRP_ON, not m.MRRP.MRRP_ON, "MRRP"),
        ("MODEL.RESNETS.DEFORM_ON_PER_STAGE", list(m.RESNETS.DEFORM_ON_PER_STAGE),
         not any(m.RESNETS.DEFORM_ON_PER_STAGE), "deformable convs"),
        ("MODEL.RESNETS.NORM", m.RESNETS.NORM,
         m.RESNETS.NORM in ("FrozenBN", "BN", "SyncBN"), "norms other than frozen BN"),
        ("MODEL.PROPOSAL_GENERATOR.NAME", m.PROPOSAL_GENERATOR.NAME,
         m.PROPOSAL_GENERATOR.NAME == "WSOVODRPN_V2", "other proposal generators"),
        ("MODEL.RPN.HEAD_NAME", m.RPN.HEAD_NAME,
         m.RPN.HEAD_NAME == "StandardRPNHead", "other RPN heads"),
        ("MODEL.RPN.IN_FEATURES", list(m.RPN.IN_FEATURES),
         len(m.RPN.IN_FEATURES) == 1, "multi-level RPN"),
        ("MODEL.ROI_HEADS.NAME", m.ROI_HEADS.NAME,
         m.ROI_HEADS.NAME == "WSOVODROIHeads", "other ROI heads"),
        ("MODEL.ROI_HEADS.IN_FEATURES", list(m.ROI_HEADS.IN_FEATURES),
         len(m.ROI_HEADS.IN_FEATURES) == 1, "multi-level pooling"),
        ("MODEL.ROI_BOX_HEAD.NAME", m.ROI_BOX_HEAD.NAME,
         m.ROI_BOX_HEAD.NAME == "DiscriminativeAdaptationNeck", "other box heads"),
        ("MODEL.ROI_BOX_HEAD.POOLER_TYPE", m.ROI_BOX_HEAD.POOLER_TYPE,
         m.ROI_BOX_HEAD.POOLER_TYPE == "ROIPool", "ROIAlignV2/ROILoopPool poolers"),
        ("MODEL.ROI_BOX_HEAD.NUM_CONV", m.ROI_BOX_HEAD.NUM_CONV,
         m.ROI_BOX_HEAD.NUM_CONV == 0, "DAN convs"),
        ("MODEL.ROI_BOX_HEAD.DAN_DIM", list(m.ROI_BOX_HEAD.DAN_DIM),
         len(m.ROI_BOX_HEAD.DAN_DIM) == 2, "DANs other than fc1 + fc2"),
        ("MODEL.ROI_BOX_HEAD.OPEN_VOCABULARY.WEIGHT_PATH_TRAIN",
         m.ROI_BOX_HEAD.OPEN_VOCABULARY.WEIGHT_PATH_TRAIN,
         m.ROI_BOX_HEAD.OPEN_VOCABULARY.WEIGHT_PATH_TRAIN != "rand",
         "learned random class weights"),
        ("MODEL.ROI_BOX_HEAD.OPEN_VOCABULARY.USE_BIAS",
         m.ROI_BOX_HEAD.OPEN_VOCABULARY.USE_BIAS,
         abs(m.ROI_BOX_HEAD.OPEN_VOCABULARY.USE_BIAS) <= 1e-9, "classifier bias"),
        ("TPU.DAN_FC1_QUANT", cfg.TPU.DAN_FC1_QUANT,
         cfg.TPU.DAN_FC1_QUANT == "none", "int8 fc1"),
        ("TPU.RPN_CONV_QUANT", cfg.TPU.RPN_CONV_QUANT,
         cfg.TPU.RPN_CONV_QUANT == "none", "int8 RPN conv"),
        ("TPU.BACKBONE_CONV_QUANT", cfg.TPU.BACKBONE_CONV_QUANT,
         cfg.TPU.BACKBONE_CONV_QUANT == "none", "int8 backbone convs"),
        ("TPU.COMPUTE_DTYPE", cfg.TPU.COMPUTE_DTYPE,
         cfg.TPU.COMPUTE_DTYPE in ("bfloat16", "float32"), "other compute dtypes"),
        ("TEST.AUG.ENABLED", cfg.TEST.AUG.ENABLED, not cfg.TEST.AUG.ENABLED,
         "test-time augmentation"),
        ("TEST.EVAL_PROPOSALS", cfg.TEST.EVAL_PROPOSALS,
         not cfg.TEST.EVAL_PROPOSALS, "proposal-recall evaluation"),
    ]
    for key, value, ok, why in checks:
        if not ok:
            _refuse(key, value, why)
