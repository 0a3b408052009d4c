"""The anchor-based ``WSOVODRPN_V2`` at inference (counterpart of
``wsovod_tpu/models/rpn.py:48-73,111-221``). Its losses, computed after the
ROI heads from mined pseudo ground truth, belong to the training slice."""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..structures.boxes import apply_deltas
from ..structures.instances import Instances
from .anchors import AnchorGenerator
from .layers import Conv2d, QuantizableConv3x3
from .proposal_utils import find_top_rpn_proposals


class StandardRPNHead(nn.Module):
    """Shared 3x3 conv + ReLU, then 1x1 objectness (A) and 1x1 anchor deltas
    (A*4), d2's names (``conv``, ``objectness_logits``, ``anchor_deltas``)."""

    def __init__(self, in_channels: int, num_anchors: int, box_dim: int = 4):
        super().__init__()
        self.conv = QuantizableConv3x3(in_channels, in_channels)
        self.objectness_logits = Conv2d(in_channels, num_anchors, 1)
        self.anchor_deltas = Conv2d(in_channels, num_anchors * box_dim, 1)

    def forward(self, features: Sequence[torch.Tensor]):
        """Per-level NHWC features -> (logits ``[B, H, W, A]``, deltas
        ``[B, H, W, A*4]``), NHWC like the reference."""
        logits, deltas = [], []
        for f in features:
            t = F.relu(self.conv(f.permute(0, 3, 1, 2)))
            logits.append(self.objectness_logits(t).permute(0, 2, 3, 1))
            deltas.append(self.anchor_deltas(t).permute(0, 2, 3, 1))
        return logits, deltas


def _nest(v):
    """d2 ``_broadcast_params``: a flat list means one shared entry."""
    if len(v) and not isinstance(v[0], (list, tuple)):
        return (tuple(v),)
    return tuple(tuple(x) for x in v)


class WSOVODRPN_V2(nn.Module):
    def __init__(self, in_channels: int, in_features=("res5",), strides=(8,),
                 anchor_sizes=((32, 64, 128, 256, 512),), anchor_aspect_ratios=((0.5, 1.0, 2.0),),
                 anchor_offset=0.0, nms_thresh=0.7, min_box_size=0.0, pre_nms_topk_test=2048,
                 post_nms_topk_test=1024, bbox_reg_weights=(1.0, 1.0, 1.0, 1.0)):
        super().__init__()
        self.in_features = tuple(in_features)
        self.nms_thresh = nms_thresh
        self.min_box_size = min_box_size
        self.pre_nms_topk = pre_nms_topk_test
        self.post_nms_topk = post_nms_topk_test
        self.bbox_reg_weights = tuple(bbox_reg_weights)
        n_lvl = len(self.in_features)
        strides = list(strides)
        self.anchor_generator = AnchorGenerator(
            sizes=list(anchor_sizes), aspect_ratios=list(anchor_aspect_ratios),
            strides=strides[:n_lvl] if len(strides) >= n_lvl else strides * n_lvl,
            offset=anchor_offset,
        )
        self.rpn_head = StandardRPNHead(in_channels, self.anchor_generator.num_anchors[0])

    def forward(self, features: Dict[str, torch.Tensor], image_sizes: torch.Tensor) -> Instances:
        feats = [features[f] for f in self.in_features]
        logits_l, deltas_l = self.rpn_head(feats)
        grid_sizes = [(f.shape[1], f.shape[2]) for f in feats]
        anchors_l = self.anchor_generator.grid_anchors(grid_sizes, feats[0].device)
        flat_logits, proposals_l = [], []
        for lg, dl, anchors in zip(logits_l, deltas_l, anchors_l):
            b = lg.shape[0]
            flat_logits.append(lg.reshape(b, -1))  # position-major, anchor-minor
            dl = dl.reshape(b, -1, 4).float()
            proposals_l.append(apply_deltas(dl, anchors[None], weights=self.bbox_reg_weights))
        return find_top_rpn_proposals(
            proposals_l, flat_logits, image_sizes, self.nms_thresh,
            self.pre_nms_topk, self.post_nms_topk, self.min_box_size,
        )


def build_proposal_generator(cfg, in_channels: int, strides: Sequence[int]) -> WSOVODRPN_V2:
    rpn = cfg.MODEL.RPN
    return WSOVODRPN_V2(
        in_channels=in_channels,
        in_features=tuple(rpn.IN_FEATURES),
        strides=tuple(strides),
        anchor_sizes=_nest(cfg.MODEL.ANCHOR_GENERATOR.SIZES),
        anchor_aspect_ratios=_nest(cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS),
        anchor_offset=cfg.MODEL.ANCHOR_GENERATOR.OFFSET,
        nms_thresh=rpn.NMS_THRESH,
        min_box_size=cfg.MODEL.PROPOSAL_GENERATOR.MIN_SIZE,
        pre_nms_topk_test=rpn.PRE_NMS_TOPK_TEST,
        post_nms_topk_test=rpn.POST_NMS_TOPK_TEST,
        bbox_reg_weights=tuple(rpn.BBOX_REG_WEIGHTS),
    )
