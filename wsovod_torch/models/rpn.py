"""The anchor-based ``WSOVODRPN_V2`` at inference (counterpart of
``wsovod_tpu/models/rpn.py:48-73,111-221,297-348``). Its losses, computed
after the ROI heads from mined pseudo ground truth, belong to the training
slice.

Under MRRP the backbone feature ``[n_br * B, h, w, C]`` is split back into
``n_br`` per-branch levels (``n_br`` is 1 with a test branch index ``>= 0``,
the JAX package's ``mrrp_fast``), one anchor level per branch (all at the
feature's stride), one head shared by all levels, then the group top-k of
``find_top_rpn_proposals_group``."""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..structures.boxes import apply_deltas
from ..structures.instances import Instances
from .anchors import AnchorGenerator
from .layers import Conv2d, QuantizableConv3x3
from .proposal_utils import find_top_rpn_proposals, find_top_rpn_proposals_group


class StandardRPNHead(nn.Module):
    """Shared 3x3 conv + ReLU, then 1x1 objectness (A) and 1x1 anchor deltas
    (A*4), d2's names (``conv``, ``objectness_logits``, ``anchor_deltas``)."""

    def __init__(self, in_channels: int, num_anchors: int, box_dim: int = 4):
        super().__init__()
        self.num_anchors = num_anchors
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
                 post_nms_topk_test=1024, bbox_reg_weights=(1.0, 1.0, 1.0, 1.0),
                 mrrp_on: bool = False, mrrp_num_branch: int = 3, mrrp_test_all: bool = True):
        super().__init__()
        self.mrrp_on = mrrp_on
        self.n_branch = mrrp_num_branch if mrrp_test_all else 1
        self.in_features = tuple(in_features)
        self.nms_thresh = nms_thresh
        self.min_box_size = min_box_size
        self.pre_nms_topk = pre_nms_topk_test
        self.post_nms_topk = post_nms_topk_test
        self.bbox_reg_weights = tuple(bbox_reg_weights)
        # one anchor level per branch under MRRP; with a single test branch
        # only the first level's sizes are used, as in the JAX package
        n_lvl = len(self.in_features) * (mrrp_num_branch if mrrp_on else 1)
        strides = list(strides) * (mrrp_num_branch if mrrp_on else 1)
        self.anchor_generator = AnchorGenerator(
            sizes=list(anchor_sizes), aspect_ratios=list(anchor_aspect_ratios),
            strides=strides[:n_lvl] if len(strides) >= n_lvl else strides * n_lvl,
            offset=anchor_offset,
        )
        self.rpn_head = StandardRPNHead(in_channels, self.anchor_generator.num_anchors[0])

    def forward(self, features: Dict[str, torch.Tensor], image_sizes: torch.Tensor) -> Instances:
        feats = [features[f] for f in self.in_features]
        if self.mrrp_on:
            feats = [c for f in feats for c in torch.chunk(f, self.n_branch, dim=0)]
        logits_l, deltas_l = self.rpn_head(feats)
        grid_sizes = [(f.shape[1], f.shape[2]) for f in feats]
        anchors_l = self.anchor_generator.grid_anchors(grid_sizes, feats[0].device)
        flat_logits, proposals_l = [], []
        for lg, dl, anchors in zip(logits_l, deltas_l, anchors_l):
            b = lg.shape[0]
            flat_logits.append(lg.reshape(b, -1))  # position-major, anchor-minor
            dl = dl.reshape(b, -1, 4).float()
            proposals_l.append(apply_deltas(dl, anchors[None], weights=self.bbox_reg_weights))
        if self.mrrp_on:
            return find_top_rpn_proposals_group(
                proposals_l, flat_logits, image_sizes, self.rpn_head.num_anchors,
                self.nms_thresh, self.pre_nms_topk, self.post_nms_topk, self.min_box_size,
            )
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
        mrrp_on=cfg.MODEL.MRRP.MRRP_ON,
        mrrp_num_branch=cfg.MODEL.MRRP.NUM_BRANCH,
        mrrp_test_all=cfg.MODEL.MRRP.TEST_BRANCH_IDX == -1,
    )
