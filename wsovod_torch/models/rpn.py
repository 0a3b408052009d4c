"""The anchor-based ``WSOVODRPN_V2`` (counterpart of
``wsovod_tpu/models/rpn.py:48-73,103-348``). In training its losses are
computed after the ROI heads, from their mined pseudo ground truth:
``forward(..., train=True)`` also returns an ``RPNAux`` with the anchors
and the head's differentiable logits and deltas, and ``losses`` matches the
anchors to the pseudo boxes (IoU bands, low-quality matches allowed),
subsamples ``BATCH_SIZE_PER_IMAGE`` anchors per image and returns the BCE
and L1 losses. Proposals are made from detached logits and deltas.

Under MRRP the backbone feature ``[n_br * B, h, w, C]`` is split back into
``n_br`` per-branch levels (in training all ``NUM_BRANCH``; at inference 1
with a test branch index ``>= 0``, the JAX package's ``mrrp_fast``), one
anchor level per branch (all at the feature's stride), one head shared by
all levels, then the group top-k of ``find_top_rpn_proposals_group``. The
train losses run over the anchors of all levels. With
``TPU.RPN_CONV_QUANT`` ``"int8"`` the head's 3x3 conv is int8 at inference
(``layers.conv3x3_shifted_int8``) and floating point in training."""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.matcher import Matcher
from ..ops.sampling import Uniforms, subsample_labels
from ..structures.boxes import apply_deltas, get_deltas, pairwise_iou
from ..structures.instances import Instances
from .anchors import AnchorGenerator
from .layers import Conv2d, QuantizableConv3x3
from .proposal_utils import find_top_rpn_proposals, find_top_rpn_proposals_group


class StandardRPNHead(nn.Module):
    """Shared 3x3 conv + ReLU, then 1x1 objectness (A) and 1x1 anchor deltas
    (A*4), d2's names (``conv``, ``objectness_logits``, ``anchor_deltas``).
    With ``conv_quant`` ``"int8"`` (``TPU.RPN_CONV_QUANT``) the 3x3 conv runs
    as 9 shifted int8 GEMMs at inference, each level quantized per image;
    training keeps the floating-point conv (``wsovod_tpu/models/rpn.py:171``)."""

    def __init__(self, in_channels: int, num_anchors: int, box_dim: int = 4,
                 conv_quant: str = "none"):
        super().__init__()
        self.num_anchors = num_anchors
        self.conv = QuantizableConv3x3(in_channels, in_channels, conv_quant)
        self.objectness_logits = Conv2d(in_channels, num_anchors, 1)
        self.anchor_deltas = Conv2d(in_channels, num_anchors * box_dim, 1)

    def forward(self, features: Sequence[torch.Tensor], train: bool = False):
        """Per-level NHWC features -> (logits ``[B, H, W, A]``, deltas
        ``[B, H, W, A*4]``), NHWC like the reference."""
        logits, deltas = [], []
        for f in features:
            if self.conv.quant == "int8" and not train:
                t = F.relu(self.conv.forward_nhwc(f, int8=True)).permute(0, 3, 1, 2)
            else:
                t = F.relu(self.conv(f.permute(0, 3, 1, 2)))
            logits.append(self.objectness_logits(t).permute(0, 2, 3, 1))
            deltas.append(self.anchor_deltas(t).permute(0, 2, 3, 1))
        return logits, deltas


def _nest(v):
    """d2 ``_broadcast_params``: a flat list means one shared entry."""
    if len(v) and not isinstance(v[0], (list, tuple)):
        return (tuple(v),)
    return tuple(tuple(x) for x in v)


class RPNAux(NamedTuple):
    """What the deferred losses need from the forward."""

    anchors: torch.Tensor  # [R, 4] all levels
    logits: torch.Tensor  # [B, R] objectness logits (differentiable)
    deltas: torch.Tensor  # [B, R, 4] anchor deltas (differentiable)


class WSOVODRPN_V2(nn.Module):
    def __init__(self, in_channels: int, in_features=("res5",), strides=(8,),
                 anchor_sizes=((32, 64, 128, 256, 512),), anchor_aspect_ratios=((0.5, 1.0, 2.0),),
                 anchor_offset=0.0, nms_thresh=0.7, min_box_size=0.0, pre_nms_topk_test=2048,
                 post_nms_topk_test=1024, bbox_reg_weights=(1.0, 1.0, 1.0, 1.0),
                 mrrp_on: bool = False, mrrp_num_branch: int = 3, mrrp_test_all: bool = True,
                 pre_nms_topk_train=2048, post_nms_topk_train=1024, batch_size_per_image=256,
                 positive_fraction=0.5, iou_thresholds=(0.3, 0.7), iou_labels=(0, -1, 1),
                 smooth_l1_beta=0.0, loss_weight_cls=1.0, loss_weight_loc=1.0,
                 conv_quant: str = "none"):
        super().__init__()
        self.mrrp_on = mrrp_on
        self.mrrp_num_branch = mrrp_num_branch
        self.mrrp_test_all = mrrp_test_all
        self.in_features = tuple(in_features)
        self.nms_thresh = nms_thresh
        self.min_box_size = min_box_size
        self.pre_nms_topk = pre_nms_topk_test
        self.post_nms_topk = post_nms_topk_test
        self.pre_nms_topk_train = pre_nms_topk_train
        self.post_nms_topk_train = post_nms_topk_train
        self.batch_size_per_image = batch_size_per_image
        self.positive_fraction = positive_fraction
        self.matcher = Matcher(iou_thresholds, iou_labels, allow_low_quality_matches=True)
        self.smooth_l1_beta = smooth_l1_beta
        self.loss_weight_cls = loss_weight_cls
        self.loss_weight_loc = loss_weight_loc
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
        self.rpn_head = StandardRPNHead(in_channels, self.anchor_generator.num_anchors[0],
                                        conv_quant=conv_quant)

    def forward(self, features: Dict[str, torch.Tensor], image_sizes: torch.Tensor,
                train: bool = False) -> Union[Instances, Tuple[Instances, RPNAux]]:
        """Proposals (``Instances``); with ``train``, the train top-k and
        ``(proposals, RPNAux)``."""
        feats = [features[f] for f in self.in_features]
        if self.mrrp_on:
            n_br = self.mrrp_num_branch if (train or self.mrrp_test_all) else 1
            feats = [c for f in feats for c in torch.chunk(f, n_br, dim=0)]
        logits_l, deltas_l = self.rpn_head(feats, train=train)
        grid_sizes = [(f.shape[1], f.shape[2]) for f in feats]
        anchors_l = self.anchor_generator.grid_anchors(grid_sizes, feats[0].device)
        flat_logits, flat_deltas, proposals_l = [], [], []
        for lg, dl, anchors in zip(logits_l, deltas_l, anchors_l):
            b = lg.shape[0]
            flat_logits.append(lg.reshape(b, -1))  # position-major, anchor-minor
            flat_deltas.append(dl.reshape(b, -1, 4))
            proposals_l.append(apply_deltas(flat_deltas[-1].detach().float(), anchors[None],
                                            weights=self.bbox_reg_weights))
        pre = self.pre_nms_topk_train if train else self.pre_nms_topk
        post = self.post_nms_topk_train if train else self.post_nms_topk
        scores = [lg.detach() for lg in flat_logits]
        if self.mrrp_on:
            proposals = find_top_rpn_proposals_group(
                proposals_l, scores, image_sizes, self.rpn_head.num_anchors,
                self.nms_thresh, pre, post, self.min_box_size,
            )
        else:
            proposals = find_top_rpn_proposals(
                proposals_l, scores, image_sizes, self.nms_thresh, pre, post, self.min_box_size,
            )
        if not train:
            return proposals
        return proposals, RPNAux(torch.cat(anchors_l, dim=0), torch.cat(flat_logits, dim=1),
                                 torch.cat(flat_deltas, dim=1))

    def losses(self, aux: RPNAux, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
               uniforms: Uniforms) -> Dict[str, torch.Tensor]:
        """The deferred RPN losses against the pseudo GT ``gt_boxes [B, G,
        4]`` (``gt_valid [B, G]``); ``uniforms`` draws the anchor sampling's
        random order (positives, then negatives, ``[B, R]`` each). An image
        without valid pseudo GT labels every anchor background. Both losses
        are normalised by ``BATCH_SIZE_PER_IMAGE * B``."""
        b, r = aux.logits.shape
        idx, labels = self.matcher(pairwise_iou(gt_boxes, aux.anchors), gt_valid=gt_valid.bool())
        labels = torch.where(gt_valid.bool().any(dim=-1, keepdim=True), labels,
                             torch.zeros_like(labels))
        dev = aux.logits.device
        pos, neg = subsample_labels(labels, self.batch_size_per_image, self.positive_fraction,
                                    uniforms((b, r), dev), uniforms((b, r), dev))
        matched = torch.gather(gt_boxes, 1, idx[..., None].expand(b, r, 4))
        gt_deltas = get_deltas(aux.anchors[None], matched, weights=self.bbox_reg_weights)
        finite = torch.isfinite(gt_deltas).all(dim=-1) & pos
        gt_deltas = torch.nan_to_num(gt_deltas, nan=0.0, posinf=0.0, neginf=0.0)
        diff = (aux.deltas.float() - gt_deltas).abs()
        beta = self.smooth_l1_beta
        l1 = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta) if beta > 1e-12 else diff
        loc_loss = (l1 * finite[..., None].float()).sum()
        logits = aux.logits.float()
        bce = F.binary_cross_entropy_with_logits(logits, pos.float(), reduction="none")
        cls_loss = (bce * (pos | neg).float()).sum()
        normalizer = self.batch_size_per_image * b
        return {"loss_rpn_cls": cls_loss / normalizer * self.loss_weight_cls,
                "loss_rpn_loc": loc_loss / normalizer * self.loss_weight_loc}


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
        pre_nms_topk_train=rpn.PRE_NMS_TOPK_TRAIN,
        post_nms_topk_train=rpn.POST_NMS_TOPK_TRAIN,
        batch_size_per_image=rpn.BATCH_SIZE_PER_IMAGE,
        positive_fraction=rpn.POSITIVE_FRACTION,
        iou_thresholds=tuple(rpn.IOU_THRESHOLDS),
        iou_labels=tuple(rpn.IOU_LABELS),
        smooth_l1_beta=rpn.SMOOTH_L1_BETA,
        loss_weight_cls=rpn.LOSS_WEIGHT,
        loss_weight_loc=rpn.BBOX_REG_LOSS_WEIGHT * rpn.LOSS_WEIGHT,
        conv_quant=cfg.TPU.RPN_CONV_QUANT,
    )
