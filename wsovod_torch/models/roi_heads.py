"""``WSOVODROIHeads`` at inference (counterpart of
``wsovod_tpu/models/roi_heads.py:189-315,508-591``): gated pooled chunks
stream into the DAN, the data-aware vector is added to every ROI feature,
the K refinement heads score against the class embeddings, and
``fast_rcnn_inference`` makes the detections. Mining, labelling and losses
belong to the training slice.

With the ``ROILoopPool`` pooler only the ROI row is pooled and run through
the DAN. At inference the JAX package pools all three rows (ROI, frame,
context), runs fc1 and fc2 on each, adds the data-aware vector to each, and
then keeps only the ROI row (``roi_feats, _ = ...`` at
``roi_heads.py:518-520``): the frame and context rows feed only the
training-time object miner. The DAN works row by row, so the ROI row's
result is the same."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..structures.instances import Instances
from .box_head import DiscriminativeAdaptationNeck
from .fast_rcnn_inference import Detections, fast_rcnn_inference_batched
from .mil_heads import InstanceRefinementOutputLayers, predict_boxes_K, predict_probs_K
from .poolers import ROIPooler, chunk_width


class WSOVODROIHeads(nn.Module):
    def __init__(self, pooler: ROIPooler, in_channels: int, in_features=("res5",),
                 dan_fc_dims=(4096, 4096), refine_k: int = 1, refine_reg: Sequence[bool] = (True,),
                 bbox_reg_weights=(10.0, 10.0, 5.0, 5.0), ov_weight_dim: int = 512,
                 ov_norm_weight: bool = True, ov_norm_temp: float = 50.0,
                 test_score_thresh: float = 1e-5, test_nms_thresh: float = 0.3,
                 test_topk_per_image: int = 100, test_per_class_topk: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_features = tuple(in_features)
        self.bbox_reg_weights = tuple(bbox_reg_weights)
        self.test_score_thresh = test_score_thresh
        self.test_nms_thresh = test_nms_thresh
        self.test_topk_per_image = test_topk_per_image
        self.test_per_class_topk = test_per_class_topk
        self.c_take = chunk_width(in_channels)
        self.pooler = pooler
        self.box_head = DiscriminativeAdaptationNeck(
            in_channels, pooler.output_size, tuple(dan_fc_dims), self.c_take, dtype
        )
        self.box_refinery = nn.ModuleList(
            InstanceRefinementOutputLayers(
                self.box_head.output_dim,
                refine_reg=bool(refine_reg[k]) if k < len(refine_reg) else False,
                weight_dim=ov_weight_dim, norm_weight=ov_norm_weight,
                norm_temperature=ov_norm_temp, dtype=dtype,
            )
            for k in range(refine_k)
        )

    def _pooled_box_features(self, features: Dict[str, torch.Tensor], proposals: Instances,
                             data_aware_features: Optional[torch.Tensor]) -> torch.Tensor:
        feat = features[self.in_features[0]]
        chunks = self.pooler.chunks(feat, proposals.proposal_boxes, proposals.objectness_logits,
                                    proposals.valid, self.c_take,
                                    level_ids=proposals.fields().get("level_ids"))
        box_features = self.box_head(chunks)  # [B, P, F]
        if data_aware_features is not None:
            box_features = box_features + data_aware_features[:, None, :].to(box_features.dtype)
        return box_features

    def inference(self, features: Dict[str, torch.Tensor], proposals: Instances,
                  image_sizes: torch.Tensor, data_aware_features: Optional[torch.Tensor] = None,
                  classifier: Optional[torch.Tensor] = None,
                  embeddings: Optional[torch.Tensor] = None,
                  append_background: bool = True) -> Tuple[Detections, torch.Tensor, torch.Tensor]:
        roi_feats = self._pooled_box_features(features, proposals, data_aware_features)
        scores_K, deltas_K = [], []
        for head in self.box_refinery:
            s, d = head(roi_feats, classifier=classifier, append_background=append_background,
                        embeddings=embeddings)
            scores_K.append(s)
            deltas_K.append(d)
        probs = predict_probs_K(scores_K)
        boxes = predict_boxes_K(deltas_K, proposals.proposal_boxes, self.bbox_reg_weights)
        detections = fast_rcnn_inference_batched(
            boxes, probs, proposals.valid, image_sizes,
            score_thresh=self.test_score_thresh, nms_thresh=self.test_nms_thresh,
            topk_per_image=self.test_topk_per_image, per_class_topk=self.test_per_class_topk,
        )
        return detections, probs, boxes

    forward = inference


def build_roi_heads(cfg, pooler: ROIPooler, in_channels: int, dtype: torch.dtype) -> WSOVODROIHeads:
    rb = cfg.MODEL.ROI_BOX_HEAD
    ir = cfg.WSOVOD.INSTANCE_REFINEMENT
    return WSOVODROIHeads(
        pooler,
        in_channels,
        in_features=tuple(cfg.MODEL.ROI_HEADS.IN_FEATURES),
        dan_fc_dims=tuple(rb.DAN_DIM),
        refine_k=ir.REFINE_NUM,
        refine_reg=tuple(ir.REFINE_REG),
        bbox_reg_weights=tuple(rb.BBOX_REG_WEIGHTS),
        ov_weight_dim=rb.OPEN_VOCABULARY.WEIGHT_DIM,
        ov_norm_weight=rb.OPEN_VOCABULARY.NORM_WEIGHT,
        ov_norm_temp=rb.OPEN_VOCABULARY.NORM_TEMP,
        test_score_thresh=cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
        test_nms_thresh=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
        test_topk_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
        dtype=dtype,
    )
