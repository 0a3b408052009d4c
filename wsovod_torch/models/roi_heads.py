"""``WSOVODROIHeads`` (counterpart of
``wsovod_tpu/models/roi_heads.py:189-591``). Inference: gated pooled chunks
stream into the DAN, the data-aware vector is added to every ROI feature,
the K refinement heads score against the class embeddings, and
``fast_rcnn_inference`` makes the detections.

Training (``forward_train``): the chunks are pooled ungated (gate = the
validity mask) and the ``(objectness + 1) * valid`` gate scales fc1's
output; the object miner's BCE against the image-level labels; for each of
the K refineries, pseudo GT mined (top-1 per present class) from the
previous stage's detached scores and boxes, the proposals relabelled and
subsampled against it, and the refinery's losses; after a box-regressing
refinery the mining boxes become its regressed boxes. The last stage's
top-1 mining becomes the RPN's pseudo GT. The SAM box refiner is not ported
(``engine/trainer.py`` turns ``WSOVOD.BBOX_REFINE`` off), so it is the
identity here, as in the JAX package without a SAM embedding.

With the ``ROILoopPool`` pooler, training pools all three rows (ROI, frame,
context), runs the DAN on them as one ``[3, B, N]`` batch of rows, and adds
the data-aware vector to each: the object miner (ContextLocNet's) reads the
stack, the refineries the ROI row (``wsovod_tpu/models/roi_heads.py:305-310,
342``). Inference pools and runs only the ROI row: the JAX package pools all
three there too, then keeps only the ROI row (``roi_feats, _ = ...`` at
``roi_heads.py:518-520``); the DAN works row by row, so the ROI row's result
is the same.

With several ``ROI_HEADS.IN_FEATURES`` (an FPN's levels, inference only)
the pooler routes each ROI to its level (``poolers.py``) and the chunks
stream into fc1 as on one level: the JAX package pools unfused there, in
ROI chunks of ``TPU.UNFUSED_ROI_CHUNK``, and multiplies the pooled tensor
by the gate cast to its dtype (``wsovod_tpu/models/roi_heads.py:257-300``);
the level-routed kernels round the gate to the features' dtype and multiply
once, which is the same, and fc1 works row by row, so the ROI chunking
changes no number.

With ``TPU.DAN_FC1_QUANT`` ``"int8"`` fc1 is int8 at inference only (the
JAX package's ``quant=self.fc1_quant if not train``); the ROIPool and the
ROILoopPool then hand it ``(payload, maxabs)`` chunks (``poolers.py``). On
several pooled levels fc1 stays in floating point with that key, as the
JAX package's unfused path runs it (``build_roi_heads``)."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.matcher import Matcher
from ..ops.sampling import Uniforms
from ..structures.boxes import apply_deltas
from ..structures.instances import Instances
from .box_head import DiscriminativeAdaptationNeck
from .fast_rcnn_inference import Detections, fast_rcnn_inference_batched
from .mil_heads import (InstanceRefinementOutputLayers, ObjectMiningOutputLayers, predict_boxes_K,
                        predict_probs_K)
from .mining import (PseudoGT, get_image_level_gt, label_and_sample_plain, label_and_sample_wsl,
                     pgt_top_k)
from .poolers import ROIPooler, chunk_width


class ROIHeadsOutput(NamedTuple):
    losses: Dict[str, torch.Tensor]
    proposal_targets: PseudoGT  # the RPN's pseudo GT


class WSOVODROIHeads(nn.Module):
    def __init__(self, pooler: ROIPooler, in_channels: int, in_features=("res5",),
                 dan_fc_dims=(4096, 4096), refine_k: int = 1, refine_reg: Sequence[bool] = (True,),
                 bbox_reg_weights=(10.0, 10.0, 5.0, 5.0), ov_weight_dim: int = 512,
                 ov_norm_weight: bool = True, ov_norm_temp: float = 50.0,
                 test_score_thresh: float = 1e-5, test_nms_thresh: float = 0.3,
                 test_topk_per_image: int = 100, test_per_class_topk: int = 128,
                 dtype: torch.dtype = torch.float32, num_classes: int = 80,
                 cross_entropy_weighted: bool = True, sampling_on: bool = True,
                 sampling_iou_thresholds=((0.5,),), sampling_iou_labels=((0, 1),),
                 sampling_batch_size=(4096,), sampling_pos_fraction=(1.0,),
                 roi_matcher_iou_thresholds=(0.5,), roi_matcher_iou_labels=(0, 1),
                 object_mining_weight: float = 1.0, object_mining_mean_loss: bool = True,
                 instance_refinement_weight: float = 1.0, box_reg_loss_weight: float = 1.0,
                 box_reg_loss_type: str = "smooth_l1_weighted", smooth_l1_beta: float = 0.0,
                 dan_fc1_quant: str = "none"):
        super().__init__()
        self.in_features = tuple(in_features)
        self.bbox_reg_weights = tuple(bbox_reg_weights)
        self.num_classes = num_classes
        self.refine_reg = tuple(bool(refine_reg[k]) if k < len(refine_reg) else False
                                for k in range(refine_k))
        self.sampling_on = sampling_on
        self.sampling_matchers = [Matcher(t, l) for t, l in
                                  zip(sampling_iou_thresholds, sampling_iou_labels)]
        self.sampling_batch_size = tuple(sampling_batch_size)
        self.sampling_pos_fraction = tuple(sampling_pos_fraction)
        self.roi_matcher = Matcher(roi_matcher_iou_thresholds, roi_matcher_iou_labels)
        self.test_score_thresh = test_score_thresh
        self.test_nms_thresh = test_nms_thresh
        self.test_topk_per_image = test_topk_per_image
        self.test_per_class_topk = test_per_class_topk
        self.c_take = chunk_width(in_channels, pooler.pooler_type, dan_fc1_quant)
        self.pooler = pooler
        self.box_head = DiscriminativeAdaptationNeck(
            in_channels, pooler.output_size, tuple(dan_fc_dims), self.c_take, dtype,
            fc1_quant=dan_fc1_quant,
        )
        self.object_miner = ObjectMiningOutputLayers(
            self.box_head.output_dim, num_classes, mean_loss=object_mining_mean_loss,
            loss_weight=object_mining_weight, context=pooler.pooler_type == "ROILoopPool",
        )
        self.box_refinery = nn.ModuleList(
            InstanceRefinementOutputLayers(
                self.box_head.output_dim,
                refine_reg=self.refine_reg[k],
                weight_dim=ov_weight_dim, norm_weight=ov_norm_weight,
                norm_temperature=ov_norm_temp, dtype=dtype, refine_k=k,
                cross_entropy_weighted=cross_entropy_weighted,
                loss_weight=instance_refinement_weight, box_reg_loss_weight=box_reg_loss_weight,
                box_reg_loss_type=box_reg_loss_type, smooth_l1_beta=smooth_l1_beta,
                bbox_reg_weights=bbox_reg_weights,
            )
            for k in range(refine_k)
        )

    def _pooled_box_features(self, features: Dict[str, torch.Tensor], proposals: Instances,
                             data_aware_features: Optional[torch.Tensor], train: bool = False,
                             generator: Optional[torch.Generator] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(roi [B, P, F], the object miner's input)``: the data-aware
        vector added, the miner's input the ROI row again or, for a
        ROILoopPool in training, the ROI, frame and context rows stacked
        ``[3, B, P, F]``."""
        feat = tuple(features[f] for f in self.in_features)  # one map, or an FPN's levels
        valid = proposals.valid
        gate = (proposals.objectness_logits.float() + 1.0) * valid.float()
        pool_gate, row_gate = (valid.float(), gate) if train else (gate, None)
        rows = 3 if train and self.object_miner.context else 1
        int8 = not train and self.box_head.fc1.quant == "int8"  # fc1 trains in floating point
        chunks = self.pooler.chunks(feat, proposals.proposal_boxes, pool_gate, valid, self.c_take,
                                    level_ids=proposals.fields().get("level_ids"), rows=rows,
                                    maxabs=self.pooler.emits_maxabs(int8))
        # [(3,) B, P, F]
        box_features = self.box_head(chunks, row_gate=row_gate, generator=generator, int8=int8)
        if data_aware_features is not None:
            box_features = box_features + data_aware_features[:, None, :].to(box_features.dtype)
        return (box_features[0] if rows == 3 else box_features), box_features

    def inference(self, features: Dict[str, torch.Tensor], proposals: Instances,
                  image_sizes: torch.Tensor, data_aware_features: Optional[torch.Tensor] = None,
                  classifier: Optional[torch.Tensor] = None,
                  embeddings: Optional[torch.Tensor] = None,
                  append_background: bool = True) -> Tuple[Detections, torch.Tensor, torch.Tensor]:
        roi_feats, _ = self._pooled_box_features(features, proposals, data_aware_features)
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

    def forward_train(self, features: Dict[str, torch.Tensor], proposals: Instances,
                      gt_classes: torch.Tensor, gt_valid: torch.Tensor, uniforms: Uniforms,
                      data_aware_features: Optional[torch.Tensor] = None,
                      embeddings: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> ROIHeadsOutput:
        """The train forward (``wsovod_tpu/models/roi_heads.py:318-506``):
        the losses and the RPN's pseudo GT.
        ``gt_classes``/``gt_valid [B, G]`` are the image's instance classes,
        reduced to image-level labels; ``uniforms`` draws the proposal
        subsampling, ``generator`` the dropout masks."""
        c = self.num_classes
        oh, _, present = get_image_level_gt(gt_classes, gt_valid, c)
        valid = proposals.valid
        boxes = proposals.proposal_boxes.float()
        roi_feats, miner_feats = self._pooled_box_features(
            features, proposals, data_aware_features, train=True, generator=generator)
        mil_scores = self.object_miner(miner_feats, valid)
        losses = dict(self.object_miner.losses(mil_scores, oh))
        weights = self.object_miner.predict_probs_img(mil_scores).detach()  # mining weights
        prev_scores = mil_scores.detach()  # the miner has no background column
        mining_boxes = boxes
        dev = boxes.device
        for k, head in enumerate(self.box_refinery):
            pgt = pgt_top_k(mining_boxes, prev_scores[..., :c], valid, present, weights)
            if self.sampling_on:
                stage = min(k, len(self.sampling_matchers) - 1)
                labeled = label_and_sample_wsl(
                    boxes, valid, pgt, self.sampling_matchers[stage], c,
                    self.sampling_batch_size[stage], self.sampling_pos_fraction[stage],
                    uniforms(valid.shape, dev), uniforms(valid.shape, dev))
            else:
                labeled = label_and_sample_plain(boxes, valid, pgt, self.roi_matcher, c)
            scores_k, deltas_k = head(roi_feats, append_background=True, embeddings=embeddings)
            losses.update(head.losses(scores_k, deltas_k, boxes, labeled.gt_classes,
                                      labeled.gt_boxes, labeled.gt_weights, valid, c))
            prev_scores = F.softmax(scores_k.detach().float(), dim=-1)
            mining_boxes = (apply_deltas(deltas_k.detach().float(), boxes, self.bbox_reg_weights)
                            if self.refine_reg[k] else boxes)
        targets = pgt_top_k(mining_boxes, prev_scores[..., :c], valid, present, weights, top_k=1)
        return ROIHeadsOutput(losses, targets)


def build_roi_heads(cfg, pooler: ROIPooler, in_channels: int, dtype: torch.dtype) -> WSOVODROIHeads:
    rb = cfg.MODEL.ROI_BOX_HEAD
    ws = cfg.WSOVOD
    ir = ws.INSTANCE_REFINEMENT
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
        num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES,
        cross_entropy_weighted=ir.CROSS_ENTROPY_WEIGHTED,
        sampling_on=ws.SAMPLING.SAMPLING_ON,
        sampling_iou_thresholds=tuple(tuple(t) for t in ws.SAMPLING.IOU_THRESHOLDS),
        sampling_iou_labels=tuple(tuple(t) for t in ws.SAMPLING.IOU_LABELS),
        sampling_batch_size=tuple(ws.SAMPLING.BATCH_SIZE_PER_IMAGE),
        sampling_pos_fraction=tuple(ws.SAMPLING.POSITIVE_FRACTION),
        roi_matcher_iou_thresholds=tuple(cfg.MODEL.ROI_HEADS.IOU_THRESHOLDS),
        roi_matcher_iou_labels=tuple(cfg.MODEL.ROI_HEADS.IOU_LABELS),
        object_mining_weight=ws.OBJECT_MINING.WEIGHT,
        object_mining_mean_loss=ws.OBJECT_MINING.MEAN_LOSS,
        instance_refinement_weight=ir.WEIGHT,
        box_reg_loss_weight=rb.BBOX_REG_LOSS_WEIGHT,
        box_reg_loss_type=rb.BBOX_REG_LOSS_TYPE,
        smooth_l1_beta=rb.SMOOTH_L1_BETA,
        # several pooled levels: the JAX package pools unfused and runs fc1
        # as a plain DenseGeneral, never quantized (box_head.py:248-258)
        dan_fc1_quant=(cfg.TPU.DAN_FC1_QUANT if len(cfg.MODEL.ROI_HEADS.IN_FEATURES) == 1
                       else "none"),
    )
