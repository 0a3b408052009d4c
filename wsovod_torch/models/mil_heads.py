"""Multiple-instance-learning output layers (counterpart of
``wsovod_tpu/models/mil_heads.py``), batched ``[B, P, ...]`` with a proposal
validity mask:

* the object miner (WSDDN): ``softmax over classes x softmax over the
  image's valid proposals``; its image-level score, the per-image sum
  clamped to ``[1e-6, 1 - 1e-6]``, is trained with BCE against the
  image-level one-hot labels;
* refinement head k: OV class scores (C+1 with background) and optional
  class-agnostic box deltas; weighted cross-entropy with ignore labels and
  a weighted L1 box loss on foreground rows;
* K-head inference: mean softmax and mean deltas.

The miner's ContextLocNet variant (ROILoopPool's frame and context rows)
belongs to the MRRP training slice."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..structures.boxes import apply_deltas, get_deltas
from .class_heads import OpenVocabularyClassifier
from .layers import Linear

NEG_INF = -1e30


def masked_softmax(x: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Softmax over ``dim`` with ``mask == False`` entries taken as -inf
    (exactly 0 out; an all-masked slice gives 0)."""
    x = torch.where(mask, x, torch.full((), NEG_INF, dtype=x.dtype, device=x.device))
    x = x - x.amax(dim=dim, keepdim=True)
    e = torch.exp(x) * mask.to(x.dtype)
    return e / e.sum(dim=dim, keepdim=True).clamp(min=1e-12)


class ObjectMiningOutputLayers(nn.Module):
    """The WSDDN object-mining head: ``cls`` and ``det`` linears from the
    box feature to the classes, run in the feature's dtype."""

    def __init__(self, in_features: int, num_classes: int, mean_loss: bool = True,
                 loss_weight: float = 1.0):
        super().__init__()
        self.num_classes = num_classes
        self.mean_loss = mean_loss
        self.loss_weight = loss_weight
        self.cls = Linear(in_features, num_classes)
        self.det = Linear(in_features, num_classes)

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """``x [B, P, F]``, ``valid [B, P]`` -> MIL scores ``[B, P, C]``
        float32, exactly 0 on padded rows."""
        c_logits, d_logits = self.cls(x).float(), self.det(x).float()
        if self.num_classes == 1:  # the reference appends a zero column first
            c_logits = F.pad(c_logits, (0, 1))
            d_logits = F.pad(d_logits, (0, 1))
        scores = F.softmax(c_logits, dim=-1) * masked_softmax(d_logits, valid[..., None].bool(), 1)
        if self.num_classes == 1:
            scores = scores[..., :1]
        return scores * valid[..., None].to(scores.dtype)

    @staticmethod
    def predict_probs_img(scores: torch.Tensor) -> torch.Tensor:
        """Image-level class scores ``[B, C]``."""
        return scores.sum(dim=1).clamp(1e-6, 1.0 - 1e-6)

    def losses(self, scores: torch.Tensor, gt_classes_img_oh: torch.Tensor) -> Dict[str, torch.Tensor]:
        """BCE of the image-level scores against the one-hot labels: the mean
        over ``B * C`` (``mean_loss``), else the sum over ``B``."""
        p = self.predict_probs_img(scores).float()
        t = gt_classes_img_oh.float()
        bce = -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))
        loss = bce.mean() if self.mean_loss else bce.sum() / p.shape[0]
        return {"loss_cls_object_mining": loss * self.loss_weight}


class InstanceRefinementOutputLayers(nn.Module):
    """Refinement head k: OV class scores ``[B, P, C(+1)]`` and, with
    ``refine_reg``, class-agnostic box deltas ``[B, P, 4]`` (float32, the
    reference's dtype promotion of its default-dtype ``Dense``)."""

    def __init__(self, in_features: int, refine_reg: bool = False, weight_dim: int = 512,
                 norm_weight: bool = True, norm_temperature: float = 50.0,
                 dtype: torch.dtype = torch.float32, refine_k: int = 0,
                 cross_entropy_weighted: bool = True, loss_weight: float = 1.0,
                 box_reg_loss_weight: float = 1.0, box_reg_loss_type: str = "smooth_l1_weighted",
                 smooth_l1_beta: float = 0.0, bbox_reg_weights=(10.0, 10.0, 5.0, 5.0)):
        super().__init__()
        if box_reg_loss_type not in ("smooth_l1", "smooth_l1_weighted"):
            raise NotImplementedError(f"box regression loss {box_reg_loss_type}")
        self.refine_k = refine_k
        self.cross_entropy_weighted = cross_entropy_weighted
        self.loss_weight = loss_weight
        self.box_reg_loss_weight = box_reg_loss_weight
        self.box_reg_loss_type = box_reg_loss_type
        self.smooth_l1_beta = smooth_l1_beta
        self.bbox_reg_weights = tuple(bbox_reg_weights)
        self.cls = OpenVocabularyClassifier(in_features, weight_dim, norm_weight,
                                            norm_temperature, dtype)
        self.bbox_pred = nn.Linear(in_features, 4) if refine_reg else None

    def forward(self, x: torch.Tensor, classifier: Optional[torch.Tensor] = None,
                append_background: bool = True,
                embeddings: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        scores = self.cls(x, classifier=classifier, append_background=append_background,
                          embeddings=embeddings)
        if self.bbox_pred is not None:
            deltas = self.bbox_pred(x.float())
        else:
            deltas = torch.zeros(x.shape[:-1] + (4,), dtype=scores.dtype, device=x.device)
        return scores, deltas

    def losses(self, scores: torch.Tensor, deltas: torch.Tensor, proposal_boxes: torch.Tensor,
               gt_classes: torch.Tensor, gt_boxes: torch.Tensor, gt_weights: torch.Tensor,
               valid: torch.Tensor, num_classes: int) -> Dict[str, torch.Tensor]:
        """Weighted cross-entropy over the rows not ignored (``gt_classes <
        0`` or invalid), normalised by the count of rows of nonzero weight;
        with ``bbox_pred``, the L1 (or smooth L1) box loss on foreground
        rows, weighted by ``gt_weights`` for ``smooth_l1_weighted`` and
        normalised by the count of valid rows."""
        k = self.refine_k
        scores = scores.float()
        ignore = (gt_classes < 0) | ~valid.bool()
        weights = torch.where(ignore, torch.zeros((), device=scores.device), gt_weights.float())
        valid_w = (weights > 1e-12).float()
        tgt = gt_classes.clamp(0, scores.shape[-1] - 1)
        ce = -torch.gather(F.log_softmax(scores, dim=-1), -1, tgt[..., None])[..., 0]
        ce = torch.where(ignore, torch.zeros((), device=ce.device), ce)
        if self.cross_entropy_weighted:
            loss_cls = (ce * weights).sum() / valid_w.sum().clamp(min=1.0)
        else:
            keep = (~ignore).float()
            loss_cls = (ce * keep).sum() / keep.sum().clamp(min=1.0)
        out = {f"loss_cls_r{k}": loss_cls * self.loss_weight}
        if self.bbox_pred is None:
            return out

        fg = (~ignore) & (gt_classes >= 0) & (gt_classes < num_classes) & valid.bool()
        gt_deltas = torch.nan_to_num(get_deltas(proposal_boxes, gt_boxes, self.bbox_reg_weights),
                                     nan=0.0, posinf=0.0, neginf=0.0)
        diff = (deltas.float() - gt_deltas).abs()
        beta = self.smooth_l1_beta
        l1 = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta) if beta > 1e-12 else diff
        if self.box_reg_loss_type == "smooth_l1_weighted":
            l1 = l1 * weights[..., None]
        loss_reg = (l1 * fg[..., None].float()).sum()
        total = valid.float().sum().clamp(min=1.0)
        out[f"loss_box_reg_r{k}"] = loss_reg / total * self.box_reg_loss_weight
        return out


def predict_probs_K(scores_list: Sequence[torch.Tensor]) -> torch.Tensor:
    """Mean softmax over the K refinement heads, ``[B, P, C+1]``."""
    probs = None
    for s in scores_list:
        p = F.softmax(s.float(), dim=-1)
        probs = p if probs is None else probs + p
    return probs / len(scores_list)


def predict_boxes_K(deltas_list, proposal_boxes, bbox_reg_weights) -> torch.Tensor:
    """Mean deltas over the K heads applied to the proposals, ``[B, P, 4]``."""
    d = None
    for dk in deltas_list:
        d = dk.float() if d is None else d + dk.float()
    return apply_deltas(d / len(deltas_list), proposal_boxes, weights=bbox_reg_weights)
