"""Pseudo-ground-truth mining and proposal relabelling, batched over images
(counterpart of ``wsovod_tpu/models/mining.py``, whose functions are
per-image and vmapped at the call site; here every tensor carries a leading
``[B]``).

* ``get_image_level_gt``: the multi-label one-hot of the image's instance
  classes, the only supervision WSOVOD uses;
* ``pgt_top_k``: per present class, the top-k proposals (area > 20) become
  pseudo boxes weighted by the image-level class score, with the
  reference's empty-set fallback;
* ``label_and_sample_wsl`` / ``label_and_sample_plain``: IoU-match the
  proposals to the pseudo GT, copy class, box, score and weight, and (WSL)
  subsample, marking unsampled rows ignore (-1).

The MIST miner (``pgt_mist``) is not ported: no shipped config sets
``WSOVOD.INSTANCE_REFINEMENT.REFINE_MIST`` and ``config.check_supported``
refuses it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.matcher import Matcher
from ..ops.sampling import subsample_labels
from ..structures.boxes import box_area, pairwise_iou


class PseudoGT(NamedTuple):
    boxes: torch.Tensor  # [B, G, 4]
    classes: torch.Tensor  # [B, G] int64
    scores: torch.Tensor  # [B, G]
    weights: torch.Tensor  # [B, G]
    valid: torch.Tensor  # [B, G] bool


class LabeledProposals(NamedTuple):
    gt_classes: torch.Tensor  # [B, P] int64: class, C = background, -1 = ignore
    gt_boxes: torch.Tensor  # [B, P, 4] matched pseudo-GT boxes
    gt_scores: torch.Tensor  # [B, P]
    gt_weights: torch.Tensor  # [B, P]


def get_image_level_gt(gt_classes: torch.Tensor, gt_valid: torch.Tensor, num_classes: int):
    """``gt_classes [B, G]`` (padded), ``gt_valid [B, G]`` -> ``(one-hot
    [B, C] float32, per-class counts [B, C], present [B, C] bool)``."""
    cls = torch.where(gt_valid.bool(), gt_classes.long(), torch.full_like(gt_classes.long(), num_classes))
    oh = torch.nn.functional.one_hot(cls, num_classes + 1)[..., :num_classes].float()
    counts = oh.sum(dim=-2)
    present = counts > 0
    return present.float(), counts, present


def _stable_top_k(x: torch.Tensor, k: int):
    """Top-k along the last dim, descending, ties to the lower index (as
    ``jax.lax.top_k``; ``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def pgt_top_k(pred_boxes: torch.Tensor, pred_scores: torch.Tensor, proposal_valid: torch.Tensor,
              class_present: torch.Tensor, img_class_logits: torch.Tensor, top_k: int = 1,
              thres: float = 0.0, min_area: float = 20.0) -> PseudoGT:
    """Mine the top-k boxes of every present class. ``pred_boxes [B, P, 4]``,
    ``pred_scores [B, P, C]`` (background dropped), ``proposal_valid [B,
    P]``, ``class_present [B, C]``, ``img_class_logits [B, C]`` (the
    weights). Capacity ``C * top_k`` per image, class-major."""
    b, p, c = pred_scores.shape
    area_ok = box_area(pred_boxes) > min_area  # [B, P]
    row_ok = (proposal_valid.bool() & area_ok)[..., None] & class_present.bool()[:, None, :]
    neg_inf = torch.full((), float("-inf"), dtype=pred_scores.dtype, device=pred_scores.device)
    s = torch.where(row_ok, pred_scores, neg_inf).transpose(1, 2)  # [B, C, P]
    k = min(top_k, p)
    top_s, top_i = _stable_top_k(s, k)  # [B, C, k]
    top_boxes = torch.gather(pred_boxes[:, None].expand(b, c, p, 4), 2,
                             top_i[..., None].expand(b, c, k, 4))  # [B, C, k, 4]

    valid = class_present.bool()[..., None] & torch.isfinite(top_s)
    if thres > 0:
        rank0 = torch.arange(k, device=valid.device) == 0
        valid = valid & ((top_s >= thres) | rank0)

    g = c * k
    boxes = top_boxes.reshape(b, g, 4)
    scores = torch.where(valid, top_s, torch.zeros_like(top_s)).reshape(b, g)
    classes = torch.arange(c, device=valid.device)[:, None].expand(c, k).reshape(1, g).expand(b, g)
    weights = img_class_logits.float()[..., None].expand(b, c, k).reshape(b, g)
    valid = valid.reshape(b, g)

    # empty-set fallback: one entry, class 0, score and weight 1, a huge box
    any_valid = valid.any(dim=-1, keepdim=True)  # [B, 1]
    first = (torch.arange(g, device=valid.device) == 0).expand(b, g)
    fallback = torch.tensor([-10000.0, -10000.0, 10000.0, 10000.0], dtype=boxes.dtype,
                            device=boxes.device)
    boxes = torch.where(any_valid[..., None], boxes, fallback)
    valid = torch.where(any_valid, valid, first)
    scores = torch.where(any_valid, scores, first.to(scores.dtype))
    weights = torch.where(any_valid, weights, first.to(weights.dtype))
    classes = torch.where(any_valid, classes, torch.zeros_like(classes))
    boxes = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    return PseudoGT(boxes, classes, scores, weights, valid)


def _match(proposal_boxes, proposal_valid, pgt: PseudoGT, matcher: Matcher, num_classes: int):
    """Match every proposal to the pseudo GT: class (``num_classes`` for
    background, -1 for matcher-ignore and invalid rows) and the matched
    box, score and weight."""
    iou = pairwise_iou(pgt.boxes, proposal_boxes)  # [B, G, P]
    idx, labels = matcher(iou, gt_valid=pgt.valid)
    bg = torch.full_like(idx, num_classes)
    gt_classes = torch.where(labels == 1, torch.gather(pgt.classes, 1, idx), bg)
    ignore = (labels == -1) | ~proposal_valid.bool()
    gt_classes = torch.where(ignore, torch.full_like(gt_classes, -1), gt_classes)
    gt_boxes = torch.gather(pgt.boxes, 1, idx[..., None].expand(idx.shape + (4,)))
    return (gt_classes, gt_boxes, torch.gather(pgt.scores, 1, idx),
            torch.gather(pgt.weights, 1, idx))


def label_and_sample_wsl(proposal_boxes: torch.Tensor, proposal_valid: torch.Tensor,
                         pgt: PseudoGT, matcher: Matcher, num_classes: int,
                         batch_size_per_image: int, positive_fraction: float,
                         u_pos: torch.Tensor, u_neg: torch.Tensor) -> LabeledProposals:
    """Relabel ``proposal_boxes [B, P, 4]`` against the mined pseudo GT and
    subsample (draws ``u_pos``, ``u_neg`` ``[B, P]``): unsampled rows become
    ignore (-1) but every row is kept. Ignored rows get weight 0; background
    rows keep their matched weight."""
    gt_classes, gt_boxes, gt_scores, gt_weights = _match(proposal_boxes, proposal_valid, pgt,
                                                         matcher, num_classes)
    sample_labels = torch.where(gt_classes == num_classes, 0,
                                torch.where(gt_classes >= 0, 1, -1))
    pos, neg = subsample_labels(sample_labels, batch_size_per_image, positive_fraction,
                                u_pos, u_neg)
    gt_classes = torch.where(pos | neg, gt_classes, torch.full_like(gt_classes, -1))
    gt_weights = torch.where(gt_classes == -1, torch.zeros_like(gt_weights), gt_weights)
    return LabeledProposals(gt_classes, gt_boxes, gt_scores, gt_weights)


def label_and_sample_plain(proposal_boxes: torch.Tensor, proposal_valid: torch.Tensor,
                           pgt: PseudoGT, matcher: Matcher, num_classes: int) -> LabeledProposals:
    """``WSOVOD.SAMPLING.SAMPLING_ON = False``: d2's plain labelling with
    the ROI-heads matcher and no subsampling."""
    gt_classes, gt_boxes, gt_scores, gt_weights = _match(proposal_boxes, proposal_valid, pgt,
                                                         matcher, num_classes)
    gt_weights = torch.where(gt_classes == -1, torch.zeros_like(gt_weights), gt_weights)
    return LabeledProposals(gt_classes, gt_boxes, gt_scores, gt_weights)
