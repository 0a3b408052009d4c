"""Top-proposal selection, mask-aware with static shapes (counterpart of
``wsovod_tpu/models/proposal_utils.py:36-145``): ``find_top_rpn_proposals``
and its MRRP variant ``find_top_rpn_proposals_group``."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..ops.nms import batched_nms_mask, top_k
from ..structures.boxes import clip_boxes, nonempty_boxes
from ..structures.instances import Instances


def find_top_rpn_proposals(
    proposals: Sequence[torch.Tensor],  # per level [B, Hi*Wi*A, 4]
    objectness_logits: Sequence[torch.Tensor],  # per level [B, Hi*Wi*A]
    image_sizes: torch.Tensor,  # [B, 2] (h, w)
    nms_thresh: float,
    pre_nms_topk: int,
    post_nms_topk: int,
    min_box_size: float,
    group_ids: Optional[Sequence[int]] = None,
) -> Instances:
    """Per level (or group) top-k by objectness, concat, clip to the image,
    drop small and non-finite boxes, NMS aware of the level, keep
    ``post_nms_topk``. Returns ``Instances`` with ``proposal_boxes [B, K,
    4]``, ``objectness_logits [B, K]``, ``level_ids [B, K]`` (the entry's
    ``group_ids``, default its index); invalid rows are zeroed."""
    if group_ids is None:
        group_ids = range(len(proposals))
    cand_boxes, cand_logits, cand_ids, cand_valid = [], [], [], []
    for gid, boxes_l, logits_l in zip(group_ids, proposals, objectness_logits):
        k = min(pre_nms_topk, logits_l.shape[1])
        neg_inf = torch.tensor(float("-inf"), dtype=logits_l.dtype, device=logits_l.device)
        safe = torch.where(torch.isfinite(logits_l), logits_l, neg_inf)
        topv, topi = top_k(safe, k)
        cand_boxes.append(torch.gather(boxes_l, 1, topi[..., None].expand(-1, -1, 4)))
        cand_logits.append(topv)
        cand_ids.append(torch.full(topv.shape, gid, dtype=torch.int32, device=topv.device))
        cand_valid.append(torch.isfinite(topv))

    boxes = torch.cat(cand_boxes, dim=1)
    logits = torch.cat(cand_logits, dim=1)
    ids = torch.cat(cand_ids, dim=1)
    valid = torch.cat(cand_valid, dim=1)

    boxes = clip_boxes(boxes, image_sizes)  # h, w [B, 1] against [B, K]
    valid = valid & nonempty_boxes(boxes, threshold=min_box_size)
    valid = valid & torch.isfinite(boxes).all(dim=-1)

    # only the post_nms_topk best survivors are kept: the scan may stop there
    keep = batched_nms_mask(boxes, logits, ids, nms_thresh, valid=valid, stop_after=post_nms_topk)
    neg_inf = torch.tensor(float("-inf"), dtype=logits.dtype, device=logits.device)
    topv, topi = top_k(torch.where(keep, logits, neg_inf), min(post_nms_topk, logits.shape[1]))
    v = topv > neg_inf
    b = torch.gather(boxes, 1, topi[..., None].expand(-1, -1, 4))
    i = torch.gather(ids, 1, topi)
    b = torch.where(v[..., None], b, torch.zeros((), dtype=b.dtype, device=b.device))
    s = torch.where(v, topv, torch.zeros((), dtype=topv.dtype, device=topv.device))
    return Instances(v, proposal_boxes=b, objectness_logits=s, level_ids=i)


def find_top_rpn_proposals_group(
    proposals: Sequence[torch.Tensor],  # per branch [B, Hi*Wi*A, 4]
    objectness_logits: Sequence[torch.Tensor],  # per branch [B, Hi*Wi*A]
    image_sizes: torch.Tensor,
    num_anchors: int,
    nms_thresh: float,
    pre_nms_topk: int,
    post_nms_topk: int,
    min_box_size: float,
) -> Instances:
    """MRRP variant: one group per (branch, anchor), ``ceil(pre_nms_topk /
    groups)`` candidates each, group id ``branch * 1000 + anchor`` (the
    pooler decodes the branch as ``level_ids // 1000``), NMS batched by group
    id. Each level is position-major with the ``num_anchors`` anchors minor,
    so anchor ``a`` is the strided view ``[:, a::A]``."""
    grp_boxes, grp_logits, grp_ids = [], [], []
    for lvl, (boxes_l, logits_l) in enumerate(zip(proposals, objectness_logits)):
        b, n, _ = boxes_l.shape
        boxes_r = boxes_l.reshape(b, n // num_anchors, num_anchors, 4)
        logits_r = logits_l.reshape(b, n // num_anchors, num_anchors)
        for a in range(num_anchors):
            grp_boxes.append(boxes_r[:, :, a])
            grp_logits.append(logits_r[:, :, a])
            grp_ids.append(lvl * 1000 + a)
    per_group_k = max(1, math.ceil(pre_nms_topk / max(len(grp_ids), 1)))
    return find_top_rpn_proposals(grp_boxes, grp_logits, image_sizes, nms_thresh, per_group_k,
                                  post_nms_topk, min_box_size, group_ids=grp_ids)
