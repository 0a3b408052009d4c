"""Top-proposal selection, mask-aware with static shapes (counterpart of
``wsovod_tpu/models/proposal_utils.py::find_top_rpn_proposals``; the MRRP
group variant is not ported)."""

from __future__ import annotations

from typing import Sequence

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
) -> Instances:
    """Per level top-k by objectness, concat, clip to the image, drop small
    and non-finite boxes, level-aware NMS, keep ``post_nms_topk``. Returns
    ``Instances`` with ``proposal_boxes [B, K, 4]``, ``objectness_logits
    [B, K]``, ``level_ids [B, K]``; invalid rows are zeroed."""
    cand_boxes, cand_logits, cand_ids, cand_valid = [], [], [], []
    for gid, (boxes_l, logits_l) in enumerate(zip(proposals, objectness_logits)):
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
