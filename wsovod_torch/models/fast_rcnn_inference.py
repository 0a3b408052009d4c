"""Detection production, masked and static-shape (counterpart of
``wsovod_tpu/models/fast_rcnn_inference.py``).

Per image and class, the top ``per_class_topk`` proposals are NMS
candidates; class-wise NMS runs as one batch over ``[B, C, M]`` (classes
never interact), and the survivors of all classes compete for the global
top ``topk_per_image``. Images and classes are batch dims, not loops.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.nms import nms_mask, top_k
from ..structures.boxes import clip_boxes


class Detections(NamedTuple):
    boxes: torch.Tensor  # [B, K, 4]
    scores: torch.Tensor  # [B, K]
    classes: torch.Tensor  # [B, K] int64
    valid: torch.Tensor  # [B, K] bool
    pred_inds: torch.Tensor  # [B, K] index into the input proposals


def fast_rcnn_inference_batched(
    boxes: torch.Tensor,  # [B, P, 4] class-agnostic predicted boxes
    scores: torch.Tensor,  # [B, P, C+1] probabilities, background last
    valid: torch.Tensor,  # [B, P]
    image_sizes: torch.Tensor,  # [B, 2] (h, w)
    score_thresh: float = 1e-5,
    nms_thresh: float = 0.3,
    topk_per_image: int = 100,
    per_class_topk: int = 256,
) -> Detections:
    b, p, c1 = scores.shape
    c = c1 - 1
    boxes = clip_boxes(boxes, image_sizes)  # h, w [B, 1] against [B, P]
    finite = torch.isfinite(boxes).all(dim=-1) & torch.isfinite(scores).all(dim=-1)
    ok = valid & finite  # [B, P]

    m = min(per_class_topk, p)
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=scores.device)
    s_t = torch.where(ok[:, None, :], scores[..., :c].transpose(1, 2), neg_inf)  # [B, C, P]
    top_s, top_i = top_k(s_t, m)  # [B, C, M]
    cand_boxes = torch.gather(
        boxes[:, None].expand(b, c, p, 4), 2, top_i[..., None].expand(b, c, m, 4)
    )  # [B, C, M, 4]
    cand_ok = top_s > score_thresh
    keep = nms_mask(cand_boxes, top_s, nms_thresh, valid=cand_ok)

    flat_scores = torch.where(keep, top_s, neg_inf).reshape(b, c * m)
    flat_boxes = cand_boxes.reshape(b, c * m, 4)
    flat_cls = torch.arange(c, device=scores.device).repeat_interleave(m)
    flat_inds = top_i.reshape(b, c * m)
    k = min(topk_per_image, c * m)
    best_s, best_i = top_k(flat_scores, k)
    return Detections(
        torch.gather(flat_boxes, 1, best_i[..., None].expand(b, k, 4)),
        best_s,
        flat_cls[best_i],
        best_s > neg_inf,
        torch.gather(flat_inds, 1, best_i),
    )
