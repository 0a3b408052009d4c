"""Box operations on ``[..., 4]`` XYXY tensors (counterpart of
``wsovod_tpu/structures/boxes.py``). Padded rows are all-zero boxes: zero
area, they never win an IoU match."""

from __future__ import annotations

import math

import torch

_DEFAULT_SCALE_CLAMP = math.log(1000.0 / 16)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    wh = (boxes[..., 2:4] - boxes[..., 0:2]).clamp(min=0.0)
    return wh[..., 0] * wh[..., 1]


def clip_boxes(boxes: torch.Tensor, image_size) -> torch.Tensor:
    """Clip to ``(h, w)``: a tuple, or a ``[..., 2]`` tensor whose leading
    dims broadcast against ``boxes[..., 0]`` after a trailing unsqueeze."""
    if isinstance(image_size, (tuple, list)):
        h = torch.as_tensor(float(image_size[0]), dtype=boxes.dtype, device=boxes.device)
        w = torch.as_tensor(float(image_size[1]), dtype=boxes.dtype, device=boxes.device)
    else:
        h = image_size[..., 0:1].to(boxes.dtype)
        w = image_size[..., 1:2].to(boxes.dtype)
    x1 = torch.minimum(boxes[..., 0].clamp(min=0), w)
    y1 = torch.minimum(boxes[..., 1].clamp(min=0), h)
    x2 = torch.minimum(boxes[..., 2].clamp(min=0), w)
    y2 = torch.minimum(boxes[..., 3].clamp(min=0), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def nonempty_boxes(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w > threshold) & (h > threshold)


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU of all pairs, batched over leading dims: ``[..., N, 4]`` x
    ``[..., M, 4]`` -> ``[..., N, M]``; 0 where the union is empty."""
    lt = torch.maximum(boxes1[..., :, None, 0:2], boxes2[..., None, :, 0:2])
    rb = torch.minimum(boxes1[..., :, None, 2:4], boxes2[..., None, :, 2:4])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1)[..., :, None] + box_area(boxes2)[..., None, :] - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, torch.ones_like(union)), 0.0)


def apply_deltas(
    deltas: torch.Tensor,
    boxes: torch.Tensor,
    weights=(1.0, 1.0, 1.0, 1.0),
    scale_clamp: float = _DEFAULT_SCALE_CLAMP,
) -> torch.Tensor:
    """Apply Faster R-CNN ``(dx, dy, dw, dh)`` deltas; ``deltas`` may be
    ``[..., K*4]`` (boxes broadcast per class). ``dw``/``dh`` are clamped at
    ``scale_clamp`` before the exp."""
    orig_shape = deltas.shape
    k4 = orig_shape[-1]
    assert k4 % 4 == 0, f"deltas last dim {k4} not divisible by 4"
    d = deltas.reshape(orig_shape[:-1] + (k4 // 4, 4))

    w = (boxes[..., 2] - boxes[..., 0])[..., None]
    h = (boxes[..., 3] - boxes[..., 1])[..., None]
    cx = boxes[..., 0][..., None] + 0.5 * w
    cy = boxes[..., 1][..., None] + 0.5 * h

    wx, wy, ww, wh = weights
    dx = d[..., 0] / wx
    dy = d[..., 1] / wy
    dw = (d[..., 2] / ww).clamp(max=scale_clamp)
    dh = (d[..., 3] / wh).clamp(max=scale_clamp)

    pred_cx = dx * w + cx
    pred_cy = dy * h + cy
    pred_w = torch.exp(dw) * w
    pred_h = torch.exp(dh) * h
    out = torch.stack(
        [pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
         pred_cx + 0.5 * pred_w, pred_cy + 0.5 * pred_h],
        dim=-1,
    )
    return out.reshape(orig_shape)
