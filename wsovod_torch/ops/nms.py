"""Masked, static-shape NMS on the device (counterpart of
``wsovod_tpu/ops/nms.py``).

There is no torchvision here: the greedy scan is a Python loop of tensor ops
over score-sorted boxes against a precomputed IoU matrix, batched over any
leading dims (images, classes). Nothing inside the loop reads a value back to
the host, so the scan is enqueued on the device without a synchronisation.
Sorting is stable, as ``jnp.argsort`` is, and ``top_k`` keeps the lower
index first among ties, as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..structures.boxes import pairwise_iou


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last dim: descending values, ties broken
    by the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    valid: Optional[torch.Tensor] = None,
    stop_after: Optional[int] = None,
) -> torch.Tensor:
    """Greedy NMS; returns a bool keep mask aligned with the input order.

    ``boxes [..., N, 4]``, ``scores [..., N]``, ``valid [..., N]``: invalid
    rows are never kept and never suppress. With ``stop_after``, boxes the
    reference's early-exit scan would not reach (those with ``stop_after``
    survivors before them in score order) are reported as not kept. The scan
    here always runs to the end; since box ``i``'s fate is final once every
    earlier box is processed, masking afterwards gives the same result.
    """
    n = boxes.shape[-2]
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=scores.device)
    masked = torch.where(valid, scores, neg_inf)
    order = torch.argsort(-masked, dim=-1, stable=True)
    sboxes = torch.gather(boxes, -2, order[..., None].expand(order.shape + (4,)))
    svalid = torch.gather(valid, -1, order)

    later = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(diagonal=1)
    suppress = (pairwise_iou(sboxes, sboxes) > iou_threshold) & later
    keep = svalid.clone()
    for i in range(n):
        # a kept box i removes every later box it overlaps
        keep &= ~(keep[..., i : i + 1] & suppress[..., i, :])
    if stop_after is not None and stop_after < n:
        kept_before = torch.cumsum(keep.to(torch.int32), dim=-1) - keep.to(torch.int32)
        keep &= kept_before < stop_after
    return torch.zeros_like(keep).scatter(-1, order, keep)


def batched_nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    iou_threshold: float,
    valid: Optional[torch.Tensor] = None,
    stop_after: Optional[int] = None,
) -> torch.Tensor:
    """Category-aware NMS by the coordinate-offset trick: boxes with
    different ``idxs`` never suppress each other. The offset is computed per
    batch row (``boxes [..., N, 4]``), as the reference's per-image vmap."""
    if valid is None:
        vb = boxes
    else:
        vb = torch.where(valid[..., None], boxes, torch.zeros((), dtype=boxes.dtype, device=boxes.device))
    max_coord = vb.flatten(-2).amax(dim=-1) + 1.0  # [...]
    offsets = idxs.to(boxes.dtype) * max_coord[..., None]
    shifted = boxes + offsets[..., None]
    return nms_mask(shifted, scores, iou_threshold, valid=valid, stop_after=stop_after)


def nms_topk(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    k: int,
    valid: Optional[torch.Tensor] = None,
    idxs: Optional[torch.Tensor] = None,
):
    """NMS, then the top-``k`` survivors by score: ``(indices [..., k],
    keep_valid [..., k])``; indices are arbitrary where not valid."""
    if idxs is None:
        keep = nms_mask(boxes, scores, iou_threshold, valid=valid, stop_after=k)
    else:
        keep = batched_nms_mask(boxes, scores, idxs, iou_threshold, valid=valid, stop_after=k)
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=scores.device)
    topv, topi = top_k(torch.where(keep, scores, neg_inf), k)
    return topi, topv > neg_inf
