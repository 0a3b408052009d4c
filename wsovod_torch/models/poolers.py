"""ROI feature pooler for the plain gated ROIPool (counterpart of the
inference ``ROIPool`` branch of ``wsovod_tpu/models/poolers.py``
``ROIPooler.fused_chunk_pool``).

The pooler applies the WSOVOD objectness gate ``(objectness + 1) * valid``
inside the pool kernel, zeroes invalid boxes, and hands the DAN one channel
chunk of ``c_take`` channels at a time (512 where C is a multiple of 512,
else all of C), so the ``[B, N, 7, 7, C]`` pooled tensor never exists in
full. None of the reference's TPU schedule toggles (hpyr, wsplit, cls, n56c,
tile8, maxabs, fullrow) exist here. Each chunk is one call of this module,
so a forward hook sees every chunk the model pools.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import torch
from torch import nn

from ..ops.roi_pool import roi_pool_gated


def chunk_width(channels: int) -> int:
    """Channel chunk the pooler emits and the DAN's fc1 consumes."""
    return 512 if channels % 512 == 0 else channels


class ROIPooler(nn.Module):
    def __init__(self, output_size: int, scale: float):
        super().__init__()
        self.output_size = output_size
        self.scale = float(scale)

    def forward(self, feat: torch.Tensor, boxes: torch.Tensor, gate: torch.Tensor,
                c_base: int, c_take: int) -> torch.Tensor:
        """One gated chunk ``[B, N, P, P, c_take]`` (see ``roi_pool_gated``)."""
        return roi_pool_gated(feat, boxes, gate, c_base, c_take, self.output_size, self.scale)

    def chunks(self, feat: torch.Tensor, boxes: torch.Tensor, objectness: torch.Tensor,
               valid: torch.Tensor, c_take: int) -> Iterator[torch.Tensor]:
        """Lazily pool every channel chunk of ``feat [B, H, W, C]`` for
        ``boxes [B, N, 4]``, gated by ``(objectness + 1) * valid``."""
        gate = ((objectness.float() + 1.0) * valid.float()).contiguous()
        zero = torch.zeros((), dtype=torch.float32, device=boxes.device)
        boxes = torch.where(valid[..., None], boxes.float(), zero).contiguous()
        for c_base in range(0, feat.shape[-1], c_take):
            yield self(feat, boxes, gate, c_base, c_take)


def build_pooler(cfg, strides: Sequence[int]) -> ROIPooler:
    """Single-level plain ROIPool (``config.check_supported`` refuses the
    other pooler types and multi-level pooling)."""
    return ROIPooler(cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION, 1.0 / strides[0])
