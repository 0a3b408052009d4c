"""ROI feature pooler for the gated ROIPool and ROILoopPool (counterpart of
``wsovod_tpu/models/poolers.py`` ``ROIPooler.fused_chunk_pool``,
``:171-186,571-607,801-833``).

The pooler applies a per-ROI gate inside the pool kernel, zeroes invalid
boxes, and hands the DAN one channel chunk of ``c_take`` channels at a time
(512 where C is a multiple of 512, else all of C), so the ``[B, N, 7, 7,
C]`` pooled tensor never exists in full. At inference the gate is the WSOVOD
objectness gate ``(objectness + 1) * valid``; in training it is the validity
mask and the objectness gate moves to fc1's output (see ``roi_heads.py``).
Each chunk is one call of this module, so a forward hook sees every chunk
the model pools. ``ROIPool`` chunks go through ``RoIPoolGatedFunction``
and ``ROILoopPool`` chunks through ``RoILoopPoolGatedFunction``, whose
backwards are kernels too.

``ROILoopPool`` pools only the ROI row at inference (``rows=1``): there the
frame and context rows feed nothing; in training it pools all three (``[3,
B, N, P, P, c]``), for the object miner (see ``roi_heads.py``). Under MRRP
the feature is the branch-major concat ``[n_br * B, H, W, C]``; ROI ``n`` of
image ``b`` reads copy ``branch * B + b`` with ``branch = (level_ids //
1000) % n_br``, passed to the kernel per ROI. The JAX package's
``branch_partition`` sort and unsort exist only because a TPU block reads
one branch's tile; a per-ROI source index needs neither. None of its TPU
schedule toggles (hpyr, wsplit, cls, n56c, tile8, maxabs, fullrow) exist
here.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import torch
from torch import nn

from ..ops.roi_pool import RoILoopPoolGatedFunction, RoIPoolGatedFunction


def chunk_width(channels: int) -> int:
    """Channel chunk the pooler emits and the DAN's fc1 consumes."""
    return 512 if channels % 512 == 0 else channels


class ROIPooler(nn.Module):
    def __init__(self, output_size: int, scale: float, pooler_type: str = "ROIPool",
                 context_ratio: float = 1.8):
        super().__init__()
        if pooler_type not in ("ROIPool", "ROILoopPool"):
            raise ValueError(f"unsupported pooler type {pooler_type}")
        self.output_size = output_size
        self.scale = float(scale)
        self.pooler_type = pooler_type
        self.context_ratio = context_ratio

    def forward(self, feat: torch.Tensor, boxes: torch.Tensor, gate: torch.Tensor,
                c_base: int, c_take: int, src: Optional[torch.Tensor] = None,
                rows: int = 1) -> torch.Tensor:
        """One gated chunk ``[B, N, P, P, c_take]``: ``roi_pool_gated``, or
        the ROI row of ``roi_loop_pool_gated`` reading copy ``src [B, N]``;
        with ``rows`` 3 all of its rows, ``[3, B, N, P, P, c_take]``. Both
        differentiable."""
        if self.pooler_type == "ROILoopPool":
            out = RoILoopPoolGatedFunction.apply(feat, boxes, gate, src, c_base, c_take, rows,
                                                 self.output_size, self.scale, self.context_ratio)
            return out[0] if rows == 1 else out
        return RoIPoolGatedFunction.apply(feat, boxes, gate, c_base, c_take, self.output_size,
                                          self.scale)

    def chunks(self, feat: torch.Tensor, boxes: torch.Tensor, gate: torch.Tensor,
               valid: torch.Tensor, c_take: int, level_ids: Optional[torch.Tensor] = None,
               rows: int = 1) -> Iterator[torch.Tensor]:
        """Lazily pool every channel chunk of ``feat [S, H, W, C]`` for
        ``boxes [B, N, 4]`` (zeroed where not ``valid``), gated by ``gate
        [B, N]``; ``S`` is ``B``, or ``n_br * B`` for an MRRP ROILoopPool
        routed by ``level_ids``, whose chunks have ``rows`` rows."""
        gate = gate.float().contiguous()
        zero = torch.zeros((), dtype=torch.float32, device=boxes.device)
        boxes = torch.where(valid[..., None], boxes.float(), zero).contiguous()
        src = None
        if self.pooler_type == "ROILoopPool":
            b = boxes.shape[0]
            n_br = feat.shape[0] // b
            image = torch.arange(b, dtype=torch.int32, device=boxes.device)[:, None]
            branch = (torch.zeros(boxes.shape[:2], dtype=torch.int32, device=boxes.device)
                      if level_ids is None
                      else torch.remainder(torch.div(level_ids, 1000, rounding_mode="floor"), n_br))
            src = (branch * b + image).to(torch.int32).contiguous()
        for c_base in range(0, feat.shape[-1], c_take):
            yield self(feat, boxes, gate, c_base, c_take, src, rows)


def build_pooler(cfg, strides: Sequence[int]) -> ROIPooler:
    """Single-level ROIPool or ROILoopPool (``config.check_supported``
    refuses the other pooler types and multi-level pooling)."""
    rb = cfg.MODEL.ROI_BOX_HEAD
    return ROIPooler(rb.POOLER_RESOLUTION, 1.0 / strides[0], rb.POOLER_TYPE)
