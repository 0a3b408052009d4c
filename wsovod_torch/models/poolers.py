"""ROI feature pooler for the gated ROIPool, ROILoopPool and ROIAlign
(counterpart of ``wsovod_tpu/models/poolers.py`` ``ROIPooler.fused_chunk_pool``
and ``_pool_one_level``, ``:171-186,288-298,571-607,739-873``).

The pooler applies a per-ROI gate inside the pool kernel, zeroes invalid
boxes, and hands the DAN one channel chunk of ``c_take`` channels at a time
(512 where C is a multiple of 512, else all of C; with the int8 fc1 the
ROILoopPool's chunk is 256, the JAX pooler's, since the chunk is the int8
quantization group), so the ``[B, N, 7, 7, C]`` pooled tensor never exists
in full. At inference the gate is the WSOVOD
objectness gate ``(objectness + 1) * valid``; in training it is the validity
mask and the objectness gate moves to fc1's output (see ``roi_heads.py``).
Each chunk is one call of this module, so a forward hook sees every chunk
the model pools. ``ROIPool`` chunks go through ``RoIPoolGatedFunction``,
``ROILoopPool`` chunks through ``RoILoopPoolGatedFunction`` and
``ROIAlignV2`` and ``ROIAlign`` chunks (ROIAlign with ``aligned`` true and
false) through ``RoIAlignGatedFunction``, whose backwards are kernels too.

ROIAlign samples ``max(sampling_ratio, 1)`` points per bin axis, where
``POOLER_SAMPLING_RATIO`` 0 means 2, as the JAX package's pooler sets it
(``wsovod_tpu/models/poolers.py:156``; torchvision's 0 would be adaptive,
``ceil(roi / P)``: ROADMAP 3.9). ``TPU.ROI_ALIGN_KERNEL`` picks the exact
align for ``fused``, ``pallas`` and ``gather`` (all three compute exact
ROIAlignV2 in the JAX package) and the windowed one of
``roi_align_pallas`` for ``pallas_approx`` (ROIAlignV2 only, as in the JAX
package; ROIAlign with ``aligned`` false is always exact).

``ROILoopPool`` pools only the ROI row at inference (``rows=1``): there the
frame and context rows feed nothing; in training it pools all three (``[3,
B, N, P, P, c]``), for the object miner (see ``roi_heads.py``). Under MRRP
the feature is the branch-major concat ``[n_br * B, H, W, C]``; ROI ``n`` of
image ``b`` reads copy ``branch * B + b`` with ``branch = (level_ids //
1000) % n_br``, passed to the kernel per ROI (the plain ROIPool of the MRRP
VGG16 and ROIAlign, as ``wsovod_tpu/models/poolers.py:808-840`` pools every
copy and keeps each ROI's, and the ROILoopPool). A plain ROIPool or ROIAlign
on a feature of one copy per image passes no ``src``. The JAX package's
``branch_partition`` sort and unsort exist only because a TPU block reads
one branch's tile; a per-ROI source index needs neither. None of its TPU
schedule toggles (hpyr, wsplit, cls, n56c, fullrow) or ROIAlign size
buckets exist here.

Over several levels (an FPN's ``ROI_HEADS.IN_FEATURES``, ROIPool or
ROILoopPool, inference), each ROI is assigned its level by d2's canonical
rule (``assign_boxes_to_levels``) and pooled on that level only by the
level-routed kernels (``roi_pool_levels``, ``roi_loop_pool_levels``,
kernel 2.5): the JAX package's multi-level pooler pools every ROI on every
level with its per-image pools and then keeps each ROI's level
(``poolers.py:852-873``), which gives the same numbers. The JAX ROI heads
pool unfused there and multiply the pooled tensor by the gate cast to its
dtype (``roi_heads.py:257-300``); the kernels do the same in one pass, and
fc1 takes the chunks as in the single-level path (it works row by row, so
the JAX package's ROI chunking changes no number).

With the int8 fc1 (``TPU.DAN_FC1_QUANT = "int8"``) at inference, the
ROIPool and the ROILoopPool emit ``(payload, maxabs)`` pairs through the
kernels' maxabs emission (``roi_pool_gated_maxabs``,
``roi_loop_pool_gated_maxabs``): the payload is the bf16 emission's, so
fc1's int8 product equals the one the JAX package computes on its default
route (bf16 emission, then fc1's quantize) and on its
``WSOVOD_POOL_MAXABS`` route bit for bit. ROIAlign emits in the feature
dtype and fc1 quantizes, as the JAX pooler does. The other emissions of the
kernels, int8 (``roi_pool_gated_int8``, ``roi_loop_pool_gated_int8``,
``roi_align_gated_int8``) and tile8 (``roi_pool_gated_tile8``), exist as
ops with their plain versions, held against the JAX kernels in the tests,
but no pooler path reaches them: the JAX pooler reaches tile8 only through
its ``WSOVOD_POOL_TILE8`` toggle and the int8 emissions not at all, and the
port carries no toggles.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Sequence

import torch
from torch import nn

from ..ops.roi_align import WINDOW, RoIAlignGatedFunction
from ..ops.roi_pool import (RoILoopPoolGatedFunction, RoIPoolGatedFunction,
                            roi_loop_pool_gated_maxabs, roi_loop_pool_levels,
                            roi_pool_gated_maxabs, roi_pool_levels)
from ..structures.boxes import box_area

POOLER_TYPES = ("ROIPool", "ROILoopPool", "ROIAlign", "ROIAlignV2")
# d2's canonical FPN level rule: a 224-px box pools on p4
CANONICAL_BOX_SIZE = 224.0
CANONICAL_LEVEL = 4


def assign_boxes_to_levels(boxes: torch.Tensor, min_level: int, max_level: int,
                           canonical_box_size: float = CANONICAL_BOX_SIZE,
                           canonical_level: int = CANONICAL_LEVEL) -> torch.Tensor:
    """d2's FPN level of each box, as an index from ``min_level``, int32
    ``[...]``: ``floor(canonical_level + log2(sqrt(area) / canonical_box_size
    + 1e-8))`` clipped to ``[min_level, max_level]``, in float32 and in the
    order of ``wsovod_tpu/models/poolers.py:32-42`` (``sqrt(max(area,
    1e-8))``, the division, ``+ 1e-8``, ``log2``, ``+ canonical_level``,
    ``floor``, the clip). The division by the constant is a multiplication
    by its float32 reciprocal, as XLA compiles it (ROADMAP 3.9), on the CPU
    and on the card alike."""
    sqrt_area = torch.sqrt(torch.clamp(box_area(boxes.float()), min=1e-8))
    inv = torch.tensor(1.0 / canonical_box_size, dtype=torch.float32, device=boxes.device)
    lvl = torch.floor(canonical_level + torch.log2(sqrt_area * inv + 1e-8))
    return (torch.clamp(lvl, min_level, max_level).to(torch.int32) - min_level)


def chunk_width(channels: int, pooler_type: str = "ROIPool", fc1_quant: str = "none") -> int:
    """Channel chunk the pooler emits and the DAN's fc1 consumes: 512 (256
    for the ROILoopPool with the int8 fc1, whose quantization groups are the
    JAX pooler's 256-channel chunks), or all of C where it does not divide."""
    unit = 256 if pooler_type == "ROILoopPool" and fc1_quant == "int8" else 512
    return unit if channels % unit == 0 else channels


class ROIPooler(nn.Module):
    def __init__(self, output_size: int, scales: Sequence[float], pooler_type: str = "ROIPool",
                 context_ratio: float = 1.8, sampling_ratio: int = 0,
                 align_kernel: str = "fused"):
        super().__init__()
        if pooler_type not in POOLER_TYPES:
            raise ValueError(f"unsupported pooler type {pooler_type}")
        self.output_size = output_size
        self.scales = tuple(float(s) for s in scales)
        self.scale = self.scales[0]
        # the pooled levels, log2 of their strides (one level: unused)
        self.min_level = int(round(-math.log2(self.scales[0])))
        self.max_level = int(round(-math.log2(self.scales[-1])))
        self.pooler_type = pooler_type
        self.context_ratio = context_ratio
        self.sampling_ratio = sampling_ratio if sampling_ratio > 0 else 2
        self.aligned = pooler_type == "ROIAlignV2"
        self.window = WINDOW if self.aligned and align_kernel == "pallas_approx" else None

    def emits_maxabs(self, fc1_int8: bool) -> bool:
        """Whether the chunks for an int8 fc1 come as ``(payload, maxabs)``
        pairs: the ROIPool and the ROILoopPool."""
        return fc1_int8 and self.pooler_type in ("ROIPool", "ROILoopPool")

    def forward(self, feat, boxes: torch.Tensor, gate: torch.Tensor, c_base: int, c_take: int,
                src: Optional[torch.Tensor] = None, rows: int = 1, maxabs: bool = False,
                level: Optional[torch.Tensor] = None):
        """One gated chunk ``[B, N, P, P, c_take]``: ``roi_pool_gated`` or
        ``roi_align_gated`` reading copy ``src [B, N]`` (``None``: each ROI
        its own image), or the ROI row of ``roi_loop_pool_gated`` reading
        copy ``src``; with ``rows`` 3 all of its rows, ``[3, B, N, P, P,
        c_take]``. All differentiable (the windowed align in its gate
        only). With ``maxabs`` (inference, ROIPool or the ROILoopPool's ROI
        row) the pair ``(chunk, max |chunk| per ROI [B, N])``. With ``level
        [B, N]`` (several pooled levels; ``feat`` a tuple of the levels'
        maps), the level-routed ``roi_pool_levels`` or
        ``roi_loop_pool_levels``: each ROI on its own level, no backward."""
        if level is not None:
            if self.pooler_type == "ROILoopPool":
                out = roi_loop_pool_levels(feat, boxes, gate, level, c_base, c_take, rows,
                                           self.output_size, self.scales, self.context_ratio)
                return out[0] if rows == 1 else out
            return roi_pool_levels(feat, boxes, gate, level, c_base, c_take, self.output_size,
                                   self.scales)
        if maxabs:
            if self.pooler_type == "ROILoopPool":
                out, m = roi_loop_pool_gated_maxabs(feat, boxes, gate, src, c_base, c_take, 1,
                                                    self.output_size, self.scale,
                                                    self.context_ratio)
                return out[0], m[0]
            return roi_pool_gated_maxabs(feat, boxes, gate, c_base, c_take, self.output_size,
                                         self.scale, src)
        if self.pooler_type in ("ROIAlign", "ROIAlignV2"):
            return RoIAlignGatedFunction.apply(feat, boxes, gate, c_base, c_take, self.output_size,
                                               self.scale, self.sampling_ratio, self.aligned, src,
                                               self.window)
        if self.pooler_type == "ROILoopPool":
            out = RoILoopPoolGatedFunction.apply(feat, boxes, gate, src, c_base, c_take, rows,
                                                 self.output_size, self.scale, self.context_ratio)
            return out[0] if rows == 1 else out
        return RoIPoolGatedFunction.apply(feat, boxes, gate, c_base, c_take, self.output_size,
                                          self.scale, src)

    def chunks(self, feat, boxes: torch.Tensor, gate: torch.Tensor,
               valid: torch.Tensor, c_take: int, level_ids: Optional[torch.Tensor] = None,
               rows: int = 1, maxabs: bool = False) -> Iterator:
        """Lazily pool every channel chunk of ``feat [S, H, W, C]`` for
        ``boxes [B, N, 4]`` (zeroed where not ``valid``), gated by ``gate
        [B, N]``; ``S`` is ``B``, or ``n_br * B`` under MRRP, where each ROI
        reads its branch's copy by ``level_ids``. ROILoopPool chunks have
        ``rows`` rows; with ``maxabs`` each chunk is a ``(chunk, maxabs)``
        pair (``forward``). ``feat`` may be a sequence of several levels'
        maps ``[B, H_l, W_l, C]``, one per scale: then each ROI goes to its
        level by ``assign_boxes_to_levels`` (on the zeroed boxes, as
        ``wsovod_tpu/models/poolers.py:852-860``), once for all chunks.
        Every argument of ``forward`` is passed positionally, so a forward
        hook sees them all."""
        gate = gate.float().contiguous()
        zero = torch.zeros((), dtype=torch.float32, device=boxes.device)
        boxes = torch.where(valid[..., None], boxes.float(), zero).contiguous()
        b = boxes.shape[0]
        if isinstance(feat, (list, tuple)) and len(feat) == 1:
            feat = feat[0]
        if isinstance(feat, (list, tuple)):
            feats = tuple(feat)
            if len(feats) != len(self.scales):
                raise ValueError(f"{len(feats)} levels for {len(self.scales)} scales")
            level = assign_boxes_to_levels(boxes, self.min_level, self.max_level,
                                           CANONICAL_BOX_SIZE, CANONICAL_LEVEL).contiguous()
            for c_base in range(0, feats[0].shape[-1], c_take):
                yield self(feats, boxes, gate, c_base, c_take, None, rows, maxabs, level)
            return
        src = None
        if self.pooler_type == "ROILoopPool" or feat.shape[0] != b:
            n_br = feat.shape[0] // b
            image = torch.arange(b, dtype=torch.int32, device=boxes.device)[:, None]
            branch = (torch.zeros(boxes.shape[:2], dtype=torch.int32, device=boxes.device)
                      if level_ids is None
                      else torch.remainder(torch.div(level_ids, 1000, rounding_mode="floor"), n_br))
            src = (branch * b + image).to(torch.int32).contiguous()
        for c_base in range(0, feat.shape[-1], c_take):
            yield self(feat, boxes, gate, c_base, c_take, src, rows, maxabs, None)


def build_pooler(cfg, strides: Sequence[int]) -> ROIPooler:
    """ROIPool, ROILoopPool or ROIAlign(V2) over the pooled features, whose
    strides are ``strides`` (one per ``ROI_HEADS.IN_FEATURES`` entry;
    ``config.check_supported`` admits several only for ROIPool and
    ROILoopPool without MRRP). The levels are assigned within the pooled
    strides (d2's rule); the JAX package takes ``max_level`` from every
    backbone stride, p6 included (ROADMAP 3.13)."""
    rb = cfg.MODEL.ROI_BOX_HEAD
    return ROIPooler(rb.POOLER_RESOLUTION, [1.0 / s for s in strides], rb.POOLER_TYPE,
                     sampling_ratio=rb.POOLER_SAMPLING_RATIO,
                     align_kernel=cfg.TPU.ROI_ALIGN_KERNEL)
