"""Anchor generation, d2 ``DefaultAnchorGenerator`` semantics (counterpart
of ``wsovod_tpu/models/anchors.py``). Anchors depend only on the feature
map's shape, so they are made in numpy once per grid size and kept on the
device. Cell anchors are size-major / aspect-minor; grid anchors are
position-major (row-major H, W) with the A cell anchors minor, pairing with
the RPN head's output channels."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def generate_cell_anchors(sizes=(32, 64, 128, 256, 512), aspect_ratios=(0.5, 1.0, 2.0)) -> np.ndarray:
    anchors = []
    for size in sizes:
        area = size ** 2.0
        for ar in aspect_ratios:
            w = float(np.sqrt(area / ar))
            h = w * ar
            anchors.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.array(anchors, dtype=np.float32)


class AnchorGenerator:
    """Per-level grid anchors (one sizes/aspect entry per level, broadcast
    when a single entry is given)."""

    def __init__(self, sizes, aspect_ratios, strides: Sequence[int], offset: float = 0.0):
        self.strides = list(strides)
        n = len(self.strides)
        sizes, aspect_ratios = list(sizes), list(aspect_ratios)
        if len(sizes) == 1:
            sizes = sizes * n
        if len(aspect_ratios) == 1:
            aspect_ratios = aspect_ratios * n
        assert len(sizes) == n and len(aspect_ratios) == n
        self.cell_anchors = [generate_cell_anchors(s, a) for s, a in zip(sizes, aspect_ratios)]
        self.offset = offset
        self._cache: Dict[Tuple, torch.Tensor] = {}

    @property
    def num_anchors(self) -> List[int]:
        return [c.shape[0] for c in self.cell_anchors]

    def grid_anchors_np(self, grid_sizes: Sequence[Tuple[int, int]]) -> List[np.ndarray]:
        """``[(H, W)]`` -> list of ``[H*W*A, 4]`` float32 arrays."""
        out = []
        for (h, w), stride, cell in zip(grid_sizes, self.strides, self.cell_anchors):
            shifts_x = (np.arange(w, dtype=np.float32) + self.offset) * stride
            shifts_y = (np.arange(h, dtype=np.float32) + self.offset) * stride
            sx, sy = np.meshgrid(shifts_x, shifts_y)
            shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
            out.append((shifts + cell[None]).reshape(-1, 4).astype(np.float32))
        return out

    def grid_anchors(self, grid_sizes, device) -> List[torch.Tensor]:
        key = (tuple(map(tuple, grid_sizes)), str(device))
        if key not in self._cache:
            self._cache[key] = [torch.from_numpy(a).to(device) for a in self.grid_anchors_np(grid_sizes)]
        return self._cache[key]
