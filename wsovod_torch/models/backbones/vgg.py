"""VGG16-DC5 backbone, plain and MRRP (counterpart of
``wsovod_tpu/models/backbones/vgg.py``; reference
``wsovod/modeling/backbone/vgg.py`` and ``vgg_mrrp.py``).

* five plain stages of 2, 2, 3, 3 and 3 convs (3x3, with a bias, no norm,
  each followed by a ReLU), 64, 128, 256, 512 and 512 channels;
* an unpadded 2x2 max pool after plain1..plain4, stride 2, except plain4's
  at ``CONV5_DILATION == 2`` (DC5): stride 1 and still unpadded, so H and W
  shrink by one pixel there (688x1056 gives ``[B, 85, 131, 512]``), as the
  reference's ``MaxPool2d(2, stride=1)``; plain5 then runs its convs at
  dilation 2, total stride 8;
* MRRP (``vgg_mrrp.py``): plain5 runs once per branch dilation with its one
  set of weights and the branches concatenate on the batch axis,
  branch-major, ``[n_br * B, h, w, 512]``; in training every branch runs,
  at inference with a test branch index ``>= 0`` only that branch's.

Parameter names are the reference's, ``plain{k}.conv{i}.{weight,bias}``.
The forward takes and returns NHWC tensors and runs NCHW in
``channels_last`` memory inside, as the WSR ResNet.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import ConvNorm

# (name, channels, convs)
_PLAN = (("plain1", 64, 2), ("plain2", 128, 2), ("plain3", 256, 3), ("plain4", 512, 3),
         ("plain5", 512, 3))
# Freeze stage of each block, by the JAX package's optimizer labels
# (``wsovod_tpu/solver/build.py:22-31``): ``plain{s}`` for s = 2..5 is stage
# s, and ``plain1`` matches no rule and falls through to stage 5.
FREEZE_STAGE = {"plain1": 5, "plain2": 2, "plain3": 3, "plain4": 4, "plain5": 5}


class PlainBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_conv: int, dilation: int = 1):
        super().__init__()
        self.num_conv = num_conv
        for i in range(num_conv):
            self.add_module(f"conv{i + 1}", ConvNorm(in_channels if i == 0 else out_channels,
                                                     out_channels, 3, dilation=dilation, norm="",
                                                     bias=True))

    def forward(self, x: torch.Tensor, dilation: Optional[int] = None) -> torch.Tensor:
        for i in range(self.num_conv):
            x = F.relu(getattr(self, f"conv{i + 1}")(x, dilation))
        return x


class VGG16(nn.Module):
    """``forward(x [B, H, W, 3], train)`` -> ``{name: [B, h, w, C]}`` (NHWC
    views of ``channels_last`` tensors) for the names in ``out_features``;
    with MRRP the stages from ``mrrp_stage`` on give ``[n_br * B, h, w,
    C]``, where ``n_br`` is ``len(mrrp_dilations)``, or 1 at inference with
    ``mrrp_test_branch_idx >= 0``."""

    def __init__(self, conv5_dilation: int = 1, out_features: Sequence[str] = ("plain5",),
                 mrrp_on: bool = False, mrrp_dilations: Sequence[int] = (1, 2, 4),
                 mrrp_stage: str = "plain5", mrrp_test_branch_idx: int = -1):
        super().__init__()
        self.conv5_dilation = conv5_dilation
        self.out_features = tuple(out_features)
        self.mrrp_stage = mrrp_stage if mrrp_on else None
        self.mrrp_dilations = tuple(mrrp_dilations)
        self.mrrp_test_branch_idx = mrrp_test_branch_idx
        in_ch = 3
        for name, ch, n_conv in _PLAN:
            dilation = conv5_dilation if name == "plain5" else 1
            self.add_module(name, PlainBlock(in_ch, ch, n_conv, dilation))
            in_ch = ch

    def _pool_stride(self, name: str) -> int:
        """Stride of the 2x2 pool after ``name`` (0: none)."""
        if name == "plain5":
            return 0
        return 1 if name == "plain4" and self.conv5_dilation == 2 else 2

    def freeze(self, freeze_at: int) -> None:
        """Turn ``requires_grad`` off for the blocks whose freeze stage
        (``FREEZE_STAGE``) is at most ``freeze_at``; at 4 that leaves plain1
        and plain5 trainable, as in the JAX package."""
        for name, _, _ in _PLAN:
            if FREEZE_STAGE[name] <= freeze_at:
                for p in getattr(self, name).parameters():
                    p.requires_grad_(False)

    def output_channels(self) -> Dict[str, int]:
        return {n: c for n, c, _ in _PLAN if n in self.out_features}

    def output_strides(self) -> Dict[str, int]:
        s45 = 8 if self.conv5_dilation == 2 else 16
        strides = {"plain1": 2, "plain2": 4, "plain3": 8, "plain4": s45, "plain5": s45}
        return {k: v for k, v in strides.items() if k in self.out_features}

    def forward(self, x: torch.Tensor, train: bool = False) -> Dict[str, torch.Tensor]:
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        dilations = self.mrrp_dilations
        if not train and self.mrrp_test_branch_idx >= 0:
            dilations = (dilations[self.mrrp_test_branch_idx],)
        outputs = {}
        for name, _, _ in _PLAN:
            block = getattr(self, name)
            if name == self.mrrp_stage:
                x = torch.cat([block(x, d) for d in dilations], dim=0)
            else:
                x = block(x)
            stride = self._pool_stride(name)
            if stride:
                x = F.max_pool2d(x, 2, stride)
            if name in self.out_features:
                outputs[name] = x.permute(0, 2, 3, 1).contiguous()
            if len(outputs) == len(self.out_features):
                break
        return outputs


def build_vgg_backbone(cfg) -> VGG16:
    """VGG16 from ``MODEL.VGG`` and ``MODEL.MRRP``; ``build_mrrp_vgg_backbone``
    builds the same module, as in the JAX package."""
    v, mrrp = cfg.MODEL.VGG, cfg.MODEL.MRRP
    if v.DEPTH != 16:
        raise NotImplementedError(f"MODEL.VGG.DEPTH={v.DEPTH} (only VGG16 is ported)")
    return VGG16(
        conv5_dilation=v.CONV5_DILATION,
        out_features=tuple(v.OUT_FEATURES),
        mrrp_on=mrrp.MRRP_ON,
        mrrp_dilations=tuple(mrrp.BRANCH_DILATIONS),
        mrrp_stage=mrrp.MRRP_STAGE,
        mrrp_test_branch_idx=mrrp.TEST_BRANCH_IDX,
    )
