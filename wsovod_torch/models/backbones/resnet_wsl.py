"""WSR ResNet backbone (counterpart of
``wsovod_tpu/models/backbones/resnet_wsl.py``; reference
``wsovod/modeling/backbone/resnet_wsl.py``).

* stem: three 3x3 convs (the first stride 2) and a 2x2 max pool: stride 4;
* every block conv is stride 1; res2 (and res3 when ``RES5_DILATION == 1``)
  downsample in a trailing 2x2 max pool on their last block, the other
  pooled stages keep their size with the zero-padded stride-1 pool;
* res4 and res5 are dilated by ``RES5_DILATION``; R18/R34 use
  ``BasicBlock``, R50 and deeper ``BottleneckBlock``;
* MRRP (``resnet_wsl.py:157-243`` of the JAX package): every block of the
  MRRP stage (res5) runs once per branch, with the branch's dilation and the
  block's one set of weights, and the stage's output concatenates the
  branches on the batch axis, branch-major: ``[n_br * B, h, w, C]``. In
  training every branch runs; at inference with a test branch index
  ``>= 0`` only that branch's dilation runs (``resnet_wsl.py:195``). With
  res5 trainable its one set of weights takes the sum of the branches'
  gradients.

Parameter names follow d2's module layout (``stem.conv1``,
``res2.0.conv1.norm``, ``res4.0.shortcut``), so reference checkpoints load
with ``load_state_dict``; the MRRP branches share weights, so an MRRP
model has the same names. The forward takes and returns NHWC tensors; inside
it runs NCHW in ``channels_last`` memory, where both boundary permutes are
free views.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import ConvNorm, max_pool_2x2


class BasicStem(nn.Module):
    def __init__(self, in_channels: int = 3, out_channels: int = 64, norm: str = "FrozenBN"):
        super().__init__()
        self.conv1 = ConvNorm(in_channels, out_channels, 3, stride=2, norm=norm)
        self.conv2 = ConvNorm(out_channels, out_channels, 3, norm=norm)
        self.conv3 = ConvNorm(out_channels, out_channels, 3, norm=norm)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        x = F.relu(self.conv3(x))
        return F.max_pool2d(x, 2, 2)


class BasicBlock(nn.Module):
    def __init__(self, in_channels, out_channels, pool_stride=1, has_pool=False, dilation=1,
                 norm="FrozenBN"):
        super().__init__()
        self.pool_stride, self.has_pool = pool_stride, has_pool
        self.conv1 = ConvNorm(in_channels, out_channels, 3, dilation=dilation, norm=norm)
        self.conv2 = ConvNorm(out_channels, out_channels, 3, dilation=dilation, norm=norm)
        self.shortcut = (
            ConvNorm(in_channels, out_channels, 1, norm=norm) if in_channels != out_channels else None
        )

    def forward(self, x, dilation: Optional[int] = None):
        out = F.relu(self.conv1(x, dilation))
        out = self.conv2(out, dilation)
        shortcut = self.shortcut(x) if self.shortcut is not None else x
        out = F.relu(out + shortcut)
        return max_pool_2x2(out, self.pool_stride) if self.has_pool else out


class BottleneckBlock(nn.Module):
    def __init__(self, in_channels, out_channels, bottleneck_channels, pool_stride=1,
                 has_pool=False, dilation=1, num_groups=1, norm="FrozenBN"):
        super().__init__()
        self.pool_stride, self.has_pool = pool_stride, has_pool
        self.conv1 = ConvNorm(in_channels, bottleneck_channels, 1, norm=norm)
        self.conv2 = ConvNorm(bottleneck_channels, bottleneck_channels, 3, dilation=dilation,
                              groups=num_groups, norm=norm)
        self.conv3 = ConvNorm(bottleneck_channels, out_channels, 1, norm=norm)
        self.shortcut = (
            ConvNorm(in_channels, out_channels, 1, norm=norm) if in_channels != out_channels else None
        )

    def forward(self, x, dilation: Optional[int] = None):
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out, dilation))
        out = self.conv3(out)
        shortcut = self.shortcut(x) if self.shortcut is not None else x
        out = F.relu(out + shortcut)
        return max_pool_2x2(out, self.pool_stride) if self.has_pool else out


_BLOCKS_PER_STAGE = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


class WSRResNet(nn.Module):
    """``forward(x [B, H, W, 3], train)`` -> ``{name: [B, h, w, C]}`` (NHWC
    views of ``channels_last`` tensors) for the names in ``out_features``;
    with MRRP the stages from ``mrrp_stage`` on give ``[n_br * B, h, w,
    C]``, where ``n_br`` is ``len(mrrp_dilations)``, or 1 at inference with
    ``mrrp_test_branch_idx >= 0``."""

    def __init__(self, depth=18, stem_out_channels=64, res2_out_channels=64, num_groups=1,
                 width_per_group=64, res5_dilation=2, norm="FrozenBN",
                 out_features: Sequence[str] = ("res5",), mrrp_on: bool = False,
                 mrrp_dilations: Sequence[int] = (1, 2, 4), mrrp_stage: str = "res5",
                 mrrp_test_branch_idx: int = -1):
        super().__init__()
        self.depth = depth
        self.res5_dilation = res5_dilation
        self.out_features = tuple(out_features)
        self.res2_out_channels = res2_out_channels
        self.mrrp_stage = mrrp_stage if mrrp_on else None
        self.mrrp_dilations = tuple(mrrp_dilations)
        self.mrrp_test_branch_idx = mrrp_test_branch_idx
        basic = depth in (18, 34)
        self.stem = BasicStem(3, stem_out_channels, norm)
        in_ch = stem_out_channels
        out_ch = res2_out_channels
        bottleneck = num_groups * width_per_group
        self.stage_names: List[str] = []
        for idx, stage_idx in enumerate(range(2, 6)):
            name = f"res{stage_idx}"
            dilation = res5_dilation if stage_idx in (4, 5) else 1
            first_stride = 2 if idx == 0 or (stage_idx == 3 and res5_dilation == 1) else 1
            has_pool = stage_idx in (2, 3)
            n_blocks = _BLOCKS_PER_STAGE[depth][idx]
            blocks = []
            for b in range(n_blocks):
                last = b == n_blocks - 1
                kw = dict(pool_stride=first_stride if last else 1, has_pool=has_pool and last,
                          dilation=dilation, norm=norm)
                if basic:
                    blocks.append(BasicBlock(in_ch, out_ch, **kw))
                else:
                    blocks.append(BottleneckBlock(in_ch, out_ch, bottleneck,
                                                  num_groups=num_groups, **kw))
                in_ch = out_ch
            self.add_module(name, nn.Sequential(*blocks))
            self.stage_names.append(name)
            out_ch *= 2
            bottleneck *= 2

    def freeze(self, freeze_at: int) -> None:
        """Turn ``requires_grad`` off for the stem (stage 1) and the stages
        ``res2``.. up to ``freeze_at`` (d2's convention; every shipped config
        freezes all five). The frozen-BN statistics are buffers already."""
        for idx, name in enumerate(["stem"] + self.stage_names, start=1):
            if idx <= freeze_at:
                for p in getattr(self, name).parameters():
                    p.requires_grad_(False)

    def output_channels(self) -> Dict[str, int]:
        c = self.res2_out_channels
        out = {}
        for name in ("res2", "res3", "res4", "res5"):
            out[name] = c
            c *= 2
        return {k: v for k, v in out.items() if k in self.out_features}

    def output_strides(self) -> Dict[str, int]:
        stride, out = 4, {}
        for idx, name in enumerate(("res2", "res3", "res4", "res5")):
            stage_idx = idx + 2
            stride *= 2 if idx == 0 or (stage_idx == 3 and self.res5_dilation == 1) else 1
            out[name] = stride
        return {k: v for k, v in out.items() if k in self.out_features}

    def forward(self, x: torch.Tensor, train: bool = False) -> Dict[str, torch.Tensor]:
        x = self.stem(x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
        dilations = self.mrrp_dilations
        if not train and self.mrrp_test_branch_idx >= 0:
            dilations = (dilations[self.mrrp_test_branch_idx],)
        outputs = {}
        for name in self.stage_names:
            stage = getattr(self, name)
            if name == self.mrrp_stage:
                branches = [x] * len(dilations)
                for block in stage:
                    branches = [block(t, d) for t, d in zip(branches, dilations)]
                x = torch.cat(branches, dim=0)
            else:
                x = stage(x)
            if name in self.out_features:
                outputs[name] = x.permute(0, 2, 3, 1).contiguous()
            if len(outputs) == len(self.out_features):
                break
        return outputs


def build_wsl_resnet_backbone(cfg) -> WSRResNet:
    r = cfg.MODEL.RESNETS
    mrrp = cfg.MODEL.MRRP
    if r.DEPTH in (18, 34):
        assert r.RES2_OUT_CHANNELS == 64, (
            f"Set MODEL.RESNETS.RES2_OUT_CHANNELS = 64 for R18/R34 (got {r.RES2_OUT_CHANNELS})"
        )
    return WSRResNet(
        depth=r.DEPTH,
        stem_out_channels=r.STEM_OUT_CHANNELS,
        res2_out_channels=r.RES2_OUT_CHANNELS,
        num_groups=r.NUM_GROUPS,
        width_per_group=r.WIDTH_PER_GROUP,
        res5_dilation=r.RES5_DILATION,
        norm=r.NORM,
        out_features=tuple(r.OUT_FEATURES),
        mrrp_on=mrrp.MRRP_ON,
        mrrp_dilations=tuple(mrrp.BRANCH_DILATIONS),
        mrrp_stage=mrrp.MRRP_STAGE,
        mrrp_test_branch_idx=mrrp.TEST_BRANCH_IDX,
    )
