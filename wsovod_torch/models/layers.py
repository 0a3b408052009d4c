"""Shared building blocks (counterpart of ``wsovod_tpu/models/layers.py``).

Modules take NCHW tensors, which the backbone keeps in ``channels_last``
memory so that its NHWC boundary views are free. Parameters stay float32;
each layer runs in its input's dtype, casting its weights on the fly, as the
JAX package's ``kernel.astype(x.dtype)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm2d(nn.Module):
    """Affine transform with stored statistics (d2 ``FrozenBatchNorm2d``:
    all four tensors are buffers). Folded to one multiply-add whose factors
    are cast to the activation dtype, so a bf16 path stays bf16."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        mul = scale.to(x.dtype).view(1, -1, 1, 1)
        add = (self.bias - self.running_mean * scale).to(x.dtype).view(1, -1, 1, 1)
        return x * mul + add


def get_norm(norm: str, features: int):
    if norm in ("", "none", None):
        return None
    if norm in ("BN", "FrozenBN", "SyncBN"):
        return FrozenBatchNorm2d(features)
    raise ValueError(f"Unsupported norm: {norm}")


class ConvNorm(nn.Module):
    """Conv (with a bias only if ``bias``: VGG's convs) + optional frozen
    norm, d2's ``Conv2d(norm=...)``. Padding is the explicit symmetric
    ``d*(k-1)//2`` of the reference, not "same". ``forward(x, dilation=d)``
    runs the same weight at dilation ``d`` (padding ``d*(k-1)//2``): MRRP's
    shared-weight branches."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1, dilation=1,
                 groups=1, norm="FrozenBN", bias=False):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kernel_size, kernel_size)
        )
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.norm = get_norm(norm, out_channels)

    def forward(self, x: torch.Tensor, dilation: Optional[int] = None) -> torch.Tensor:
        d = self.dilation if dilation is None else dilation
        b = None if self.bias is None else self.bias.to(x.dtype)
        x = F.conv2d(x, self.weight.to(x.dtype), b, self.stride, d * (self.kernel_size - 1) // 2,
                     d, self.groups)
        return self.norm(x) if self.norm is not None else x


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` run in the input's dtype (float32 parameters)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


def QuantizableConv3x3(in_channels: int, features: int) -> Conv2d:
    """The RPN head's 3x3 conv with bias, padding 1. Only the floating-point
    path of the reference's ``QuantizableConv3x3`` is ported; the int8 path
    (``TPU.RPN_CONV_QUANT``) is refused by ``config.check_supported``."""
    return Conv2d(in_channels, features, 3, padding=1)


class Linear(nn.Linear):
    """``nn.Linear`` run in the input's dtype (float32 parameters)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


def max_pool_2x2(x: torch.Tensor, stride: int) -> torch.Tensor:
    """2x2 max pool; for stride 1, pad right and bottom with 0 first (the
    reference's ``ZeroPad2d((0,1,0,1)) + MaxPool2d(2, 1)``), so the spatial
    size is kept."""
    if stride == 1:
        fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
               else torch.contiguous_format)
        x = F.pad(x, (0, 1, 0, 1), value=0.0).contiguous(memory_format=fmt)
        return F.max_pool2d(x, 2, 1)
    return F.max_pool2d(x, 2, stride)
