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


INV127 = 1.0 / 127.0  # applied as a float32 multiply, as XLA compiles `/ 127.0`

INT_MM_CALLS = 0  # int8 GEMMs run by int_mm (fc1's and the RPN conv's)


def _div127(x: torch.Tensor) -> torch.Tensor:
    """``x / 127.0`` as the JAX package's jitted programs compute it: XLA
    turns the division by the constant into a multiplication by its float32
    reciprocal."""
    return x * torch.tensor(INV127, dtype=torch.float32, device=x.device)


def int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """``a @ b_t.T`` for int8 ``a [M, K]`` and ``b_t [F, K]``, summed in
    int32, through ``torch._int_mm`` (cuBLASLt's int8 GEMM on the card; the
    JAX package's int8 ``einsum`` with ``preferred_element_type=int32``).
    cuBLASLt takes M > 16 and K, F multiples of 8, and the second operand
    column-major (a row-major one fails with CUBLAS_STATUS_NOT_SUPPORTED):
    ``b_t`` row-major, passed transposed. Shapes outside that are padded
    with zero rows and columns, which add nothing to the sums, and the
    result is cut back to ``[M, F]``."""
    global INT_MM_CALLS
    m, k = a.shape
    f = b_t.shape[0]
    pad_m, pad_k, pad_f = max(0, 17 - m), -k % 8, -f % 8
    if pad_m or pad_k:
        a = torch.nn.functional.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_f:
        b_t = torch.nn.functional.pad(b_t, (0, pad_k, 0, pad_f))
    out = torch._int_mm(a.contiguous(), b_t.contiguous().t())
    INT_MM_CALLS += 1
    return out[:m, :f] if (pad_m or pad_f) else out


def quantize_act_weight(x: torch.Tensor, weight: torch.Tensor):
    """Symmetric dynamic int8 quantization
    (``wsovod_tpu/models/layers.py::_quantize_act_weight``): per image
    activation scales ``s_x [B, 1, 1, 1]`` (``x [B, H, W, C]``; 1 where max
    |x| <= 1e-20) and per output channel weight scales ``s_k [F]`` of a torch
    conv weight ``[F, C, kh, kw]`` (1 where max |k| <= 1e-20).
    ``round(x / s_x)`` (half to even) is not clipped, the weight's is clipped
    to [-127, 127]. Returns ``(x_q int8, s_x, k_q int8 [F, C, kh, kw],
    s_k)``."""
    xf = x.float()
    s_x = xf.abs().amax(dim=(1, 2, 3), keepdim=True)
    s_x = torch.where(s_x > 1e-20, _div127(s_x), torch.ones_like(s_x))
    xq = torch.round(xf / s_x).to(torch.int8)
    kf = weight.float()
    s_k = _div127(kf.abs().amax(dim=(1, 2, 3)))
    s_k = torch.where(s_k > 1e-20, s_k, torch.ones_like(s_k))
    kq = torch.round(kf / s_k[:, None, None, None]).clamp(-127, 127).to(torch.int8)
    return xq, s_x, kq, s_k


def conv3x3_shifted_int8(x: torch.Tensor, weight: torch.Tensor,
                         bias: Optional[torch.Tensor] = None, dilation: int = 1) -> torch.Tensor:
    """3x3 SAME conv of ``x [B, H, W, C]`` (NHWC) with a torch weight ``[F,
    C, 3, 3]`` as 9 shifted int8 GEMMs ``[B*H*W, C] x [C, F]`` summed in
    int32 (``wsovod_tpu/models/layers.py::conv3x3_shifted_int8``), then one
    dequant ``(acc * s_x) * s_k`` in float32, the bias added in float32 and
    the result cast to ``x``'s dtype: ``[B, H, W, F]``. The int32 sums are
    exact, so the result matches the JAX function bit for bit."""
    b, h, w, c = x.shape
    d = dilation
    xq, s_x, kq, s_k = quantize_act_weight(x, weight)
    xp = torch.nn.functional.pad(xq, (0, 0, d, d, d, d))
    acc = None
    for dy in range(3):
        for dx in range(3):
            sl = xp[:, dy * d : dy * d + h, dx * d : dx * d + w, :].reshape(-1, c)
            t = int_mm(sl, kq[:, :, dy, dx])
            acc = t if acc is None else acc + t
    y = acc.float().reshape(b, h, w, -1) * s_x * s_k
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


class QuantizableConv3x3(Conv2d):
    """The RPN head's 3x3 conv with bias, padding 1 (the reference's
    ``QuantizableConv3x3``, the same parameters, so the weight import is
    unchanged). ``forward(x)`` runs it in floating point; with ``quant``
    ``"int8"`` (``TPU.RPN_CONV_QUANT``), ``forward_nhwc(x, int8=True)``
    runs ``conv3x3_shifted_int8`` on an NHWC input, as the JAX package does
    at inference."""

    def __init__(self, in_channels: int, features: int, quant: str = "none"):
        super().__init__(in_channels, features, 3, padding=1)
        if quant not in ("none", "int8"):
            raise ValueError(f"unknown conv quant {quant!r}")
        self.quant = quant

    def forward_nhwc(self, x: torch.Tensor, int8: bool = False) -> torch.Tensor:
        """``x [B, H, W, C]`` -> ``[B, H, W, F]``: int8 when ``int8`` and
        the conv is quantized, else the floating-point conv."""
        if int8 and self.quant == "int8":
            return conv3x3_shifted_int8(x, self.weight, self.bias)
        return self(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


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
