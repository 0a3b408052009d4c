"""Swin Transformer backbone and its FPN (counterpart of
``wsovod_tpu/models/backbones/swin.py``; reference
``wsovod/modeling/backbone/swin_transformer.py``).

* ``SwinTransformer``: a 4x4 stride-4 patch embed (flax's ``SAME`` padding:
  ``ceil(H / 4) * 4 - H`` pixels, the smaller half on top and left), a
  LayerNorm, then four stages of windowed-attention blocks, odd blocks
  shifted by ``window_size // 2`` under the -100 shift mask, each stage but
  the last followed by ``PatchMerging`` (a 2x2 space-to-depth in the order
  ``[0::2, 0::2], [1::2, 0::2], [0::2, 1::2], [1::2, 1::2]``, a LayerNorm and
  a bias-free linear); every stage named in ``out_features`` passes a
  LayerNorm of its own.
* ``SwinFPN``: d2's ``FPN`` over it with ``LastLevelMaxPool``: 1x1 lateral
  convs, a top-down path of nearest 2x upsampling (repeat, then crop to the
  lateral's size) summed in (halved with ``fuse_type`` ``avg``), a 3x3
  output conv per level, and p6 a 1x1 stride-2 max pool of p5.

It follows the JAX module's code where flax's defaults differ from torch's:
the GELU is the tanh approximation (flax's ``nn.gelu``), the LayerNorms'
epsilon is 1e-6, and the window padding is zeros after ``norm1`` that the
attention does not mask (the JAX module's docstring says it masks them; its
code does not, ROADMAP 3.12). ``MODEL.SWIN.APE`` and ``DROP_PATH_RATE``
are ignored, as there. The window attention runs in
``scaled_dot_product_attention`` with the relative position bias (and the
shift mask) as its additive mask; the JAX package computes it outside any
Pallas kernel.

The forward takes NHWC images and returns NHWC features, each a contiguous
tensor (the FPN's convs run NCHW in ``channels_last`` memory, whose NHWC
view is free). Parameters stay float32 and every layer runs in its input's
dtype. Parameter names are the reference's (``bottom_up.patch_embed.proj``,
``bottom_up.layers.0.blocks.1.attn.qkv``, ``bottom_up.layers.0.downsample.
reduction``, ``bottom_up.norm0``, ``fpn_lateral2``, ``fpn_output2``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon


class Linear(nn.Linear):
    """``nn.Linear`` run in the input's dtype (float32 parameters)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class LayerNorm(nn.LayerNorm):
    """flax's LayerNorm (epsilon 1e-6) run in the input's dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """``[B, H, W, C]`` -> ``[B * nH * nW, ws * ws, C]`` (H, W multiples of ws)."""
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(win: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = win.shape[0] // (h // ws * (w // ws))
    x = win.view(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def _relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)  # [ws*ws, ws*ws]


def _shift_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """The shifted windows' mask ``[nW, ws*ws, ws*ws]``: -100 between tokens
    of different regions of the rolled map, else 0."""
    img = np.zeros((1, hp, wp, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    mw = window_partition(torch.from_numpy(img), ws).reshape(-1, ws * ws).numpy()
    return np.where(mw[:, None, :] != mw[:, :, None], -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(_relative_position_index(window_size)).long(),
                             persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x [B * nW, n, C]``, ``mask [nW, n, n]`` or None."""
        b, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).view(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)  # [3, B*nW, h, n, d]
        q, k, v = qkv[0], qkv[1], qkv[2]
        bias = self.relative_position_bias_table[self.relative_position_index.view(-1)]
        bias = bias.view(n, n, h).permute(2, 0, 1)  # [h, n, n]
        if mask is None:
            attn_mask = bias[None]
        else:  # the shift mask per window (windows are image-major), the bias per head
            nw = mask.shape[0]
            attn_mask = (bias[None] + mask[:, None])[None].expand(b // nw, nw, h, n, n)
            attn_mask = attn_mask.reshape(b, h, n, n)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask.to(q.dtype),
                                             scale=(c // h) ** -0.5)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift: int = 0,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self._masks: Dict[Tuple, torch.Tensor] = {}

    def _mask(self, hp: int, wp: int, device) -> torch.Tensor:
        key = (hp, wp, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(
                _shift_mask(hp, wp, self.window_size, self.shift)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, l, c = x.shape
        ws, shift = self.window_size, self.shift
        shortcut = x
        x = self.norm1(x).view(b, h, w, c)
        pad_h, pad_w = (-h) % ws, (-w) % ws
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))  # zeros, not masked (as the JAX code)
        hp, wp = h + pad_h, w + pad_w
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = self._mask(hp, wp, x.device)
        x = window_reverse(self.attn(window_partition(x, ws), mask), ws, hp, wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + x[:, :h, :w].reshape(b, l, c)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, h: int, w: int) -> Tuple[torch.Tensor, int, int]:
        b, _, c = x.shape
        x = F.pad(x.view(b, h, w, c), (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        nh, nw = x.shape[1], x.shape[2]
        return self.reduction(self.norm(x.reshape(b, nh * nw, 4 * c))), nh, nw


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int, patch_norm: bool = True):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, 4, 4)
        self.norm = LayerNorm(embed_dim) if patch_norm else None

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        """NHWC images -> tokens ``[B, h * w, C]``, h, w."""
        b, h, w, _ = x.shape
        ph, pw = -(-h // 4) * 4 - h, -(-w // 4) * 4 - w  # flax SAME: low side gets the floor half
        x = F.pad(x.permute(0, 3, 1, 2), (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        x = F.conv2d(x, self.proj.weight.to(x.dtype), self.proj.bias.to(x.dtype), stride=4)
        nh, nw = x.shape[2], x.shape[3]
        x = x.flatten(2).transpose(1, 2)
        return (self.norm(x) if self.norm is not None else x), nh, nw


class SwinLayer(nn.Module):
    """One stage: its blocks, then (but for the last stage) the merge."""

    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2,
                      mlp_ratio)
            for i in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None


class _SwinParameters(nn.Module):
    """The Swin backbones' freeze stages and random initialisation."""

    def freeze(self, freeze_at: int) -> None:
        """The JAX package's stage rule (``wsovod_tpu/solver/build.py:22-31``)
        puts every Swin and FPN parameter in stage 5: all frozen at
        ``FREEZE_AT`` 5."""
        if freeze_at >= 5:
            for p in self.parameters():
                p.requires_grad_(False)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The JAX modules' initialisers (normal in place of truncated
        normal): dense and conv kernels LeCun fan-in, biases 0, LayerNorms 1
        and 0, the relative position bias tables N(0, 0.02)."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.weight.normal_(0.0, math.sqrt(1.0 / m.weight[0].numel()), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, WindowAttention):
                m.relative_position_bias_table.normal_(0.0, 0.02, generator=generator)


class SwinTransformer(_SwinParameters):
    """``forward(x [B, H, W, 3])`` -> ``{"stage{i}": [B, h, w, C]}`` for the
    stages in ``out_features`` (stage2 at stride 4, C = embed_dim, each next
    stage at twice the stride and channels)."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, patch_norm: bool = True,
                 out_features: Sequence[str] = ("stage2", "stage3", "stage4", "stage5")):
        super().__init__()
        self.embed_dim = embed_dim
        self.depths = tuple(depths)
        self.out_features = tuple(out_features)
        self.patch_embed = PatchEmbed(embed_dim, patch_norm)
        self.layers = nn.ModuleList(
            SwinLayer(embed_dim * 2 ** i, d, num_heads[i], window_size, mlp_ratio,
                      i < len(depths) - 1)
            for i, d in enumerate(depths))
        for i in range(len(depths)):
            if f"stage{i + 2}" in self.out_features:
                self.add_module(f"norm{i}", LayerNorm(embed_dim * 2 ** i))

    def output_channels(self) -> Dict[str, int]:
        return {f"stage{i + 2}": self.embed_dim * 2 ** i for i in range(len(self.depths))
                if f"stage{i + 2}" in self.out_features}

    def output_strides(self) -> Dict[str, int]:
        return {f"stage{i + 2}": 4 * 2 ** i for i in range(len(self.depths))
                if f"stage{i + 2}" in self.out_features}

    def forward(self, x: torch.Tensor, train: bool = False) -> Dict[str, torch.Tensor]:
        x, h, w = self.patch_embed(x)
        b = x.shape[0]
        outputs = {}
        for i, layer in enumerate(self.layers):
            for block in layer.blocks:
                x = block(x, h, w)
            name = f"stage{i + 2}"
            if name in self.out_features:
                outputs[name] = getattr(self, f"norm{i}")(x).view(b, h, w, -1)
            if layer.downsample is not None:
                x, h, w = layer.downsample(x, h, w)
        return outputs


class SwinFPN(_SwinParameters):
    """``forward(x [B, H, W, 3])`` -> ``{"p{k}": [B, h, w, out_channels]}``,
    p2..p5 from stage2..stage5 and p6 (``LastLevelMaxPool``)."""

    def __init__(self, bottom_up: SwinTransformer,
                 in_features: Sequence[str] = ("stage2", "stage3", "stage4", "stage5"),
                 out_channels: int = 256, fuse_type: str = "sum"):
        super().__init__()
        self.bottom_up = bottom_up
        self.in_features = tuple(in_features)
        self.out_channels = out_channels
        self.fuse_type = fuse_type
        bu_ch = bottom_up.output_channels()
        for f in self.in_features:
            k = self._level(f)
            self.add_module(f"fpn_lateral{k}", nn.Conv2d(bu_ch[f], out_channels, 1))
            self.add_module(f"fpn_output{k}", nn.Conv2d(out_channels, out_channels, 3, padding=1))

    def _level(self, feature: str) -> int:
        return int(np.log2(self.bottom_up.output_strides()[feature]))

    def output_strides(self) -> Dict[str, int]:
        strides = {f"p{self._level(f)}": 2 ** self._level(f) for f in self.in_features}
        top = max(strides.values()) * 2
        strides[f"p{int(np.log2(top))}"] = top
        return strides

    def output_channels(self) -> Dict[str, int]:
        return {k: self.out_channels for k in self.output_strides()}

    @staticmethod
    def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return conv._conv_forward(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> Dict[str, torch.Tensor]:
        feats = self.bottom_up(x, train=train)
        prev = None
        outputs = {}
        # top-down: coarsest first
        for f in sorted(self.in_features, key=self._level, reverse=True):
            k = self._level(f)
            t = feats[f].permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            lateral = self._conv(getattr(self, f"fpn_lateral{k}"), t)
            if prev is not None:
                up = prev.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
                lateral = lateral + up[:, :, :lateral.shape[2], :lateral.shape[3]]
                if self.fuse_type == "avg":
                    lateral = lateral / 2.0
            prev = lateral
            out = self._conv(getattr(self, f"fpn_output{k}"), lateral)
            outputs[f"p{k}"] = out.permute(0, 2, 3, 1).contiguous()
        top = max(self._level(f) for f in self.in_features)
        outputs[f"p{top + 1}"] = outputs[f"p{top}"][:, ::2, ::2].contiguous()
        return {k: outputs[k] for k in self.output_strides()}


def build_swin_backbone(cfg) -> SwinTransformer:
    s = cfg.MODEL.SWIN
    return SwinTransformer(embed_dim=s.EMBED_DIM, depths=tuple(s.DEPTHS),
                           num_heads=tuple(s.NUM_HEADS), window_size=s.WINDOW_SIZE,
                           mlp_ratio=float(s.MLP_RATIO), patch_norm=s.PATH_NORM,
                           out_features=tuple(s.OUT_FEATURES))


def build_swin_fpn_backbone(cfg) -> SwinFPN:
    return SwinFPN(build_swin_backbone(cfg), in_features=tuple(cfg.MODEL.FPN.IN_FEATURES),
                   out_channels=cfg.MODEL.FPN.OUT_CHANNELS, fuse_type=cfg.MODEL.FPN.FUSE_TYPE)
