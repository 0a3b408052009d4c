"""DiscriminativeAdaptationNeck (DAN) box head (counterpart of
``wsovod_tpu/models/box_head.py``; reference ``roi_heads/box_head.py``).

fc1 (``[P*P*C] -> 4096``) is applied one pooled channel chunk at a time, as
the JAX package's ``ChunkedDenseGeneral``: each chunk ``[B, N, P, P, c]``
contributes a partial product, the partials are summed in float32, and the
full ``[B, N, P, P, C]`` tensor (about 1 GB per image at the COCO proposal
budget) never exists. fc2 is a plain ``Linear``. In training each FC's
ReLU output goes through Dropout(0.5), and the pooler's objectness gate
arrives as a row gate on fc1's accumulated output, before the bias (fc1 is
linear and the gate nonnegative, so this equals gating the pooled input;
``wsovod_tpu/models/box_head.py:57-64``): the gate's gradient then never
needs the pooled chunks.

fc1 is stored chunk-major inside (``[F, C/c, P, P, c]`` flattened), so each
chunk's weight is a strided ``[F, P*P*c]`` view in the pooled chunk's
``(h, w, c)`` order (float32 reads it in place; bf16 casts it, one plain
copy per chunk). Its ``state_dict`` keeps the reference torch layout
``[F, C*P*P]`` in ``(c, h, w)`` order; the re-layout happens once, at load.

With ``TPU.DAN_FC1_QUANT`` ``"int8"`` fc1 is int8 at inference, as
``ChunkedDenseGeneral(quant="int8")`` (``wsovod_tpu/models/box_head.py:
127-177``): per chunk, the activation scale per (ROI, chunk) ``s_a =
max(maxabs, 1e-8) / 127`` and ``x_q = clip(round(x / s_a), -127, 127)``;
the chunk's weight quantized per output column, ``s_w = max(max |w|,
1e-8) / 127`` over its ``(h, w, c)``; the int8 product summed in int32
(``layers.int_mm``), scaled by ``s_a`` then ``s_w`` in float32, the chunks'
partials summed in float32, then the bias. A chunk may also arrive as a
``(payload, maxabs)`` pair (the pool kernels' maxabs emission: the maxabs
is not recomputed) or an ``(int8 payload, scale)`` pair (the product is
scaled by ``scale`` directly). The quantized weight is cached per chunk
until the parameter changes. Training is floating point whatever the key.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear, _div127, int_mm

_MM_OUT_DTYPE = "dtype" in torch.ops.aten.mm.overloads()


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two bf16 CUDA matrices accumulated in float32:
    ``torch.mm(..., out_dtype=float32)`` where this PyTorch has it, else the
    bf16 product widened (one more bf16 rounding, about 2**-8 relative)."""
    if _MM_OUT_DTYPE:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a, b).float()


class _LinearF32Out(torch.autograd.Function):
    """``a [M, K] @ w [F, K].T`` with bf16 operands on the card, summed and
    returned in float32 (``w`` is a float32 parameter view, cast inside, so
    no bf16 copy of it outlives the call). Backward: ``dA = dY @ W`` in
    bf16, ``dW = dY.T @ A`` accumulated in float32; it keeps ``a`` only if
    ``w`` needs a gradient and ``w`` only if ``a`` does."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a if ctx.needs_input_grad[1] else None,
                              w if ctx.needs_input_grad[0] else None)
        return _mm_f32(a, w.to(a.dtype).t())

    @staticmethod
    def backward(ctx, gy):
        a, w = ctx.saved_tensors
        da = dw = None
        if ctx.needs_input_grad[0]:
            da = torch.mm(gy.to(torch.bfloat16), w.to(torch.bfloat16))
        if ctx.needs_input_grad[1]:
            dw = _mm_f32(gy.to(a.dtype).t(), a)
        return da, dw


def matmul_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w.T`` for ``a [M, K]`` in the compute dtype and a float32
    weight ``w [F, K]``, accumulated and returned in float32. bf16 on CUDA:
    ``_LinearF32Out``. On the CPU, bf16 operands are widened first: exact
    products, float32 sums."""
    if a.dtype == torch.float32:
        return torch.mm(a, w.t())
    if a.device.type == "cuda":
        return _LinearF32Out.apply(a, w)
    return torch.mm(a.float(), w.to(a.dtype).float().t())


class ChunkedLinear(nn.Module):
    """fc1 over pooled ``(h, w, c)``, fed one channel chunk per call; with
    ``quant`` ``"int8"`` int8 at inference (see the module docstring)."""

    def __init__(self, in_channels: int, pooled: int, out_features: int, c_take: int,
                 quant: str = "none"):
        super().__init__()
        assert in_channels % c_take == 0, (in_channels, c_take)
        if quant not in ("none", "int8"):
            raise ValueError(f"unknown fc1 quant {quant!r}")
        self.c, self.p, self.f, self.c_take = in_channels, pooled, out_features, c_take
        self.quant = quant
        self.n_chunks = in_channels // c_take
        self.weight = nn.Parameter(torch.empty(out_features, in_channels * pooled * pooled))
        self.bias = nn.Parameter(torch.empty(out_features))
        self._qcache = {}  # chunk -> (weight version and storage, w_q, s_w)

    # reference layout [F, (c, h, w)] <-> chunk-major [F, (k, h, w, c_in)]
    def from_reference(self, w: torch.Tensor) -> torch.Tensor:
        f, k, ct, p = self.f, self.n_chunks, self.c_take, self.p
        return w.reshape(f, k, ct, p, p).permute(0, 1, 3, 4, 2).reshape(f, -1)

    def to_reference(self, w: torch.Tensor) -> torch.Tensor:
        f, k, ct, p = self.f, self.n_chunks, self.c_take, self.p
        return w.reshape(f, k, p, p, ct).permute(0, 1, 4, 2, 3).reshape(f, -1)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        key = prefix + "weight"
        if key in state_dict:
            state_dict[key] = self.from_reference(state_dict[key])
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        w = destination[prefix + "weight"]
        destination[prefix + "weight"] = self.to_reference(w if keep_vars else w.detach())

    def chunk_weight(self, k: int) -> torch.Tensor:
        """Chunk ``k``'s weight, a strided ``[F, P*P*c_take]`` view."""
        return self.weight.view(self.f, self.n_chunks, -1)[:, k]

    def quantized_weight(self, k: int):
        """Chunk ``k``'s weight quantized per output column: ``(w_q int8 [F,
        P*P*c_take], s_w [F] float32)``, cached until the parameter changes."""
        w = self.weight
        key = (w._version, w.data_ptr(), w.device)
        hit = self._qcache.get(k)
        if hit is None or hit[0] != key:
            wk = self.chunk_weight(k).detach().float()
            s_w = _div127(wk.abs().amax(dim=1).clamp(min=1e-8))
            w_q = torch.round(wk / s_w[:, None]).clamp(-127, 127).to(torch.int8)
            hit = self._qcache[k] = (key, w_q, s_w)
        return hit[1], hit[2]

    def forward(self, chunk, k: int, int8: bool = False) -> torch.Tensor:
        """Partial product of chunk ``k`` (``[..., P, P, c_take]``), float32
        ``[..., F]``, without the bias. ``int8`` (with ``quant`` ``"int8"``)
        or a ``(payload, maxabs)`` or ``(int8 payload, scale)`` pair takes
        the int8 product."""
        if isinstance(chunk, tuple) or (int8 and self.quant == "int8"):
            return self._forward_int8(chunk, k)
        lead = chunk.shape[:-3]
        a = chunk.reshape(-1, self.p * self.p * self.c_take)
        return matmul_f32(a, self.chunk_weight(k)).reshape(lead + (self.f,))

    def _forward_int8(self, chunk, k: int) -> torch.Tensor:
        x = chunk[0] if isinstance(chunk, tuple) else chunk
        lead = x.shape[:-3]
        a = x.reshape(-1, self.p * self.p * self.c_take)
        w_q, s_w = self.quantized_weight(k)
        if x.dtype == torch.int8:  # (int8 payload, scale): the scale is the activation's
            y = int_mm(a, w_q).float() * chunk[1].reshape(-1, 1).float() * s_w
        else:
            # max |x| and x / s_a in float32 without a float32 copy of the chunk
            ax = (chunk[1].reshape(-1, 1).float() if isinstance(chunk, tuple)
                  else a.abs().amax(dim=1, keepdim=True).float())
            s_a = _div127(ax.clamp(min=1e-8))
            x_q = torch.div(a, s_a).round_().clamp_(-127, 127).to(torch.int8)
            y = int_mm(x_q, w_q).float() * s_a * s_w
        return y.reshape(lead + (self.f,))


class DiscriminativeAdaptationNeck(nn.Module):
    def __init__(self, in_channels: int, pooled: int, fc_dims=(4096, 4096), c_take: int = 512,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.5,
                 fc1_quant: str = "none"):
        super().__init__()
        if len(fc_dims) != 2:
            raise ValueError(f"the port's DAN has fc1 and fc2; got DAN_DIM {list(fc_dims)}")
        self.dtype = dtype
        self.dropout = dropout
        self.fc1 = ChunkedLinear(in_channels, pooled, fc_dims[0], c_take, fc1_quant)
        self.fc2 = Linear(fc_dims[0], fc_dims[1])

    @property
    def output_dim(self) -> int:
        return self.fc2.out_features

    def _drop(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """Dropout in training (flax ``Dropout``: kept entries divided by the
        keep probability), its mask drawn from ``generator``."""
        if not self.training or self.dropout == 0.0:
            return x
        keep = 1.0 - self.dropout
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))

    def forward(self, chunks: Iterable, row_gate: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, int8: bool = False) -> torch.Tensor:
        """``chunks``: the pooled channel chunks in channel order (consumed
        lazily, one alive at a time; tensors or the pairs of the module
        docstring) -> ``[B, N, fc_dims[-1]]`` in the compute dtype.
        ``row_gate [B, N]`` scales fc1's accumulated output before the bias;
        ``generator`` draws the training dropout masks; ``int8`` asks for
        the int8 fc1 where ``DAN_FC1_QUANT`` is ``"int8"`` (inference)."""
        acc = None
        n = 0
        for k, chunk in enumerate(chunks):
            y = self.fc1(chunk, k, int8)
            acc = y if acc is None else acc + y
            n += 1
        if n != self.fc1.n_chunks:
            raise ValueError(f"DAN got {n} pooled chunks, fc1 expects {self.fc1.n_chunks}")
        if row_gate is not None:
            acc = acc * row_gate[..., None].float()
        x = self._drop(F.relu((acc + self.fc1.bias.float()).to(self.dtype)), generator)
        return self._drop(F.relu(self.fc2(x)), generator)
