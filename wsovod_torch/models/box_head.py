"""DiscriminativeAdaptationNeck (DAN) box head (counterpart of
``wsovod_tpu/models/box_head.py``; reference ``roi_heads/box_head.py``).

fc1 (``[P*P*C] -> 4096``) is applied one pooled channel chunk at a time, as
the JAX package's ``ChunkedDenseGeneral``: each chunk ``[B, N, P, P, c]``
contributes a partial product, the partials are summed in float32, and the
full ``[B, N, P, P, C]`` tensor (about 1 GB per image at the COCO proposal
budget) never exists. fc2 is a plain ``Linear``. Dropout is a training
matter and is not here.

fc1 is stored chunk-major inside (``[F, C/c, P, P, c]`` flattened), so each
chunk's weight is a strided ``[F, P*P*c]`` view in the pooled chunk's
``(h, w, c)`` order (float32 reads it in place; bf16 casts it, one plain
copy per chunk). Its ``state_dict`` keeps the reference torch layout
``[F, C*P*P]`` in ``(c, h, w)`` order; the re-layout happens once, at load.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear

_MM_OUT_DTYPE = "dtype" in torch.ops.aten.mm.overloads()


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (both in one dtype) accumulated and returned in float32.
    bfloat16 operands on CUDA use ``torch.mm(..., out_dtype=float32)`` where
    this PyTorch has it; otherwise each bf16 product is rounded to bf16 and
    widened (adds at most one bf16 rounding per partial, about 2**-8
    relative). On the CPU, bf16 operands are widened first: exact products,
    float32 sums."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.device.type == "cuda":
        if _MM_OUT_DTYPE:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.mm(a, b).float()
    return torch.mm(a.float(), b.float())


class ChunkedLinear(nn.Module):
    """fc1 over pooled ``(h, w, c)``, fed one channel chunk per call."""

    def __init__(self, in_channels: int, pooled: int, out_features: int, c_take: int):
        super().__init__()
        assert in_channels % c_take == 0, (in_channels, c_take)
        self.c, self.p, self.f, self.c_take = in_channels, pooled, out_features, c_take
        self.n_chunks = in_channels // c_take
        self.weight = nn.Parameter(torch.empty(out_features, in_channels * pooled * pooled))
        self.bias = nn.Parameter(torch.empty(out_features))

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

    def forward(self, chunk: torch.Tensor, k: int) -> torch.Tensor:
        """Partial product of chunk ``k`` (``[..., P, P, c_take]``), float32
        ``[..., F]``, without the bias."""
        lead = chunk.shape[:-3]
        a = chunk.reshape(-1, self.p * self.p * self.c_take)
        w = self.chunk_weight(k).to(chunk.dtype)  # cast before the transpose view
        return matmul_f32(a, w.t()).reshape(lead + (self.f,))


class DiscriminativeAdaptationNeck(nn.Module):
    def __init__(self, in_channels: int, pooled: int, fc_dims=(4096, 4096), c_take: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if len(fc_dims) != 2:
            raise ValueError(f"the port's DAN has fc1 and fc2; got DAN_DIM {list(fc_dims)}")
        self.dtype = dtype
        self.fc1 = ChunkedLinear(in_channels, pooled, fc_dims[0], c_take)
        self.fc2 = Linear(fc_dims[0], fc_dims[1])

    @property
    def output_dim(self) -> int:
        return self.fc2.out_features

    def forward(self, chunks: Iterable[torch.Tensor]) -> torch.Tensor:
        """``chunks``: the pooled channel chunks in channel order (consumed
        lazily, one alive at a time) -> ``[B, N, fc_dims[-1]]`` in the compute
        dtype."""
        acc = None
        n = 0
        for k, chunk in enumerate(chunks):
            y = self.fc1(chunk, k)
            acc = y if acc is None else acc + y
            n += 1
        if n != self.fc1.n_chunks:
            raise ValueError(f"DAN got {n} pooled chunks, fc1 expects {self.fc1.n_chunks}")
        x = F.relu((acc + self.fc1.bias.float()).to(self.dtype))
        return F.relu(self.fc2(x))
